"""Port's sampling vs the JAX package's: filters give equal logits, greedy
generation gives identical tokens; sampled tokens are checked by support
membership only, since torch and JAX random streams differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.models import gptj as jgptj
from magma_tpu.ops import sampling as jsampling
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.ops import sampling as tsampling

V = 300


def _logits(seed=0, b=3):
    x = np.random.default_rng(seed).standard_normal((b, V)).astype(np.float32) * 3
    x[0, 10:14] = x[0].max() + 1.0  # ties at the top
    return x


@pytest.mark.parametrize("k", [1, 5, 40])
def test_top_k_filter_matches_jax(k):
    x = _logits()
    ref = np.asarray(jsampling.top_k_filter(jnp.asarray(x), k))
    out = tsampling.top_k_filter(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", ["reference", "standard"])
@pytest.mark.parametrize("p", [0.5, 0.9])
def test_top_p_filter_matches_jax(mode, p):
    x = _logits(seed=1)
    ref = np.asarray(jsampling.top_p_filter(jnp.asarray(x), p, mode=mode))
    out = tsampling.top_p_filter(torch.from_numpy(x), p, mode=mode).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    np.testing.assert_array_equal(out[np.isfinite(out)], ref[np.isfinite(ref)])


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.9), (8, 0.5)])
def test_sampled_tokens_stay_in_jax_support(top_k, top_p):
    """Every draw lies where the JAX filters leave finite logits, and
    vocab-padding columns are never drawn."""
    x = _logits(seed=2)
    x = np.concatenate([x, np.full((x.shape[0], 20), 50.0, np.float32)], -1)  # padding
    j = jnp.asarray(x)[:, :V]
    if top_k:
        j = jsampling.top_k_filter(j, top_k)
    if top_p:
        j = jsampling.top_p_filter(j, top_p)
    support = np.isfinite(np.asarray(j))
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = tsampling.sample_token(g, torch.from_numpy(x), temperature=0.7,
                                     top_k=top_k, top_p=top_p, vocab_size=V).numpy()
        assert all(support[r, t] for r, t in enumerate(tok))


def _tiny():
    jcfg = jgptj.GPTJConfig.tiny(compute_dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = tgptj.GPTJConfig.tiny(compute_dtype=torch.float32, param_dtype=torch.float32)
    jp = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(0), jcfg))
    tp, _ = from_jax_params({"lm": jp, "image_prefix": {}}, None, tcfg, None)
    return jcfg, tcfg, jp, tp["lm"]


@pytest.mark.parametrize("prompt_len", [None, [9, 5]])
def test_greedy_generate_token_identical(prompt_len):
    jcfg, tcfg, jp, tp = _tiny()
    emb = np.random.default_rng(4).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    pl = None if prompt_len is None else np.asarray(prompt_len, np.int32)
    ref, ref_steps = jsampling.generate_tokens(
        jcfg, jp, jnp.asarray(emb), jax.random.PRNGKey(0), max_steps=10,
        temperature=0.0, prompt_len=None if pl is None else jnp.asarray(pl))
    out, steps = tsampling.generate_tokens(
        tcfg, tp, torch.from_numpy(emb), None, max_steps=10, temperature=0.0,
        prompt_len=None if pl is None else torch.from_numpy(pl))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert steps == int(ref_steps)


def test_generate_stops_when_every_row_hit_eos():
    """With EOS forced to be the argmax, one step runs and the rest is EOS."""
    _, tcfg, _, tp = _tiny()
    eos = tcfg.vocab_size - 2
    tp["wte"][eos] *= 10
    # ln_f outputs wte[eos] whatever the input: its logit dominates
    tp["ln_f"] = {"scale": torch.zeros(tcfg.d_model), "bias": tp["wte"][eos].clone()}
    emb = torch.ones((2, 4, tcfg.d_model))
    out, steps = tsampling.generate_tokens(tcfg, tp, emb, None, max_steps=6,
                                           temperature=0.0, eos_token=eos)
    assert steps == 1
    assert torch.all(out == eos)


def test_sampled_generate_is_well_formed():
    _, tcfg, _, tp = _tiny()
    emb = torch.from_numpy(
        np.random.default_rng(5).standard_normal((2, 6, tcfg.d_model)).astype(np.float32))
    out, steps = tsampling.generate_tokens(tcfg, tp, emb, torch.Generator().manual_seed(1),
                                           max_steps=8, temperature=0.7, top_k=5)
    assert out.shape == (2, 8) and 1 <= steps <= 8
    assert torch.all((out >= 0) & (out < tcfg.vocab_size))


def test_strip_after_eos():
    assert tsampling.strip_after_eos([5, 50257, 6, 50256, 7], 50256, 50257) == [5, 6]
    assert tsampling.strip_after_eos([1, 2], 50256, 50257) == [1, 2]
