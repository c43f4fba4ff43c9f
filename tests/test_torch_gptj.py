"""Port's GPT-J vs the JAX package's, same weights, fp32 compute.

Weights come from the JAX ``init_params`` (adapters perturbed so they
matter) and reach the port through ``convert.from_jax_params``; inputs are
numpy-seeded.  Tolerance 1e-4 on logits: fp32 math in both, summed in
another order.  The KV cache is bf16 in both packages, so the cached
decode steps round K/V and the attention weights the same way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.models import gptj as jgptj
from magma_tpu.models.adapters import AdapterSpec as JAdapterSpec
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models.adapters import AdapterSpec as TAdapterSpec

ATOL = 1e-4
# decode steps read the bf16 cache and round attention weights and output
# to bf16 in both packages; a value on a rounding boundary can land one bf16
# ulp apart (~0.4%) and carry into the logits at ~1e-4
DECODE_ATOL = 3e-4
ADAPTERS = {
    "none": (None, None),
    "normal_mlp_scaled_attn": (dict(adapter_type="normal", downsample_factor=4),
                               dict(adapter_type="scaled_parallel", downsample_factor=8)),
    "parallel_ln_mlp_normal_ln_attn": (
        dict(adapter_type="parallel", downsample_factor=4, add_layernorm=True),
        dict(adapter_type="normal", downsample_factor=2, add_layernorm=True)),
}


def _configs(adapters, **overrides):
    mlp, attn = ADAPTERS[adapters]
    kw = dict(compute_dtype=jnp.float32, param_dtype=jnp.float32, **overrides)
    jcfg = jgptj.GPTJConfig.tiny(
        mlp_adapter=JAdapterSpec(**mlp) if mlp else None,
        attn_adapter=JAdapterSpec(**attn) if attn else None, **kw)
    kw.update(compute_dtype=torch.float32, param_dtype=torch.float32)
    tcfg = tgptj.GPTJConfig.tiny(
        mlp_adapter=TAdapterSpec(**mlp) if mlp else None,
        attn_adapter=TAdapterSpec(**attn) if attn else None, **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    p = jgptj.init_params(jax.random.PRNGKey(seed), jcfg)
    p = jax.tree_util.tree_map(np.asarray, p)
    r = np.random.default_rng(seed)
    for key in ("adapter_mlp", "adapter_attn"):  # near-zero init hides bugs
        if key in p["blocks"]:
            p["blocks"][key] = jax.tree_util.tree_map(
                lambda a: (a + r.standard_normal(a.shape) * 0.05).astype(np.float32),
                p["blocks"][key])
    tp, _ = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)
    return p, tp["lm"]


def _embeds(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("adapters", sorted(ADAPTERS))
def test_forward_logits_match(adapters):
    jcfg, tcfg = _configs(adapters)
    jp, tp = _params(jcfg, tcfg)
    x = _embeds(2, 12, jcfg.d_model)
    kv_len = np.array([12, 7], np.int32)
    ref, _ = jgptj.forward(jcfg, jp, jnp.asarray(x), kv_len=jnp.asarray(kv_len))
    out, _ = tgptj.forward(tcfg, tp, torch.from_numpy(x), kv_len=torch.from_numpy(kv_len))
    assert out.shape == (2, 12, tcfg.padded_vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("adapters", sorted(ADAPTERS))
def test_prefill_then_cached_decode_match(adapters, impl):
    """Prefill over a right-padded prompt, then 5 cached decode steps;
    logits compared at every step.  head_dim 128 so the flash entry takes
    the heads (the JAX reference runs its XLA path)."""
    jcfg, tcfg = _configs(adapters, n_heads=1)
    tcfg = dataclasses.replace(tcfg, attention_impl=impl)
    jp, tp = _params(jcfg, tcfg)
    b, s, steps, true_len = 2, 16, 5, 13
    x = _embeds(b, s, jcfg.d_model)
    ids = np.random.default_rng(2).integers(0, 1000, (steps, b)).astype(np.int32)
    max_len = 64

    jcache = jgptj.init_kv_cache(jcfg, b, max_len)
    tcache = tgptj.init_kv_cache(tcfg, b, max_len)
    kvl = np.full((b,), true_len, np.int32)
    jl, jcache = jgptj.forward(jcfg, jp, jnp.asarray(x), cache=jcache,
                               cache_index=jnp.int32(0), kv_len=jnp.asarray(kvl))
    tl, tcache = tgptj.forward(tcfg, tp, torch.from_numpy(x), cache=tcache,
                               cache_index=0, kv_len=torch.from_numpy(kvl))
    np.testing.assert_allclose(tl[:, :true_len].numpy(),
                               np.asarray(jl)[:, :true_len], atol=ATOL)
    for t in range(steps):
        cur = true_len + t
        jemb = jgptj.embed_tokens(jcfg, jp, jnp.asarray(ids[t][:, None]))
        temb = tgptj.embed_tokens(tcfg, tp, torch.from_numpy(ids[t][:, None]).long())
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=0)
        jl, jcache = jgptj.forward(jcfg, jp, jemb, cache=jcache,
                                   cache_index=jnp.full((b,), cur, jnp.int32))
        tl, tcache = tgptj.forward(tcfg, tp, temb, cache=tcache,
                                   cache_index=torch.full((b,), cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=DECODE_ATOL,
                                   err_msg=f"decode step {t}")
    # the caches hold bf16 roundings of fp32 K that agree to ~1e-7: equal
    # but for an odd value on a rounding boundary, one bf16 ulp apart
    np.testing.assert_allclose(tcache["k"].float().numpy(),
                               np.asarray(jcache["k"].astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-6)


def test_init_shapes_and_padding_rows():
    cfg = tgptj.GPTJConfig.tiny(mlp_adapter=TAdapterSpec("scaled_parallel", 4))
    g = torch.Generator().manual_seed(0)
    p = tgptj.init_params(g, cfg)
    assert p["wte"].shape == (cfg.padded_vocab_size, cfg.d_model)
    assert torch.all(p["wte"][cfg.vocab_size:] == 0)
    assert p["blocks"]["attn"]["q"].shape == (cfg.n_layers, cfg.d_model, cfg.d_model)
    assert p["blocks"]["mlp"]["fc_in"]["kernel"].shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    ad = p["blocks"]["adapter_mlp"]
    assert ad["scale"].shape == (cfg.n_layers,)
    assert float(ad["down"]["kernel"].abs().max()) <= 2e-3 * (1 + 1e-6)  # clamped to 2 std
    assert tgptj.logits_mask(cfg).sum() == cfg.vocab_size
    cache = tgptj.init_kv_cache(cfg, 3, 64)
    assert cache["k"].shape == (cfg.n_layers, 3, 64, cfg.n_heads, cfg.head_dim)
    assert cache["k"].dtype == torch.bfloat16
