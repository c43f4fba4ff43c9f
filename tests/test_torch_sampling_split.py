"""The port's split generate, batched sampler, history attention and cache
write against the JAX package's, on the CPU.

Inputs are numpy-seeded; weights come from the JAX ``init_params`` and
reach the port through ``convert.from_jax_params``; fp32 compute in both.

* ``_write_cache`` clamps each row's start into ``[0, max_len - s]`` as
  JAX's ``dynamic_update_slice`` does: bytes equal to JAX's jitted
  function for a write at ``max_len``, a per-row index with one row at
  ``max_len`` and an s > 1 chunk whose end passes ``max_len``.
* ``history_attention``: fp32 queries over a bf16 cache round the softmax
  weights and both products to bf16 in both packages (``wdt`` is the
  cache's dtype); the fp32 scores sum in XLA's order and PyTorch's, so a
  weight or an output on a bf16 rounding boundary may land one bf16 ulp
  apart: within 2^-7 of the largest output (one ulp).  Over an int8
  cache the weights stay fp32 (q's dtype) and only the summation order
  differs: within 1e-5 of the largest output (fp32 sums of a few hundred
  terms of magnitude <= 1 differ by a few 2^-24 ulps each).
* ``sample_token_batched``: greedy and top_k = 1 rows equal JAX's; a row
  with top_k or top_p set can draw exactly the tokens JAX's filter keeps
  (no row sets both: the JAX batched sampler takes top-p over the
  unfiltered logits and cuts ties, which the port does not copy); rows
  with both set are held to the port's own ``sample_token``: the same
  draws from the same generator.
* ``generate_tokens_split`` gives JAX's greedy tokens (ragged, early EOS,
  chunked with a padded last chunk), and the port's own
  ``generate_tokens``'s tokens when sampling from one seed.
* ``Magma.generate`` takes the split path above 8192 padded positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.models import gptj as jgptj
from magma_tpu.ops import attention as jattn
from magma_tpu.ops import sampling as jsampling
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.ops import attention as tattn
from magma_tpu_torch.ops import sampling as tsampling

BF16 = jnp.bfloat16
TINY = dict(n_layers=2, n_heads=4, d_model=128, d_ff=256, rotary_dim=16)


def _normal(shape, seed, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _j(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(BF16)
    return jnp.asarray(t.numpy())


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# the cache write's clamp
# ---------------------------------------------------------------------------

CLAMP_CASES = {
    # (s, index): the start clamps to max_len - s
    "at_max_len": (1, 64),
    "per_row_one_at_max_len": (1, [3, 64]),
    "chunk_past_end": (8, 60),
    "per_row_chunk_past_end": (8, [10, 61]),
}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CLAMP_CASES))
def test_write_cache_clamps_as_jax(case, kv):
    s, index = CLAMP_CASES[case]
    cfg = tgptj.GPTJConfig.tiny(**TINY, kv_cache_dtype=kv)
    b, max_len = 2, 64
    cache = tgptj.init_kv_cache(cfg, b, max_len)
    first = {k: torch.from_numpy(_normal((2, b, max_len, 4, 32), i)).to(torch.bfloat16)
             for i, k in enumerate("kv")}
    tgptj._write_cache(cache, first["k"], first["v"], 0)  # a full history to write over
    jcache = {k: _j(v) for k, v in cache.items()}
    new = {k: torch.from_numpy(_normal((2, b, s, 4, 32), 10 + i)).to(torch.bfloat16)
           for i, k in enumerate("kv")}
    per_row = isinstance(index, list)
    t_idx = torch.tensor(index) if per_row else index
    j_idx = jnp.asarray(index, jnp.int32)
    want = jax.jit(jgptj._write_cache)(jcache, _j(new["k"]), _j(new["v"]), j_idx)
    got = tgptj._write_cache(cache, new["k"], new["v"], t_idx)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k].astype(jnp.float32)),
                                      err_msg=k)
    if not per_row:  # a 0-d tensor index clamps as the int does
        again = tgptj.init_kv_cache(cfg, b, max_len)
        tgptj._write_cache(again, first["k"], first["v"], 0)
        tgptj._write_cache(again, new["k"], new["v"], torch.tensor(index))
        for k in got:
            assert torch.equal(again[k], got[k]), k


# ---------------------------------------------------------------------------
# history attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("hist", ["scalar", "per_row"])
@pytest.mark.parametrize("padded", [False, True], ids=["full", "kv_len"])
def test_history_attention_matches_jax(kv, hist, padded):
    b, s, h, hd, max_len = 2, 8, 4, 32, 64
    q, k_self, v_self = (torch.from_numpy(_normal((b, s, h, hd), i)) for i in range(3))
    kc, vc = (torch.from_numpy(_normal((b, max_len, h, hd), i)) for i in (3, 4))
    if kv == "int8":
        kq, ks = tgptj._quantize_kv(kc[None])
        vq, vs = tgptj._quantize_kv(vc[None])
        kc, vc, scales = kq[0], vq[0], (ks[0], vs[0])
        jscales = (_j(ks[0]), _j(vs[0]))
        tol = 1e-5
    else:
        kc, vc, scales, jscales = kc.to(torch.bfloat16), vc.to(torch.bfloat16), None, None
        tol = 2.0 ** -7
    hist_len = torch.tensor([37, 5]) if hist == "per_row" else 20
    kv_len = torch.tensor([8, 3]) if padded else None
    kw = dict(scale=hd ** -0.5)
    got = tattn.history_attention(q, kc, vc, hist_len, k_self, v_self, kv_len=kv_len,
                                  kv_scales=scales, **kw)
    want = jattn.history_attention(
        _j(q), _j(kc), _j(vc), jnp.asarray(np.asarray(hist_len), jnp.int32), _j(k_self),
        _j(v_self), kv_len=None if kv_len is None else _j(kv_len), kv_scales=jscales, **kw)
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# the batched sampler
# ---------------------------------------------------------------------------

V = 300


def _logits(seed, b):
    return _normal((b, V), seed, 3.0)


def test_batched_sampler_greedy_and_top_k_1_rows_equal_jax():
    x = _logits(0, 6)
    x = np.concatenate([x, np.full((6, 20), 50.0, np.float32)], -1)  # vocab padding
    temps = np.array([0.0, 0.8, 0.0, 1.5, 0.0, 0.3], np.float32)
    top_ks = np.array([0, 1, 5, 1, 0, 1], np.int32)
    top_ps = np.array([0.0, 0.0, 0.9, 0.0, 0.5, 0.0], np.float32)
    want = jsampling.sample_token_batched(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps), vocab_size=V)
    for seed in range(3):
        got = tsampling.sample_token_batched(
            torch.Generator().manual_seed(seed), torch.from_numpy(x), torch.from_numpy(temps),
            torch.from_numpy(top_ks), torch.from_numpy(top_ps), vocab_size=V)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["reference", "standard"])
def test_batched_sampler_draws_where_jax_filters_keep(mode):
    """One filter a row: the finite set the port keeps is the set JAX's
    filter keeps, and every draw of either package lies in it."""
    rows = [(5, 0.0), (40, 0.0), (0, 0.5), (0, 0.9), (1, 0.0)]
    x = _logits(1, len(rows))
    top_ks = np.array([k for k, _ in rows], np.int32)
    top_ps = np.array([p for _, p in rows], np.float32)
    temps = np.full(len(rows), 0.7, np.float32)
    support = []
    for r, (k, p) in enumerate(rows):
        row = jnp.asarray(x[r:r + 1])
        if k:
            row = jsampling.top_k_filter(row, k)
        if p:
            row = jsampling.top_p_filter(row, p, mode=mode)
        support.append(np.isfinite(np.asarray(row))[0])
    support = np.stack(support)
    kept = tsampling._batched_filter(torch.from_numpy(x), torch.from_numpy(top_ks),
                                     torch.from_numpy(top_ps), mode)
    np.testing.assert_array_equal(np.isfinite(kept.numpy()), support)
    g = torch.Generator().manual_seed(0)
    for i in range(40):
        tok = tsampling.sample_token_batched(
            g, torch.from_numpy(x), torch.from_numpy(temps), torch.from_numpy(top_ks),
            torch.from_numpy(top_ps), vocab_size=V, top_p_mode=mode).numpy()
        jtok = np.asarray(jsampling.sample_token_batched(
            jax.random.PRNGKey(i), jnp.asarray(x), jnp.asarray(temps), jnp.asarray(top_ks),
            jnp.asarray(top_ps), vocab_size=V, top_p_mode=mode))
        assert all(support[r, t] for r, t in enumerate(tok))
        assert all(support[r, t] for r, t in enumerate(jtok))


@pytest.mark.parametrize("mode", ["reference", "standard"])
@pytest.mark.parametrize("top_k,top_p", [(4, 0.5), (12, 0.9), (3, 0.2)])
def test_batched_sampler_rows_with_both_filters_are_sample_token(top_k, top_p, mode):
    """top-k (ties at the k-th value kept) then top-p over the filtered
    logits, as ``sample_token``: the same support, and the same draws from
    one generator state."""
    x = _logits(2, 4)
    x[1, :4] = [3.0, 2.0, 1.9, 1.8]  # ROADMAP 3b's example row
    x[1, 4:] = 1.0
    x[2, 10:16] = x[2].max() + 1.0   # ties at the top
    b = x.shape[0]
    kw = dict(vocab_size=V, top_p_mode=mode)
    ref_support = tsampling.top_p_filter(tsampling.top_k_filter(torch.from_numpy(x), top_k),
                                         top_p, mode=mode)
    kept = tsampling._batched_filter(torch.from_numpy(x), torch.full((b,), top_k),
                                     torch.full((b,), top_p), mode)
    np.testing.assert_array_equal(torch.isfinite(kept).numpy(),
                                  torch.isfinite(ref_support).numpy())
    for seed in range(5):
        want = tsampling.sample_token(torch.Generator().manual_seed(seed), torch.from_numpy(x),
                                      temperature=0.7, top_k=top_k, top_p=top_p, **kw)
        got = tsampling.sample_token_batched(
            torch.Generator().manual_seed(seed), torch.from_numpy(x), torch.full((b,), 0.7),
            torch.full((b,), top_k), torch.full((b,), top_p), **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sample_token_draws_are_multinomials():
    """The draw without ``torch.multinomial``'s device reads takes the same
    numbers from the generator and gives the same tokens."""
    x = torch.from_numpy(_logits(3, 3))
    for seed in range(5):
        g1, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        probs = torch.softmax(tsampling.top_k_filter(x, 20) / 0.7, dim=-1)
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        got = tsampling.sample_token(g2, x, temperature=0.7, top_k=20, top_p=0.0,
                                     vocab_size=V)
        assert torch.equal(got, want)
        assert torch.equal(g1.get_state(), g2.get_state())


# ---------------------------------------------------------------------------
# split generate
# ---------------------------------------------------------------------------


def _tiny():
    jcfg = jgptj.GPTJConfig.tiny(compute_dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = tgptj.GPTJConfig.tiny(compute_dtype=torch.float32, param_dtype=torch.float32)
    jp = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(0), jcfg))
    tp, _ = from_jax_params({"lm": jp, "image_prefix": {}}, None, tcfg, None)
    return jcfg, tcfg, jp, tp["lm"]


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


GREEDY = dict(temperature=0.0, top_k=0, top_p=0.0)


@pytest.mark.parametrize("case", ["ragged", "chunked_padded_last"])
def test_split_generate_greedy_equals_jax(tiny, case):
    jcfg, tcfg, jp, tp = tiny
    if case == "ragged":
        emb, lens, kw = _normal((3, 12, 128), 1), [12, 7, 9], dict(window=4)
    else:  # 21 positions in chunks of 8: the last chunk pads 3 to 8
        emb, lens, kw = _normal((3, 21, 128), 4), [21, 9, 14], dict(window=4, prefill_chunk=8)
    ref, _ = jsampling.generate_tokens_split(
        jcfg, jp, jnp.asarray(emb), jax.random.PRNGKey(7), max_steps=9, eos_token=-1,
        prompt_len=jnp.asarray(lens, jnp.int32), **GREEDY, **kw)
    got, steps = tsampling.generate_tokens_split(
        tcfg, tp, torch.from_numpy(emb), None, max_steps=9, eos_token=-1,
        prompt_len=torch.tensor(lens), **GREEDY, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert steps == 9


def test_split_generate_early_eos_equals_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    emb = _normal((3, 12, 128), 1)
    first, _ = tsampling.generate_tokens(tcfg, tp, torch.from_numpy(emb), None, max_steps=6,
                                         eos_token=-1, **GREEDY)
    eos = int(first[0, 2])  # row 0 emits it at step 2
    ref, ref_n = jsampling.generate_tokens_split(
        jcfg, jp, jnp.asarray(emb), jax.random.PRNGKey(7), max_steps=10, eos_token=eos,
        window=3, **GREEDY)
    got, steps = tsampling.generate_tokens_split(
        tcfg, tp, torch.from_numpy(emb), None, max_steps=10, eos_token=eos, window=3, **GREEDY)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert steps == int(ref_n)


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("sampling", [dict(temperature=0.8, top_k=50, top_p=0.9),
                                      dict(temperature=1.0, top_k=0, top_p=0.0)])
def test_split_generate_sampled_equals_generate_tokens(tiny, sampling, chunk):
    """The same draws in the same order as the port's ``generate_tokens``."""
    _, tcfg, _, tp = tiny
    emb = torch.from_numpy(_normal((3, 21, 128), 5))
    lens = torch.tensor([21, 9, 14])
    kw = dict(max_steps=11, eos_token=-1, prompt_len=lens, **sampling)
    want, _ = tsampling.generate_tokens(tcfg, tp, emb, torch.Generator().manual_seed(3), **kw)
    got, steps = tsampling.generate_tokens_split(tcfg, tp, emb, torch.Generator().manual_seed(3),
                                                 window=4, prefill_chunk=chunk, **kw)
    assert torch.equal(got, want) and steps == 11


def test_magma_generate_routes_large_batches_to_split(monkeypatch):
    """b·s above 8192 padded positions takes ``generate_tokens_split``
    (window 8, chunks of 512), at or below it ``generate_tokens``; both
    give the same greedy tokens."""
    from magma_tpu_torch.config import MultimodalConfig as TConfig
    from magma_tpu_torch.models import magma as tmagma

    cfg = TConfig(batch_size=1, train_steps=1, encoder_name="clip_resnet_large",
                  lm_overrides=dict(n_layers=2, n_heads=4, d_model=128, d_ff=256, rotary_dim=16,
                                    max_seq_len=1024, attention_impl="xla"),
                  encoder_overrides=dict(width=16, blocks=(1, 1, 1, 1), input_resolution=32),
                  image_size=32, compute_dtype="float32", param_dtype="float32")
    model = tmagma.Magma(cfg, seed=0, device="cpu")
    calls = []
    split = tmagma.generate_tokens_split

    def spy(*a, **kw):
        calls.append((kw["window"], kw["prefill_chunk"]))
        return split(*a, **kw)

    monkeypatch.setattr(tmagma, "generate_tokens_split", spy)
    emb = torch.from_numpy(_normal((9, 900, 128), 6, 0.5))  # pads to 960: 8640 > 8192
    lens = torch.tensor([900, 640, 513, 900, 2, 700, 899, 512, 300])
    got = model.generate(emb, max_steps=5, temperature=0.0, decode=False, prompt_len=lens)
    assert calls == [(8, 512)]
    padded = torch.nn.functional.pad(emb, (0, 0, 0, 60))
    want, _ = tsampling.generate_tokens(model.lm_config, model.params["lm"], padded, None,
                                        max_steps=5, temperature=0.0, prompt_len=lens,
                                        eos_token=model.eos_token)
    np.testing.assert_array_equal(got, want.numpy())
    model.generate(emb[:8, :960 - 60], max_steps=2, temperature=0.0, decode=False)  # 8 x 896
    model.generate(torch.zeros((8, 1024, 128)), max_steps=2, temperature=0.0,
                   decode=False)  # 8192: not above
    assert calls == [(8, 512)]
