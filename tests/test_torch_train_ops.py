"""The training path's pieces of the port against the JAX package's, on
the CPU: the flash-attention backward (K9a/K9b's plain version and the
autograd Function), the int8 input gradient (K10's plain version), the
QLoRA weight layout, labels and losses, the optimizer, and the vision
tower's training modes.  Inputs come from numpy seeds.

Tolerances:
* flash backward: both sides fp32 (JAX's kernels in interpret mode
  contract fp32 operands), another summation order: 1e-4 absolute on
  gradients of magnitude ~1-10.
* K10's plain version follows the Pallas kernel (g s rounded to bf16): it
  equals a numpy composition of those steps exactly on inputs whose sums
  are exact in fp32, and within the fp32 summation bound on random ones;
  against JAX's CPU VJP (fp32 throughout) within the bf16 rounding bound
  2^-8 sum |g s| |W|.
* losses, schedules and optimizer steps in fp32: 1e-6 relative (another
  order of the same fp32 operations).
* the CLIP tower in fp32 training mode: 1e-4 relative on features, 1e-5
  on the running statistics.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.models import clip_resnet as jclip
from magma_tpu.models import gptj as jgptj
from magma_tpu.models import image_prefix as jip
from magma_tpu.models.adapters import AdapterSpec as JAdapterSpec
from magma_tpu.ops import flash_attention as jflash
from magma_tpu.ops import quant as jquant
from magma_tpu.training import labels as jlabels
from magma_tpu.training import optim as joptim
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import clip_resnet as tclip
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models import image_prefix as tip
from magma_tpu_torch.models.adapters import AdapterSpec as TAdapterSpec
from magma_tpu_torch.ops import quant as tquant
from magma_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd_plain
from magma_tpu_torch.training import labels as tlabels
from magma_tpu_torch.training import optim as toptim
from magma_tpu_torch.utils import tree_items

# ---------------------------------------------------------------------------
# Flash attention backward
# ---------------------------------------------------------------------------

BWD_ATOL = 1e-4
BWD_CASES = {
    "causal_hd256": dict(b=2, h=2, s_q=256, s_k=256, hd=256, kv_len=None, q_offset=0, causal=True),
    "not_causal": dict(b=1, h=2, s_q=128, s_k=256, hd=128, kv_len=None, q_offset=0, causal=False),
    "kv_len_fully_masked_row": dict(b=2, h=2, s_q=256, s_k=256, hd=128, kv_len=[149, 0],
                                    q_offset=0, causal=True),
    "q_offset": dict(b=1, h=2, s_q=128, s_k=256, hd=128, kv_len=None, q_offset=128, causal=True),
    "several_blocks": dict(b=1, h=2, s_q=640, s_k=640, hd=128, kv_len=[600], q_offset=0,
                           causal=True),
}


def _rand(r, *shape, scale=0.5):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _to_bh(x):
    b, s, h, hd = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, hd))


def _from_bh(x, b, h):
    x = np.asarray(x)
    return x.reshape(b, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_plain_matches_jax_kernels(case):
    """flash_attention_bwd_plain on the O and lse of JAX's _fwd equals
    JAX's _bwd (both Pallas kernels in interpret mode)."""
    c = BWD_CASES[case]
    b, h, hd = c["b"], c["h"], c["hd"]
    r = np.random.default_rng(0)
    q, do = _rand(r, b, c["s_q"], h, hd), _rand(r, b, c["s_q"], h, hd)
    k, v = _rand(r, b, c["s_k"], h, hd), _rand(r, b, c["s_k"], h, hd)
    use_kv_len = c["kv_len"] is not None
    kvl = (np.repeat(np.asarray(c["kv_len"], np.int32), h) if use_kv_len
           else np.full((b * h,), c["s_k"], np.int32))
    kw = dict(scale=hd ** -0.5, causal=c["causal"], use_kv_len=use_kv_len,
              q_offset=c["q_offset"], interpret=True)
    o, lse = jflash._fwd(_to_bh(q), _to_bh(k), _to_bh(v), jnp.asarray(kvl), **kw)
    dq, dk, dv = jflash._bwd(_to_bh(q), _to_bh(k), _to_bh(v), jnp.asarray(kvl), o, lse,
                             _to_bh(do), **kw)
    o_t = torch.from_numpy(_from_bh(o, b, h).copy())
    lse_t = torch.from_numpy(np.asarray(lse).reshape(b, h, -1).copy())
    kv_len = torch.tensor(c["kv_len"]) if use_kv_len else None
    got = flash_attention_bwd_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), o_t, lse_t, torch.from_numpy(do),
        scale=hd ** -0.5, causal=c["causal"], kv_len=kv_len, q_offset=c["q_offset"])
    for name, g, want in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        want = _from_bh(want, b, h)
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), want, atol=BWD_ATOL, rtol=0, err_msg=name)
    if case == "kv_len_fully_masked_row":  # batch row 1 attends nothing: zero gradients
        for g in got:
            assert not g[1].any()


@pytest.mark.parametrize("s, hd, kv_len", [(200, 128, [200, 57]), (256, 256, None),
                                           (130, 128, [0, 130])],
                         ids=["ragged_s", "hd256", "masked_row"])
def test_flash_attention_grad_matches_jax_grad(s, hd, kv_len):
    """torch.autograd through the port's Function (padding through
    autograd) against jax.grad of flash_attention(interpret=True)."""
    r = np.random.default_rng(1)
    b, h = 2, 2
    q, k, v, g = (_rand(r, b, s, h, hd) for _ in range(4))
    scale = hd ** -0.5
    jkv = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    def jloss(q, k, v):
        o = jflash.flash_attention(q, k, v, scale=scale, causal=True, kv_len=jkv,
                                   interpret=True)
        return jnp.sum(o * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = flash_attention(tq, tk, tv, scale=scale, kv_len=None if kv_len is None
                        else torch.tensor(kv_len))
    got = torch.autograd.grad((o * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=BWD_ATOL, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# K10: the int8 input gradient
# ---------------------------------------------------------------------------


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)


def test_int8_dx_plain_equals_the_kernel_steps_exactly():
    """g s on a 2^-10 grid plus a residue below half a bf16 ulp, s a power
    of two: the kernel's bf16 rounding drops the residue and every sum is
    exact in fp32, so the plain version equals the numpy composition bit
    for bit (and JAX's unrounded fp32 fallback does not)."""
    r = np.random.default_rng(2)
    m, k, n = 8, 128, 256
    grid = r.integers(1, 129, (m, n)) * r.choice([-1, 1], (m, n))
    resid = r.uniform(0.1, 0.9, (m, n)) * 2.0 ** -20 * r.choice([-1, 1], (m, n))
    s = (2.0 ** r.integers(-3, 4, n)).astype(np.float32)
    g = ((grid * 2.0 ** -10 + resid) / s).astype(np.float32)
    w = r.integers(-127, 128, (k, n)).astype(np.int8)
    want = (_bf16(g * s) @ w.astype(np.float64).T).astype(np.float32)
    np.testing.assert_array_equal(want, (grid * 2.0 ** -10) @ w.astype(np.float64).T)
    got = tquant.int8_matmul_dx_plain(torch.from_numpy(g), torch.from_numpy(w),
                                      torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)
    fallback = np.asarray(jnp.dot(jnp.asarray(g) * s, jnp.asarray(w, jnp.float32).T))
    assert not np.array_equal(fallback, want)


def test_int8_dx_plain_matches_numpy_composition():
    r = np.random.default_rng(3)
    m, k, n = 16, 256, 384
    g, s = _rand(r, m, n, scale=1.0), r.uniform(1e-4, 1e-3, n).astype(np.float32)
    w = r.integers(-127, 128, (k, n)).astype(np.int8)
    gs = _bf16(g * s)
    want = gs @ w.astype(np.float64).T
    got = tquant.int8_matmul_dx_plain(torch.from_numpy(g), torch.from_numpy(w),
                                      torch.from_numpy(s)).numpy()
    # fp32 summation of n exact products: within n 2^-24 sum |terms|
    bound = n * 2.0 ** -24 * (np.abs(gs) @ np.abs(w.astype(np.float64)).T)
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "head"])
def test_int8_matmul_grad_matches_jax_vjp(stacked):
    """dx through the port's autograd Function against jax.grad of JAX's
    int8_matmul_stacked / int8_matmul (its CPU VJP, fp32 throughout): within
    the bf16 rounding of g s; no gradient reaches the scales."""
    r = np.random.default_rng(4)
    m, k, n, L = 12, 256, 384, 3
    w = jquant.quantize_int8(jnp.asarray(_rand(r, L, k, n)))
    x, g = _rand(r, 2, m // 2, k), _rand(r, 2, m // 2, n)
    wq, sc = np.array(w["q"]), np.array(w["s"])
    if stacked:
        jfn = lambda x: jquant.int8_matmul_stacked(x, w["q"], w["s"], 1)  # noqa: E731
    else:
        jfn = lambda x: jquant.int8_matmul(x, w["q"][1], w["s"][1])  # noqa: E731
    want = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x) * g))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    tw, ts = torch.from_numpy(wq), torch.from_numpy(sc).requires_grad_()
    out = (tquant.int8_matmul_stacked(tx, tw, ts, 1) if stacked
           else tquant.int8_matmul(tx, tw[1], ts[1]))
    (out * torch.from_numpy(g)).sum().backward()
    bound = 2.0 ** -8 * (np.abs(g.reshape(m, n) * sc[1]) @ np.abs(wq[1].astype(np.float64)).T)
    assert (np.abs(tx.grad.numpy().reshape(m, k) - want.reshape(m, k)) <= bound + 1e-7).all()
    assert ts.grad is None


# ---------------------------------------------------------------------------
# The QLoRA weight layout
# ---------------------------------------------------------------------------


def test_qlora_layout_byte_identical_to_jax():
    """quantize_lm_params(fuse_out_proj=False): fused in_proj, separate o
    and fc_out int8 stacks, the int8 head, bf16 adapters; no out_proj and
    no bvecs; every leaf equal to JAX's jitted bytes."""
    lm = dict(n_layers=2, d_model=256, n_heads=2, d_ff=512, rotary_dim=16)
    spec = dict(adapter_type="normal", downsample_factor=4)
    jcfg = jgptj.GPTJConfig.tiny(**lm, mlp_adapter=JAdapterSpec(**spec))
    tcfg = tgptj.GPTJConfig.tiny(**lm, mlp_adapter=TAdapterSpec(**spec))
    p = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(0), jcfg))
    tp = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"]
    want = jgptj.quantize_lm_params(jax.tree_util.tree_map(jnp.asarray, p), fuse_out_proj=False)
    got = tgptj.quantize_lm_params(tp, fuse_out_proj=False)
    want, got = dict(tree_items(want)), dict(tree_items(got))
    assert got.keys() == want.keys()
    assert "blocks/attn/o/q" in got and "blocks/mlp/fc_out/kernel/s" in got
    assert not any("out_proj" in k or "bvecs" in k for k in got)
    for key, w in want.items():
        w, t = np.asarray(w), got[key]
        assert str(t.dtype).replace("torch.", "") == str(w.dtype), key
        np.testing.assert_array_equal(t.float().numpy() if t.dtype == torch.bfloat16
                                      else t.numpy(), w.astype(np.float32)
                                      if t.dtype == torch.bfloat16 else w, err_msg=key)
    assert got["blocks/adapter_mlp/down/kernel"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Labels and losses
# ---------------------------------------------------------------------------


def _captions(r, b=2, s=64, n_img=16):
    caps = np.full((b, s), 50256, np.int32)
    caps[0, :9] = r.integers(0, 50000, 9)
    caps[1, :4] = r.integers(0, 50000, 4)
    caps[1, 20] = 77  # a token after the first EOS: ignored
    return caps


def test_build_labels_equal():
    caps = _captions(np.random.default_rng(5))
    want = np.asarray(jlabels.build_labels(16, jnp.asarray(caps), 50256))
    got = tlabels.build_labels(16, torch.from_numpy(caps), 50256)
    np.testing.assert_array_equal(got.numpy(), want)


def test_causal_lm_losses_match_jax():
    """causal_lm_loss over fp32 logits and the chunked loss over hidden
    states (chunk 256: seq 600 gives 3 chunks, the last padded), both in
    fp32, both equal to JAX's."""
    r = np.random.default_rng(6)
    cfg_kw = dict(n_layers=1, d_model=64, n_heads=1, d_ff=128, rotary_dim=16)
    jcfg = jgptj.GPTJConfig.tiny(**cfg_kw, compute_dtype=jnp.float32)
    tcfg = tgptj.GPTJConfig.tiny(**cfg_kw, compute_dtype=torch.float32)
    wte = _rand(r, jcfg.padded_vocab_size, 64, scale=0.02)
    wte[jcfg.vocab_size:] = 0
    hidden = _rand(r, 2, 600, 64, scale=1.0)
    caps = np.full((2, 600), 50256, np.int32)
    caps[0, :500], caps[1, :77] = r.integers(0, 50000, 500), r.integers(0, 50000, 77)
    labels = jlabels.build_labels(8, jnp.asarray(caps), 50256)
    want = jlabels.causal_lm_loss_chunked(jcfg, {"wte": jnp.asarray(wte)}, jnp.asarray(hidden),
                                          labels)
    tl = torch.from_numpy(np.array(labels)).long()
    got = tlabels.causal_lm_loss_chunked(tcfg, {"wte": torch.from_numpy(wte)},
                                         torch.from_numpy(hidden), tl)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    logits = _rand(r, 2, 600, jcfg.padded_vocab_size, scale=3.0)
    want = jlabels.causal_lm_loss(jnp.asarray(logits), labels, jcfg.vocab_size)
    got = tlabels.causal_lm_loss(torch.from_numpy(logits), tl, tcfg.vocab_size)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


def _opt_config(cls, **kw):
    base = dict(batch_size=8, train_steps=10, lr=3e-3, min_lr=1e-4, warmup_num_steps=3,
                image_enc_lr=5e-4, weight_decay=0.1, gradient_clipping=1.0)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("decay", [None, 9], ids=["WarmupLR", "WarmupDecayLR"])
def test_schedules_match_optax(decay):
    for base in (3e-3, 5e-4):
        want = joptim.make_schedule(_opt_config(JConfig, lr_decay_iters=decay), base)
        got = toptim.make_schedule(_opt_config(TConfig, lr_decay_iters=decay), base)
        for count in range(14):
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-7, err_msg=count)


def _param_tree(r, dtype=np.float32):
    return {
        "lm": {"wte": _rand(r, 8, 4).astype(dtype),
               "blocks": {"adapter_mlp": {"down": {"kernel": _rand(r, 2, 4, 3).astype(dtype),
                                                   "bias": _rand(r, 2, 3).astype(dtype)}},
                          "ln_1": {"scale": _rand(r, 2, 4).astype(dtype)}}},
        "image_prefix": {"proj": {"kernel": _rand(r, 5, 4), "bias": _rand(r, 4)},
                         "ln": {"scale": _rand(r, 4), "bias": _rand(r, 4)},
                         "enc": {"stem": {"conv1": _rand(r, 3, 3, 2, 2),
                                          "bn1": {"scale": _rand(r, 2)}},
                                 "layer1": [{"down_bn": {"bias": _rand(r, 2)},
                                             "conv2": _rand(r, 1, 1, 2, 2)}]}},
    }


def test_label_params_groups_equal():
    r = np.random.default_rng(7)
    p = _param_tree(r)
    want = dict(tree_items(jax.tree_util.tree_map(lambda x: x, joptim.label_params(p))))
    got = dict(tree_items(toptim.label_params(p)))
    assert got == want
    assert {"main_decay", "main_none", "img_enc_decay", "img_enc_none"} == set(got.values())


def _torch_tree(p):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p)


def test_adamw_steps_match_optax():
    """Five clipped AdamW steps over the four groups in fp32 (the gradient
    norm above the clip in some steps, below in others), then a step with
    a NaN gradient that both skip, then one more applied."""
    r = np.random.default_rng(8)
    p = _param_tree(r)
    jcfg, tcfg = _opt_config(JConfig), _opt_config(TConfig)
    opt, _ = joptim.make_optimizer(jcfg, p)
    jp, jstate = jax.tree_util.tree_map(jnp.asarray, p), None
    jstate = opt.init(jp)
    tp = _torch_tree(p)
    named = list(tree_items(tp))
    topt = toptim.AdamW(tcfg, named)
    for step in range(7):
        scale = (0.05, 3.0, 0.2, 5.0, 0.01, 1.0, 1.0)[step]
        g = jax.tree_util.tree_map(lambda a: _rand(r, *a.shape, scale=scale), p)
        if step == 5:
            g["lm"]["wte"][0, 0] = np.nan
        upd, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        applied = topt.step([torch.from_numpy(a) for _, a in tree_items(g)])
        assert applied == (step != 5)
        for (path, t), (_, w) in zip(named, tree_items(jp)):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {path}")
    assert topt.count == 6 and topt.total_notfinite == 1


# ---------------------------------------------------------------------------
# The vision tower's training modes
# ---------------------------------------------------------------------------

ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)


def _perturbed_tower(r):
    cfg = jclip.ClipResNetConfig(**ENC, compute_dtype=jnp.float32)
    params, stats = jclip.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + _rand(r, *a.shape, scale=0.05),
                                    params)
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a) + np.abs(_rand(r, *a.shape)), stats)
    return cfg, params, stats


def test_clip_resnet_train_mode_matches_jax():
    """Batch statistics over (N, H, W) with the biased variance, and the
    momentum-0.1 running statistics as the new state."""
    r = np.random.default_rng(9)
    cfg, params, stats = _perturbed_tower(r)
    images = r.random((3, 3, 64, 64), dtype=np.float32)
    want, want_stats = jclip.apply(params, stats, jnp.asarray(images), cfg, train=True)
    tp = from_jax_params({"lm": {}, "image_prefix": {"enc": params}}, None, None, None)[0]
    ts = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), stats)
    tcfg = tclip.ClipResNetConfig(**ENC, compute_dtype=torch.float32)
    got, got_stats = tclip.apply(tp["image_prefix"]["enc"], ts, torch.from_numpy(images), tcfg,
                                 train=True)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
    for (path, g), (_, w) in zip(tree_items(got_stats), tree_items(want_stats)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=path)
    # the new stats moved off the old ones, and inference mode leaves them
    assert not np.allclose(got_stats["stem"]["bn1"]["var"].numpy(), stats["stem"]["bn1"]["var"])
    _, same = tclip.apply(tp["image_prefix"]["enc"], ts, torch.from_numpy(images), tcfg)
    same = dict(tree_items(same))
    assert all(same[path] is t for path, t in tree_items(ts))


def test_image_prefix_train_mode_matches_jax_at_dropout_0():
    r = np.random.default_rng(10)
    _, enc_params, stats = _perturbed_tower(r)
    kw = dict(encoder_name="clip_resnet_large", out_dim=128, use_layernorm=True,
              dropout_prob=0.0, encoder_overrides=tuple(sorted(
                  dict(ENC, compute_dtype=jnp.float32).items())), compute_dtype=jnp.float32)
    jcfg = jip.ImagePrefixConfig(**kw)
    params = {"enc": enc_params, "proj": {"kernel": _rand(r, 512, 128, scale=0.05),
                                          "bias": _rand(r, 128)},
              "ln": {"scale": 1 + _rand(r, 128, scale=0.1), "bias": _rand(r, 128)}}
    images = r.random((2, 3, 64, 64), dtype=np.float32)
    want, want_stats = jip.apply(params, {"enc": stats}, jnp.asarray(images), jcfg, train=True)
    kw.update(encoder_overrides=tuple(sorted(dict(ENC, compute_dtype=torch.float32).items())),
              compute_dtype=torch.float32)
    tcfg = tip.ImagePrefixConfig(**kw)
    tp = from_jax_params({"lm": {}, "image_prefix": params}, None, None, None)[0]["image_prefix"]
    ts = {"enc": jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), stats)}
    got, got_stats = tip.apply(tp, ts, torch.from_numpy(images), tcfg, train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    for (path, g), (_, w) in zip(tree_items(got_stats), tree_items(want_stats)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=path)


def test_image_prefix_dropout_keeps_and_rescales():
    """Dropout 0.5 with a torch.Generator: about half the elements zeroed,
    the kept ones scaled by 2 before the (absent) LN; the same generator
    seed gives the same bits."""
    r = np.random.default_rng(11)
    _, enc_params, stats = _perturbed_tower(r)
    tcfg = tip.ImagePrefixConfig(
        encoder_name="clip_resnet_large", out_dim=128, dropout_prob=0.5,
        encoder_overrides=tuple(sorted(dict(ENC, compute_dtype=torch.float32).items())),
        compute_dtype=torch.float32)
    params = {"enc": enc_params, "proj": {"kernel": _rand(r, 512, 128), "bias": _rand(r, 128)}}
    tp = from_jax_params({"lm": {}, "image_prefix": params}, None, None, None)[0]["image_prefix"]
    ts = {"enc": jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), stats)}
    images = torch.from_numpy(r.random((2, 3, 64, 64), dtype=np.float32))
    ref, _ = tip.apply(tp, ts, images, tip.ImagePrefixConfig(**{
        **tcfg.__dict__, "dropout_prob": 0.0}), train=True)
    outs = [tip.apply(tp, ts, images, tcfg, train=True,
                      generator=torch.Generator().manual_seed(3))[0] for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    kept = outs[0] != 0
    assert 0.4 < kept.float().mean().item() < 0.6
    torch.testing.assert_close(outs[0][kept], 2 * ref[kept])
    with pytest.raises(ValueError, match="generator"):
        tip.apply(tp, ts, images, tcfg, train=True)
