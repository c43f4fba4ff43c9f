"""The port's int4 serving path against the JAX package's, on the CPU.

Inputs are numpy-seeded; the JAX side runs as its own tests run it on the
CPU (its non-TPU fallbacks), and the port's public entries run their
plain versions on CPU tensors.

* Packs are byte-identical: ``quantize_int4`` eagerly and as JAX's jitted
  ``lax.map`` gives it (where XLA turns /7 into *fp32(1/7)),
  ``quantize_lm_params_int4`` leaf for leaf (JAX's step-major "dsb"/"dsb2"
  copies of the scales aside: the port does not build them).
* The W4A8 plain versions (K3, K4b, K6's products) equal a composition of
  JAX's own ``_quantize_act_block`` and nibble arithmetic bit for bit: the
  int8 dots are exact and the fp32 steps are the same operations in the
  same order.  JAX's CPU fallbacks compute W4A16 (the weights dequantised,
  the activations kept): there the two differ by the activation rounding
  alone, at most half a code step (scale / 2) times |w| summed over each
  256-block, a bound the tests compute per output.
* At ``GPTJConfig.tiny`` widths (K = 128, group 64) both packages compute
  W4A16 and greedy tokens are identical; at d_model 512 (group 256) the
  port computes W4A8, JAX W4A16, and teacher-forced logits agree within
  the activation rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.models import gptj as jgptj
from magma_tpu.models.adapters import AdapterSpec as JAdapterSpec
from magma_tpu.models.magma import Magma as JMagma
from magma_tpu.ops import quant as jq
from magma_tpu.ops.sampling import generate_tokens as jgenerate
from magma_tpu.training.torch_convert import to_torch_state_dict
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models.adapters import AdapterSpec as TAdapterSpec
from magma_tpu_torch.models.magma import Magma as TMagma
from magma_tpu_torch.ops import quant as tq
from magma_tpu_torch.ops.sampling import generate_tokens as tgenerate

G = 256
BF16 = jnp.bfloat16


def _normal(shape, seed, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# (a) packs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compiled", [False, True], ids=["eager", "compiled"])
@pytest.mark.parametrize("k", [512, 128], ids=["group256", "small_k_fallback"])
def test_quantize_int4_byte_identical(k, compiled):
    w = _normal((3, k, 384), 0, 0.05)
    w[..., 0, 1] = 0.0  # a column with a zero below its max
    w[..., :, 2] = 0.0  # an all-zero column: scale from the clamp
    if compiled:  # as quantize_lm_params_int4 runs it
        ref = jax.jit(lambda a: jax.lax.map(jq.quantize_int4, a))(jnp.asarray(w))
    else:
        ref = jq.quantize_int4(jnp.asarray(w))
    got = tq.quantize_int4(_t(w), compiled=compiled)
    assert got["q4"].dtype == torch.int8 and got["s4"].dtype == torch.float32
    assert tuple(got["s4"].shape) == (3, k // tq._int4_group(k), 384)
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(ref["q4"]))
    np.testing.assert_array_equal(got["s4"].numpy(), np.asarray(ref["s4"]))
    np.testing.assert_array_equal(tq.dequantize_int4(got["q4"], got["s4"]).numpy(),
                                  np.asarray(jq.dequantize_int4(ref["q4"], ref["s4"])))
    if compiled:  # the two forms really differ: the flag is needed
        eager = tq.quantize_int4(_t(w))["s4"]
        assert not torch.equal(eager, got["s4"])


def test_int4_group_rule_matches_jax():
    for k in (128, 256, 512, 1024, 1536, 4096):
        assert tq._int4_group(k) == jq._int4_group(k)


LM_W4A8 = dict(n_layers=2, d_model=512, n_heads=4, d_ff=2048, rotary_dim=16)
LM_TINY = dict(n_layers=2, n_heads=4, d_model=128, d_ff=512, rotary_dim=16)
ADAPTERS = {
    # the v1 recipe: an mlp adapter, fused
    "v1_normal_mlp": (dict(adapter_type="normal", downsample_factor=4), None),
    # an attention adapter fed from u_in, the scalar folded into its pack
    "scaled_attn_normal_mlp": (dict(adapter_type="normal", downsample_factor=4),
                               dict(adapter_type="scaled_parallel", downsample_factor=4)),
}


def _configs(lm, adapters, cdt=("float32", torch.float32)):
    mlp, attn = ADAPTERS[adapters]
    if lm is LM_TINY:  # a hidden width of 128 so the adapters fuse at d_model 128
        mlp = dict(mlp, downsample_factor=1)
        attn = attn and dict(attn, downsample_factor=1)
    jcfg = jgptj.GPTJConfig.tiny(
        **lm, compute_dtype=jnp.dtype(cdt[0]), param_dtype=jnp.float32,
        mlp_adapter=JAdapterSpec(**mlp), attn_adapter=JAdapterSpec(**attn) if attn else None)
    tcfg = tgptj.GPTJConfig.tiny(
        **lm, compute_dtype=cdt[1], param_dtype=torch.float32,
        mlp_adapter=TAdapterSpec(**mlp), attn_adapter=TAdapterSpec(**attn) if attn else None)
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    p = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(seed), jcfg))
    r = np.random.default_rng(seed)
    for key in ("adapter_mlp", "adapter_attn"):  # near-zero init hides bugs
        if key in p["blocks"]:
            p["blocks"][key] = jax.tree_util.tree_map(
                lambda a: (a + r.standard_normal(a.shape) * 0.05).astype(np.float32),
                p["blocks"][key])
    if "scale" in p["blocks"].get("adapter_attn", {}):
        p["blocks"]["adapter_attn"]["scale"] = np.array([1.5, -0.75], np.float32)
    for name in ("ln_1",):  # non-trivial LN so ln_g/ln_b matter
        p["blocks"][name]["scale"] = (1 + r.standard_normal(p["blocks"][name]["scale"].shape)
                                      * 0.1).astype(np.float32)
    p["blocks"]["attn"]["o_bias"] = (r.standard_normal(p["blocks"]["attn"]["o_bias"].shape)
                                     * 0.02).astype(np.float32)
    return p


def _int4_pair(lm, adapters, cdt=("float32", torch.float32)):
    """(jcfg, tcfg, JAX int4 tree, port int4 tree) from the same weights."""
    jcfg, tcfg = _configs(lm, adapters, cdt)
    p = _jax_params(jcfg)
    tp = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"]
    jp = jgptj.quantize_lm_params_int4(jax.tree_util.tree_map(jnp.asarray, p))
    return jcfg, tcfg, jp, tgptj.quantize_lm_params_int4(tp)


def _without_tpu_leaves(tree):
    return {k: v for k, v in _flat(tree) if not k.endswith(("/dsb", "/dsb2"))}


@pytest.mark.parametrize("lm", ["w4a8", "tiny"])
def test_quantize_lm_params_int4_byte_identical(lm):
    _, _, jp, tp = _int4_pair(LM_W4A8 if lm == "w4a8" else LM_TINY, "scaled_attn_normal_mlp")
    want, got = _without_tpu_leaves(jp), dict(_flat(tp))
    assert got.keys() == want.keys()
    for key in ("/blocks/attn/in_proj/q4", "/blocks/attn/out_proj/s4", "/lm_head_q/q",
                "/blocks/bvecs/ln_g", "/blocks/adapter_mlp/fused/wd",
                "/blocks/adapter_attn/fused/su"):
        assert key in got
    for k, w in want.items():
        w = np.asarray(w)
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(_np(got[k]), w.astype(_np(got[k]).dtype), err_msg=k)


def test_quantize_lm_params_int4_refuses_int8_params():
    jcfg, tcfg = _configs(LM_TINY, "v1_normal_mlp")
    tp = from_jax_params({"lm": _jax_params(jcfg), "image_prefix": {}}, None, tcfg, None)[0]
    q8 = tgptj.quantize_lm_params(tp["lm"])
    with pytest.raises(ValueError, match="full-precision"):
        tgptj.quantize_lm_params_int4(q8)


def test_from_jax_params_carries_the_int4_layout():
    """A JAX int4 tree crosses as stored (q4 int8, s4 fp32), without its
    TPU-only "dsb"/"dsb2", and equals the port's own packing."""
    jcfg, tcfg, jp, tp = _int4_pair(LM_W4A8, "v1_normal_mlp")
    assert "dsb" in jp["blocks"]["attn"]["out_proj"]
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    got = from_jax_params({"lm": np_tree, "image_prefix": {}}, None,
                          dataclasses.replace(tcfg, param_dtype=torch.bfloat16), None)[0]["lm"]
    assert set(got["blocks"]["attn"]["out_proj"]) == {"q4", "s4"}
    assert set(got["blocks"]["attn"]["in_proj"]) == {"q4", "s4"}
    assert got["blocks"]["attn"]["in_proj"]["q4"].dtype == torch.int8
    assert got["blocks"]["attn"]["in_proj"]["s4"].dtype == torch.float32
    got = dict(_flat(got))
    for k, t in _flat(tp):
        if t.dtype == torch.int8 or "_proj/" in k or "fused" in k or "bvecs" in k:
            torch.testing.assert_close(got[k], t, atol=0, rtol=0, msg=k)


# ---------------------------------------------------------------------------
# (b) the W4A8 plain versions against JAX's own arithmetic, and JAX's CPU
# fallbacks at the W4A8 tolerance
# ---------------------------------------------------------------------------


def _jax_w4a8(x, q4, s4):
    """K3's arithmetic composed of JAX's ``_quantize_act_block`` and the
    Pallas kernel's nibble decoding (``quant.py:447-457``)."""
    kp, n = q4.shape
    nk = kp // G
    acc = jnp.zeros((x.shape[0], n), jnp.float32)
    for kb in range(nk):
        xlo, sxlo = jq._quantize_act_block(x[:, kb * G:(kb + 1) * G])
        xhi, sxhi = jq._quantize_act_block(x[:, kp + kb * G:kp + (kb + 1) * G])
        p32 = q4[kb * G:(kb + 1) * G].astype(jnp.int32)
        lo = ((p32 << 28) >> 28).astype(jnp.int8)
        hi = (p32 >> 4).astype(jnp.int8)
        plo = jax.lax.dot(xlo, lo, preferred_element_type=jnp.int32)
        phi = jax.lax.dot(xhi, hi, preferred_element_type=jnp.int32)
        acc = acc + (plo.astype(jnp.float32) * sxlo * s4[kb] + phi.astype(jnp.float32) * sxhi
                     * s4[nk + kb])
    return acc


def _a8_bound(x, q4, s4):
    """|W4A8 - W4A16| per output: each activation moves by at most half a
    code step (its block's scale / 2), so each output by at most
    sum over blocks of scale / 2 * sum |w| of the block, plus fp32
    rounding of the two sums."""
    w = np.abs(np.asarray(jq.dequantize_int4(jnp.asarray(q4), jnp.asarray(s4))))
    x = np.asarray(x, np.float32)
    k = x.shape[1]
    blocks = x.reshape(x.shape[0], k // G, G)
    half_step = np.abs(blocks).max(-1) / 127.0 / 2  # (m, k / 256)
    colsum = w.reshape(k // G, G, -1).sum(1)          # (k / 256, n)
    return half_step @ colsum + 1e-5 * (np.abs(x) @ w) + 1e-6


def _int4_stack(k, n, seed, layers=2):
    q = jax.jit(lambda a: jax.lax.map(jq.quantize_int4, a))(
        jnp.asarray(_normal((layers, k, n), seed, 0.05)))
    return np.asarray(q["q4"]), np.asarray(q["s4"])


@pytest.mark.parametrize("m", [1, 5, 37])
def test_int4_matmul_plain_is_the_w4a8_arithmetic(m):
    q4, s4 = _int4_stack(1024, 384, 1)
    x = _normal((m, 1024), 10 + m)
    for li in range(2):
        got = tq.int4_matmul_stacked(_t(x), _t(q4), _t(s4), li)
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, 384)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(_jax_w4a8(jnp.asarray(x), q4[li], s4[li])))
        w4a16 = np.asarray(jq.int4_matmul_stacked(jnp.asarray(x), q4, s4, li))
        assert np.all(np.abs(got.numpy() - w4a16) <= _a8_bound(x, q4[li], s4[li]))


@pytest.mark.parametrize("m", [1, 37])
def test_int4_dual_plain_is_the_w4a8_arithmetic(m):
    ko, kf, n = 512, 1024, 256
    qo, so = _int4_stack(ko, n, 2)
    qf, sf = _int4_stack(kf, n, 3)
    w = {"q4": np.concatenate([qo, qf], 1), "s4": np.concatenate([so, sf], 1)}
    ctx, h = _normal((m, ko), 20 + m), _normal((m, kf), 30 + m)
    for li in range(2):
        a, mo = tq.dual_matmul_stacked(_t(ctx), _t(h), {k: _t(v) for k, v in w.items()}, li)
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(_jax_w4a8(jnp.asarray(ctx), qo[li], so[li])))
        np.testing.assert_array_equal(
            mo.numpy(), np.asarray(_jax_w4a8(jnp.asarray(h), qf[li], sf[li])))
        ra, rm = jq.dual_matmul_stacked(jnp.asarray(ctx), jnp.asarray(h),
                                        {k: jnp.asarray(v) for k, v in w.items()}, li)
        assert np.all(np.abs(a.numpy() - np.asarray(ra)) <= _a8_bound(ctx, qo[li], so[li]))
        assert np.all(np.abs(mo.numpy() - np.asarray(rm)) <= _a8_bound(h, qf[li], sf[li]))


def test_off_geometry_takes_the_dequantising_product():
    """Group 64 (K = 128): the JAX fallback's W4A16 function, on any input."""
    q4, s4 = _int4_stack(128, 256, 4)
    x = _normal((3, 128), 5)
    got = tq.int4_matmul_stacked(_t(x), _t(q4), _t(s4), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jq.int4_matmul_stacked(
        jnp.asarray(x), q4, s4, 1)), rtol=1e-5, atol=1e-5)


def _jax_k5(x, fz, li):
    """K5's function in jnp: x and h rounded to bf16, int8 W exact."""
    xb = x.astype(BF16).astype(jnp.float32)
    h = jax.nn.relu(xb @ fz["wd"][li].astype(jnp.float32) * fz["sd"][li, 0] + fz["bd"][li, 0])
    h = h.astype(BF16).astype(jnp.float32)
    return h @ fz["wu"][li].astype(jnp.float32) * fz["su"][li, 0] + fz["bu"][li, 0]


def _jax_boundary(ctx, mh, x, w_dual, bv, li, *, w_in, fz_attn, attn_src, fz_mlp, mlp_src,
                  u_in, ln_eps):
    """``_boundary_ref``'s op sequence over JAX's W4A8 arithmetic and K5's
    function: the function K6 computes."""
    D = ctx.shape[1]
    a = _jax_w4a8(ctx, w_dual["q4"][li][:D // 2], w_dual["s4"][li][:D // G]).astype(BF16)
    m = _jax_w4a8(mh, w_dual["q4"][li][D // 2:], w_dual["s4"][li][D // G:]).astype(BF16)
    a = a + bv["o_bias"][li][None].astype(BF16)
    if fz_attn is not None:
        a = a + _jax_k5(u_in if attn_src == "in" else a, fz_attn, li).astype(BF16)
    m = m + bv["b_fc_out"][li][None].astype(BF16)
    if fz_mlp is not None:
        m = m + _jax_k5(u_in if mlp_src == "in" else m, fz_mlp, li).astype(BF16)
    y = x + a + m
    y32 = y.astype(jnp.float32)
    mu = y32.mean(-1, keepdims=True)
    var = y32.var(-1, keepdims=True)
    u = ((y32 - mu) * jax.lax.rsqrt(var + ln_eps) * bv["ln_g"][li][None]
         + bv["ln_b"][li][None]).astype(BF16)
    if w_in is None:
        return y, u
    return y, u, _jax_w4a8(u, w_in["q4"][li + 1], w_in["s4"][li + 1]).astype(BF16)


def _boundary_case(adapters, m, seed=0):
    """JAX and port int4 trees at d_model 512 plus bf16 boundary inputs."""
    jcfg, tcfg, jp, tp = _int4_pair(LM_W4A8, adapters)
    r = np.random.default_rng(seed)
    D, F = 512, 2048
    rows = {"ctx": (m, D, 1.0), "mh": (m, F, 0.5), "x": (m, D, 0.3), "u_in": (m, D, 1.0)}
    ins = {k: (r.standard_normal(s[:2]) * s[2]).astype(np.float32) for k, s in rows.items()}
    ins = {k: np.asarray(jnp.asarray(v).astype(BF16).astype(jnp.float32)) for k, v in ins.items()}
    return jcfg, tcfg, jp, tp, ins


def _kw(cfg, blocks, adapters_used, w_in, u_in):
    fz = {k: blocks[k]["fused"] if k in blocks else None for k in ("adapter_attn", "adapter_mlp")}
    return dict(w_in=w_in, fz_attn=fz["adapter_attn"], attn_src="in",
                fz_mlp=fz["adapter_mlp"], mlp_src="out", u_in=u_in, ln_eps=cfg.ln_eps)


@pytest.mark.parametrize("last_layer", [False, True], ids=["with_w_in", "last_layer"])
@pytest.mark.parametrize("adapters", sorted(ADAPTERS))
def test_boundary_plain_is_the_w4a8_composition(adapters, last_layer):
    """K6's plain version against ``_boundary_ref``'s op sequence composed in
    JAX of the W4A8 arithmetic and K5's function: the dual and in_proj sums
    are bit-identical; the adapter's fp32 products sum in another order
    (XLA's against PyTorch's), so an h or an output on a bf16 rounding
    boundary may land one bf16 ulp apart: 2^-7 of the largest |y|, |u| and
    |fused| (measured 0: no such case at these inputs)."""
    jcfg, tcfg, jp, tp, ins = _boundary_case(adapters, 3)
    li = 1 if last_layer else 0
    jb, tb = jp["blocks"], tp["blocks"]
    jw_in = None if last_layer else jb["attn"]["in_proj"]
    tw_in = None if last_layer else tb["attn"]["in_proj"]
    jins = {k: jnp.asarray(v).astype(BF16) for k, v in ins.items()}
    tins = {k: _t(v).to(torch.bfloat16) for k, v in ins.items()}
    ref = _jax_boundary(jins["ctx"], jins["mh"], jins["x"], jb["attn"]["out_proj"], jb["bvecs"],
                        li, **_kw(jcfg, jb, adapters, jw_in, jins["u_in"]))
    tbv = tb["bvecs"]
    got = tq.boundary_fused_stacked(
        tins["ctx"], tins["mh"], tins["x"], tb["attn"]["out_proj"], tbv["b_fc_out"],
        tbv["ln_g"], tbv["ln_b"], li, o_bias=tbv["o_bias"],
        **_kw(tcfg, tb, adapters, tw_in, tins["u_in"]))
    plain = tq.boundary_fused_stacked_plain(
        tins["ctx"], tins["mh"], tins["x"], tb["attn"]["out_proj"], tbv["b_fc_out"],
        tbv["ln_g"], tbv["ln_b"], li, o_bias=tbv["o_bias"],
        **_kw(tcfg, tb, adapters, tw_in, tins["u_in"]))
    assert len(got) == len(ref) == (2 if last_layer else 3)
    for g, p, r, name in zip(got, plain, ref, ("y", "u", "fused")):
        assert g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g, p, atol=0, rtol=0, msg=name)  # CPU: the composition
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=2.0 ** -7 * np.abs(r).max(), err_msg=name)


def test_boundary_plain_against_jax_cpu_fallback():
    """Against JAX's own CPU ``boundary_fused_stacked`` (``_boundary_ref``:
    W4A16 products and the adapters' dequantising bf16 matmuls): the
    activation rounding of the three W4A8 products, 0.6-0.8% of each
    product's scale, carried through the LN into u and fused (measured
    0.9% of the largest magnitude).  Held at 4% of each output's largest
    magnitude."""
    jcfg, tcfg, jp, tp, ins = _boundary_case("scaled_attn_normal_mlp", 2)
    jb, tb = jp["blocks"], tp["blocks"]
    jins = {k: jnp.asarray(v).astype(BF16) for k, v in ins.items()}
    tins = {k: _t(v).to(torch.bfloat16) for k, v in ins.items()}
    jbv, tbv = jb["bvecs"], tb["bvecs"]
    ref = jq.boundary_fused_stacked(
        jins["ctx"], jins["mh"], jins["x"], jb["attn"]["out_proj"], jbv["b_fc_out"],
        jbv["ln_g"], jbv["ln_b"], 0, o_bias=jbv["o_bias"],
        **_kw(jcfg, jb, None, jb["attn"]["in_proj"], jins["u_in"]))
    got = tq.boundary_fused_stacked(
        tins["ctx"], tins["mh"], tins["x"], tb["attn"]["out_proj"], tbv["b_fc_out"],
        tbv["ln_g"], tbv["ln_b"], 0, o_bias=tbv["o_bias"],
        **_kw(tcfg, tb, None, tb["attn"]["in_proj"], tins["u_in"]))
    for g, r, name in zip(got, ref, ("y", "u", "fused")):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=0.04 * np.abs(r).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (c), (d) the LM: logits and greedy tokens
# ---------------------------------------------------------------------------

# tiny widths: W4A16 in both; the one difference is the fused adapter at
# m <= 64 (K5's function in the port, JAX's fallback rounds W s to bf16,
# 2^-9 relative per weight), bf16 noise on logits of magnitude ~1
# (measured 4.5e-3)
TINY_ATOL = 1e-2
# d_model 512: the port's W4A8 against JAX's W4A16 over two layers; the
# activation rounding (<= half a code step, 0.4% of a 256-block's max)
# moves each product by ~0.6-0.8% of its scale and the logits by up to
# ~2% of their magnitude (measured 0.035 at |logit| <= 1.9)
W4A8_ATOL = 0.1


def _teacher_forced(jcfg, tcfg, jp, tp, d, atol_prefill, atol_decode):
    b, s, steps, true_len, max_len = 2, 40, 4, 33, 64
    x = np.random.default_rng(1).standard_normal((b, s, d)).astype(np.float32)
    ids = np.random.default_rng(2).integers(0, 1000, (steps, b)).astype(np.int32)
    kvl = np.full((b,), true_len, np.int32)
    jcache, tcache = jgptj.init_kv_cache(jcfg, b, max_len), tgptj.init_kv_cache(tcfg, b, max_len)
    jl, jcache = jgptj.forward(jcfg, jp, jnp.asarray(x), cache=jcache,
                               cache_index=jnp.int32(0), kv_len=jnp.asarray(kvl))
    tl, tcache = tgptj.forward(tcfg, tp, torch.from_numpy(x), cache=tcache,
                               cache_index=0, kv_len=torch.from_numpy(kvl))
    np.testing.assert_allclose(tl[:, :true_len].numpy(), np.asarray(jl)[:, :true_len],
                               atol=atol_prefill)
    for t in range(steps):
        cur = true_len + t
        jemb = jgptj.embed_tokens(jcfg, jp, jnp.asarray(ids[t][:, None]))
        temb = tgptj.embed_tokens(tcfg, tp, torch.from_numpy(ids[t][:, None]).long())
        assert tgptj._boundary_ok(tcfg, tp["blocks"], temb)  # the decode takes K6's path
        jl, jcache = jgptj.forward(jcfg, jp, jemb, cache=jcache,
                                   cache_index=jnp.full((b,), cur, jnp.int32))
        tl, tcache = tgptj.forward(tcfg, tp, temb, cache=tcache,
                                   cache_index=torch.full((b,), cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol_decode,
                                   err_msg=f"decode step {t}")


@pytest.mark.parametrize("adapters", sorted(ADAPTERS))
def test_tiny_int4_logits_match_jax(adapters):
    jcfg, tcfg, jp, tp = _int4_pair(LM_TINY, adapters)
    _teacher_forced(jcfg, tcfg, jp, tp, 128, TINY_ATOL, TINY_ATOL)


def test_tiny_int4_greedy_tokens_identical_to_jax():
    jcfg, tcfg, jp, tp = _int4_pair(LM_TINY, "scaled_attn_normal_mlp")
    x = np.random.default_rng(3).standard_normal((1, 24, 128)).astype(np.float32)
    ref, _ = jgenerate(jcfg, jp, jnp.asarray(x), jax.random.PRNGKey(0), max_steps=16,
                       temperature=0.0)
    got, steps = tgenerate(tcfg, tp, torch.from_numpy(x), None, max_steps=16, temperature=0.0)
    assert steps == 16
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_w4a8_teacher_forced_logits_match_jax():
    jcfg, tcfg, jp, tp = _int4_pair(LM_W4A8, "v1_normal_mlp")
    _teacher_forced(jcfg, tcfg, jp, tp, 512, W4A8_ATOL, W4A8_ATOL)


# ---------------------------------------------------------------------------
# (e) the boundary decode is the per-layer decode; (f) the last-layer guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lm", ["w4a8", "tiny"])
@pytest.mark.parametrize("adapters", sorted(ADAPTERS))
def test_boundary_decode_equals_per_layer_decode(adapters, lm):
    """As ``tests/test_quant.py::test_boundary_decode_path_matches_unrolled``
    holds JAX's: the same step without "bvecs" takes ``_block`` per layer;
    in bf16 both run the same operations, so the logits are equal."""
    _, tcfg, _, tp = _int4_pair(LM_W4A8 if lm == "w4a8" else LM_TINY, adapters,
                                cdt=("bfloat16", torch.bfloat16))
    d = tcfg.d_model
    b, s_prompt = 2, 5
    x = torch.from_numpy(_normal((b, 1, d), 1, 0.1)).to(torch.bfloat16)
    cache = tgptj.init_kv_cache(tcfg, b, 32)
    for name in ("k", "v"):
        cache[name].copy_(torch.from_numpy(_normal(cache[name].shape, 2)).to(torch.bfloat16))
    assert tgptj._boundary_ok(tcfg, tp["blocks"], x)
    fused, _ = tgptj.forward(tcfg, tp, x, cache={k: v.clone() for k, v in cache.items()},
                             cache_index=s_prompt)
    bv = tp["blocks"].pop("bvecs")
    assert not tgptj._boundary_ok(tcfg, tp["blocks"], x)
    per_layer, _ = tgptj.forward(tcfg, tp, x, cache=cache, cache_index=s_prompt)
    tp["blocks"]["bvecs"] = bv
    torch.testing.assert_close(fused, per_layer, atol=0, rtol=0)


@pytest.mark.parametrize("idx", [1, np.int64(1), torch.tensor(1)], ids=["int", "np_int64", "0d"])
def test_boundary_last_layer_guard(idx):
    _, _, _, tp = _int4_pair(LM_TINY, "v1_normal_mlp")
    b = tp["blocks"]
    bv = b["bvecs"]
    row = torch.zeros((1, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="last layer"):
        tq.boundary_fused_stacked(row, torch.zeros((1, 512), dtype=torch.bfloat16), row,
                                  b["attn"]["out_proj"], bv["b_fc_out"], bv["ln_g"], bv["ln_b"],
                                  idx, w_in=b["attn"]["in_proj"])


# ---------------------------------------------------------------------------
# through the facade: JAX Magma -> reference-named .pt -> port Magma
# ---------------------------------------------------------------------------

ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)


def _mm_config_kwargs(impl):
    return dict(
        batch_size=2, train_steps=4, encoder_name="clip_resnet_large",
        adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 1}},
        use_image_embed_layernorm=True, image_embed_dropout_prob=0.1,
        # one head of 128: the port's flash kernel takes head_dim % 128 == 0
        lm_overrides=dict(LM_TINY, n_heads=1, max_seq_len=128, attention_impl=impl),
        image_size=64, compute_dtype="float32", param_dtype="float32",
        frozen_dtype="float32", attention_impl=impl, encoder_overrides=ENC)


def test_facade_int4_greedy_tokens_identical_to_jax(tmp_path):
    jm = JMagma(JConfig(**_mm_config_kwargs("xla")), rng=0)
    r = np.random.default_rng(0)
    jm.params = jax.tree_util.tree_map(
        lambda a: a + r.standard_normal(a.shape).astype(np.float32) * 0.02, jm.params)
    jm.params["lm"]["wte"] = jm.params["lm"]["wte"].at[jm.lm_config.vocab_size:].set(0)
    sd = to_torch_state_dict(jm.params, jm.state, jm.lm_config, jm.prefix_config)
    path = tmp_path / "mp_rank_00_model_states.pt"
    torch.save({"module": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    tm = TMagma.from_checkpoint(TConfig(**_mm_config_kwargs("flash")), path, device="cpu")
    jm.quantize_for_serving(4)
    tm.quantize_for_serving(4)
    assert tm.params["lm"]["blocks"]["attn"]["in_proj"]["q4"].dtype == torch.int8
    assert "fused" in tm.params["lm"]["blocks"]["adapter_mlp"]
    img = Image.fromarray(np.random.default_rng(7).integers(0, 256, (48, 80, 3), dtype=np.uint8))
    emb = np.asarray(jm.preprocess_inputs([img, "Describe the painting:"]))
    ref = jm.generate(jnp.asarray(emb), max_steps=16, temperature=0.0, decode=False)
    got = tm.generate(torch.from_numpy(np.array(emb, np.float32)), max_steps=16,
                      temperature=0.0, decode=False)
    np.testing.assert_array_equal(got, np.asarray(ref))
