"""The port's int8 KV cache and whole-layer decode (K7, K8) against the JAX
package's, on the CPU.

Inputs are numpy-seeded.  The JAX side runs as its own tests run it on the
CPU: ``decode_layer_fused`` and ``decode_all_layers_fused`` take their
oracles ``_declayer_ref`` and ``_all_layers_ref``; the port's public
entries take their plain versions on CPU tensors.

* The int8 cache's bytes (``_quantize_kv``, ``init_kv_cache``,
  ``_write_cache``) equal those of JAX's jitted functions, where XLA turns
  the division by 127 into a product with fp32(1/127).
* K7 and K8's plain versions follow JAX's oracles op for op.  At
  ``tests/test_decode_layer.py``'s tiny widths (head_dim 32, group 64: both
  packages W4A16 or W8A16) and without adapters they agree within one bf16
  ulp of each output's largest magnitude: the fp32 products sum in XLA's
  order and PyTorch's, so a sum on a bf16 rounding boundary may land one
  ulp apart (most cases are bit-identical); k_new and v_new are equal.
  With the fused adapters the port computes K5's function where JAX's CPU
  fallback rounds W s to bf16 (2^-9 relative per weight), which can move
  an adapter output across a bf16 rounding boundary and carry into y, u
  and the next fused (measured up to 1.23 bf16 ulps of the largest
  value): each output within 2^-6 of its largest magnitude (two ulps).
  At d_model 512 with two heads of 256 the port computes W4A8 and JAX
  W4A16: within 4% of each output's largest magnitude, the tolerance
  ``test_torch_int4.py`` gives the boundary for the activation rounding.
* The fused decode agrees with the per-layer and boundary decodes within
  JAX's own bounds for that comparison (``test_decode_layer.py:92-107``):
  logits within 3e-2 relative, argmax equal, new cache entries within
  3e-2 of their largest magnitude.
* Greedy tokens over an int8 cache are identical to JAX's.
"""

import dataclasses
import functools

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
from magma_tpu.ops import attention as jattn
from magma_tpu.ops import decode_layer as jdl
from magma_tpu.ops.sampling import generate_tokens as jgenerate
from magma_tpu.training.torch_convert import to_torch_state_dict
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import from_jax_params
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models.adapters import AdapterSpec as TAdapterSpec
from magma_tpu_torch.models.magma import Magma as TMagma
from magma_tpu_torch.ops import attention as tattn
from magma_tpu_torch.ops import decode_layer as tdl
from magma_tpu_torch.ops.rotary import rotary_sincos
from magma_tpu_torch.ops.sampling import generate_tokens as tgenerate

BF16 = jnp.bfloat16
TINY = dict(n_layers=2, n_heads=4, d_model=128, d_ff=256, rotary_dim=16)
W4A8 = dict(n_layers=2, n_heads=2, d_model=512, d_ff=2048, rotary_dim=16)
ONE_ULP = 2.0 ** -7      # one bf16 ulp of each output's largest magnitude
ADAPTER_TOL = 2.0 ** -6  # two (see the docstring)
W4A8_TOL = 0.04
MAX_LEN = 64


def _normal(shape, seed, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _j(t):
    """A port tensor as a JAX array of the same dtype."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(BF16)
    return jnp.asarray(t.numpy())


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, ref, rel, msg=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, msg
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max(), err_msg=msg)


# ---------------------------------------------------------------------------
# (a) the int8 cache's bytes
# ---------------------------------------------------------------------------


def test_quantize_kv_bytes_are_the_jitted_jax_bytes():
    """On the tensor where the eager and the jitted JAX bytes differ."""
    x = jnp.asarray(_normal((2, 1, 4096, 4, 256), 0)).astype(BF16)
    jq, js = jax.jit(jgptj._quantize_kv)(x)
    tq, ts = tgptj._quantize_kv(torch.from_numpy(np.array(x.astype(jnp.float32)))
                                .to(torch.bfloat16))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == (2, 1, 4, 4096)  # position-minor
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js.astype(jnp.float32)))
    eager_q, _ = jgptj._quantize_kv(x)
    assert not np.array_equal(np.asarray(eager_q), np.asarray(jq))  # the recipe matters


def test_init_kv_cache_int8_layout_matches_jax():
    jcfg = jgptj.GPTJConfig.tiny(**TINY, kv_cache_dtype="int8")
    tcfg = tgptj.GPTJConfig.tiny(**TINY, kv_cache_dtype="int8")
    want, got = jgptj.init_kv_cache(jcfg, 3, 64), tgptj.init_kv_cache(tcfg, 3, 64)
    assert got.keys() == want.keys() == {"k", "v", "k_scale", "v_scale"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tgptj.init_kv_cache(dataclasses.replace(tcfg, kv_cache_dtype="fp8"), 1, 64)


@pytest.mark.parametrize("s", [1, 5], ids=["decode", "prefill"])
@pytest.mark.parametrize("index", ["scalar", "per_row"])
def test_write_cache_int8_bytes_match_jitted_jax(index, s):
    cfg = tgptj.GPTJConfig.tiny(**TINY, kv_cache_dtype="int8")
    b = 3
    cache = tgptj.init_kv_cache(cfg, b, 64)
    first = {k: torch.from_numpy(_normal((2, b, 8, 4, 32), i)).to(torch.bfloat16)
             for i, k in enumerate("kv")}
    tgptj._write_cache(cache, first["k"], first["v"], 0)  # a history to write over
    jcache = {k: _j(v) for k, v in cache.items()}
    new = {k: torch.from_numpy(_normal((2, b, s, 4, 32), 10 + i)).to(torch.bfloat16)
           for i, k in enumerate("kv")}
    idx = [7] * b if index == "scalar" else [7, 0, 30]
    t_idx = 7 if index == "scalar" else torch.tensor(idx)
    j_idx = jnp.int32(7) if index == "scalar" else jnp.asarray(idx, jnp.int32)
    want = jax.jit(jgptj._write_cache)(jcache, _j(new["k"]), _j(new["v"]), j_idx)
    got = tgptj._write_cache(cache, new["k"], new["v"], t_idx)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k].astype(jnp.float32)),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# (b) decode attention over an int8 cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cur_len", ["per_row", "scalar"])
def test_decode_attention_int8_cache_matches_jax(cur_len):
    """The softmax weights round to q's dtype (bf16) and the cache part is
    multiplied by v_scale in bf16 in both; the products accumulate in fp32
    in the port and in XLA's own order in JAX, and both round the output to
    bf16 once: one bf16 ulp (2^-7 relative) of the largest value."""
    b, h, hd = 2, 4, 32
    q = torch.from_numpy(_normal((b, 1, h, hd), 0)).to(torch.bfloat16)
    k_self, v_self = (torch.from_numpy(_normal((b, 1, h, hd), i)).to(torch.bfloat16)
                      for i in (1, 2))
    kq, ks = tgptj._quantize_kv(torch.from_numpy(_normal((1, b, MAX_LEN, h, hd), 3)))
    vq, vs = tgptj._quantize_kv(torch.from_numpy(_normal((1, b, MAX_LEN, h, hd), 4)))
    n = torch.tensor([37, 5]) if cur_len == "per_row" else torch.tensor(20)
    kw = dict(scale=hd ** -0.5)
    got = tattn.decode_attention(q, kq[0], vq[0], n, self_kv=(k_self, v_self),
                                 kv_scales=(ks[0], vs[0]), **kw)
    want = jattn.decode_attention(_j(q), _j(kq[0]), _j(vq[0]), _j(n),
                                  self_kv=(_j(k_self), _j(v_self)),
                                  kv_scales=(_j(ks[0]), _j(vs[0])), **kw)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2.0 ** -7)


# ---------------------------------------------------------------------------
# (c) K7's and K8's plain versions against JAX's oracles
# ---------------------------------------------------------------------------

RECIPES = {
    "none": (None, None),
    "v1": (dict(adapter_type="normal"), None),
    "scaled_attn_normal_mlp": (dict(adapter_type="normal"),
                               dict(adapter_type="scaled_parallel")),
}


@functools.lru_cache(maxsize=None)
def _pair(fmt, lm_name, recipe):
    """(jcfg, tcfg, JAX tree, port tree) quantized to ``fmt`` from the same
    weights; the adapters' hidden width is 128 (fused) at both sizes."""
    lm = TINY if lm_name == "tiny" else W4A8
    mlp, attn = RECIPES[recipe]
    ds = lm["d_model"] // 128
    kw = {}
    for name, spec in (("mlp_adapter", mlp), ("attn_adapter", attn)):
        if spec is not None:
            kw[name] = dict(spec, downsample_factor=ds)
    jcfg = jgptj.GPTJConfig.tiny(
        **lm, compute_dtype=BF16, param_dtype=jnp.float32,
        **{k: JAdapterSpec(**v) for k, v in kw.items()})
    tcfg = tgptj.GPTJConfig.tiny(
        **lm, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
        **{k: TAdapterSpec(**v) for k, v in kw.items()})
    p = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(0), jcfg))
    r = np.random.default_rng(0)
    blocks = p["blocks"]
    for key in ("adapter_mlp", "adapter_attn"):  # near-zero init hides bugs
        if key in blocks:
            blocks[key] = jax.tree_util.tree_map(
                lambda a: (a + r.standard_normal(a.shape) * 0.05).astype(np.float32), blocks[key])
    if "scale" in blocks.get("adapter_attn", {}):
        blocks["adapter_attn"]["scale"] = np.array([1.5, -0.75], np.float32)
    blocks["ln_1"]["scale"] = (1 + r.standard_normal(blocks["ln_1"]["scale"].shape)
                               * 0.1).astype(np.float32)
    for tree, key in ((blocks["attn"], "o_bias"), (blocks["mlp"]["fc_in"], "bias"),
                      (blocks["mlp"]["fc_out"], "bias")):
        tree[key] = (tree[key] + r.standard_normal(tree[key].shape) * 0.02).astype(np.float32)
    tp = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"]
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    if fmt == "int4":
        return jcfg, tcfg, jgptj.quantize_lm_params_int4(jp), tgptj.quantize_lm_params_int4(tp)
    return jcfg, tcfg, jgptj.quantize_lm_params(jp), tgptj.quantize_lm_params(tp)


def _caches(cfg, kv, seed):
    """A filled (L, 1, MAX_LEN, h, hd) cache, bf16 or int8 (codes and
    scales through ``_quantize_kv``): (k, v, kv_scales or None)."""
    shape = (cfg.n_layers, 1, MAX_LEN, cfg.n_heads, cfg.head_dim)
    k, v = (torch.from_numpy(_normal(shape, seed + i)).to(torch.bfloat16) for i in (0, 1))
    if kv == "bf16":
        return k, v, None
    (kq, ks), (vq, vs) = tgptj._quantize_kv(k), tgptj._quantize_kv(v)
    return kq, vq, (ks, vs)


def _layer_inputs(fmt, lm_name, recipe, kv, pos):
    jcfg, tcfg, jp, tp = _pair(fmt, lm_name, recipe)
    D, F = tcfg.d_model, tcfg.d_ff
    rows = {"fused": (3 * D + F, 1.0), "x": (D, 0.3), "u": (D, 1.0)}
    ins = {k: torch.from_numpy(_normal((1, n), 20 + i, std)).to(torch.bfloat16)
           for i, (k, (n, std)) in enumerate(rows.items())}
    ins["b_fc_in"] = torch.from_numpy(_normal((tcfg.n_layers, F), 30, 0.1))
    kc, vc, kvs = _caches(tcfg, kv, 40)
    adapters = {}
    for name, spec, key in (("attn", tcfg.attn_adapter, "adapter_attn"),
                            ("mlp", tcfg.mlp_adapter, "adapter_mlp")):
        src = "out" if spec is None or spec.adapter_type == "normal" else "in"
        adapters[name] = (key if spec is not None else None, src)

    def call(pkg):
        tree = jp if pkg == "jax" else tp
        conv = _j if pkg == "jax" else (lambda t: t)
        b = tree["blocks"]
        kw = dict(n_heads=tcfg.n_heads, scale=tcfg.head_dim ** -0.5, ln_eps=tcfg.ln_eps,
                  o_bias=b["bvecs"]["o_bias"])
        for name, (key, src) in adapters.items():
            kw[f"fz_{name}"] = None if key is None else b[key]["fused"]
            kw[f"{name}_src"] = src
        if pkg == "jax":
            rot = jdl.rotary_matrix(jnp.array([pos]), tcfg.rotary_dim, tcfg.head_dim)
            scales = None if kvs is None else tuple(_j(s).swapaxes(-1, -2) for s in kvs)
            idx = jnp.int32(pos)
        else:
            rot = rotary_sincos(torch.tensor([pos]), tcfg.rotary_dim)
            scales, idx = kvs, pos
        common = (rot, conv(kc), conv(vc), scales, idx)
        return b, kw, common, conv

    return tcfg, ins, call


CASES = {  # layer, w_in, pos
    "layer0_w_in": (0, True, 37),
    "last_layer": (1, False, 37),
    "pos0_w_in": (0, True, 0),
}


def _k7(pkg, call, ins, layer, w_in):
    b, kw, (rot, kc, vc, scales, idx), conv = call(pkg)
    fn = jdl.decode_layer_fused if pkg == "jax" else tdl.decode_layer_fused
    bv = b["bvecs"]
    return fn(conv(ins["fused"]), conv(ins["x"]), rot, kc, vc, scales, idx, b["attn"]["out_proj"],
              conv(ins["b_fc_in"]), bv["b_fc_out"], bv["ln_g"], bv["ln_b"], layer,
              w_in=b["attn"]["in_proj"] if w_in else None, u_in=conv(ins["u"]), **kw)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_layer_plain_matches_jax_tiny(fmt, kv, recipe, case):
    layer, w_in, pos = CASES[case]
    _, ins, call = _layer_inputs(fmt, "tiny", recipe, kv, pos)
    want = _k7("jax", call, ins, layer, w_in)
    got = _k7("torch", call, ins, layer, w_in)
    assert len(got) == len(want) == (5 if w_in else 4)
    names = ("y", "u", "fused", "k_new", "v_new") if w_in else ("y", "u", "k_new", "v_new")
    for g, w, name in zip(got, want, names):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape, name
        if name in ("k_new", "v_new"):
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
        else:
            _close(g, w, ONE_ULP if recipe == "none" else ADAPTER_TOL, name)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_layer_plain_matches_jax_w4a8_width(fmt, kv):
    """d_model 512, two heads of 256: the kernels' W4A8 geometry for int4."""
    _, ins, call = _layer_inputs(fmt, "w4a8", "scaled_attn_normal_mlp", kv, 37)
    want = _k7("jax", call, ins, 0, True)
    got = _k7("torch", call, ins, 0, True)
    for g, w, name in zip(got, want, ("y", "u", "fused", "k_new", "v_new")):
        _close(g, w, W4A8_TOL if fmt == "int4" else ADAPTER_TOL, name)


def _k8(pkg, call, ins):
    b, kw, (rot, kc, vc, scales, idx), conv = call(pkg)
    fn = jdl.decode_all_layers_fused if pkg == "jax" else tdl.decode_all_layers_fused
    bv = b["bvecs"]
    return fn(conv(ins["fused"]), conv(ins["x"]), conv(ins["u"]), rot, kc, vc, scales, idx,
              b["attn"]["out_proj"], b["attn"]["in_proj"], conv(ins["b_fc_in"]), bv["b_fc_out"],
              bv["ln_g"], bv["ln_b"], **kw)


@pytest.mark.parametrize("pos", [37, 0])
@pytest.mark.parametrize("recipe", ["v1", "scaled_attn_normal_mlp"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_all_layers_plain_matches_jax(fmt, kv, recipe, pos):
    """K8 over both layers: the adapter difference of one layer carried
    through the next (measured within the one-layer tolerance)."""
    _, ins, call = _layer_inputs(fmt, "tiny", recipe, kv, pos)
    want = _k8("jax", call, ins)
    got = _k8("torch", call, ins)
    assert tuple(got[1].shape) == (2, 1, 128)
    for g, w, name in zip(got, want, ("y", "k_new", "v_new")):
        assert g.dtype == torch.bfloat16, name
        _close(g, w, ADAPTER_TOL, name)
    # layer 0's k/v rows come before any adapter: the same bits
    np.testing.assert_array_equal(_np(got[1][0]), _np(want[1][0]))
    np.testing.assert_array_equal(_np(got[2][0]), _np(want[2][0]))


# ---------------------------------------------------------------------------
# (d) the fused decode step against JAX's; (e) against the port's own decodes
# ---------------------------------------------------------------------------


def _step_inputs(tcfg, kv):
    kc, vc, kvs = _caches(tcfg, kv, 50)
    cache = {"k": kc, "v": vc}
    if kvs is not None:
        cache.update(k_scale=kvs[0], v_scale=kvs[1])
    x = torch.from_numpy(_normal((1, 1, tcfg.d_model), 60, 0.1)).to(torch.bfloat16)
    return cache, x


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-9)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_run_decode_fused_layers_matches_jax(fmt, kv):
    """The step as JAX's own test calls it (``_run_decode_fused_layers``
    directly): hidden state and the cache written at position idx."""
    jcfg, tcfg, jp, tp = _pair(fmt, "tiny", "scaled_attn_normal_mlp")
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
    cache, x = _step_inputs(tcfg, kv)
    idx = 9
    jcache = {k: _j(v) for k, v in cache.items()}
    jh, jc = jgptj._run_decode_fused_layers(jcfg, jp["blocks"], _j(x),
                                            jnp.full((1, 1), idx, jnp.int32), jcache,
                                            jnp.int32(idx))
    th, kn, vn = tgptj._run_decode_fused_layers(tcfg, tp["blocks"], x,
                                                torch.full((1, 1), idx), cache,
                                                torch.tensor(idx))
    tc = tgptj._write_cache(cache, kn, vn, idx)
    _close(th, jh, ADAPTER_TOL, "hidden")
    for name in jc:
        at = (slice(None), slice(None), idx) if name in ("k", "v") else (..., idx)
        # int8 codes: one code step of the row's largest value on a rounding flip
        _close(tc[name][at], jc[name][at], ADAPTER_TOL if kv == "bf16" else 2 / 127, name)


def _per_layer_vs_fused(tcfg, tp, kv):
    """Logits of one decode step through ``forward``'s per-layer or
    boundary path and through ``_run_decode_fused_layers``, and the new
    cache entries of each."""
    cache, x = _step_inputs(tcfg, kv)
    idx = 9
    old, old_cache = tgptj.forward(tcfg, tp, x, cache={k: v.clone() for k, v in cache.items()},
                                   cache_index=idx)
    h, kn, vn = tgptj._run_decode_fused_layers(tcfg, tp["blocks"], x, torch.full((1, 1), idx),
                                               cache, torch.tensor(idx))
    new_cache = tgptj._write_cache(cache, kn, vn, idx)
    new = tgptj.lm_head(tcfg, tp, tgptj._layer_norm(h, tp["ln_f"], tcfg.ln_eps,
                                                    tcfg.compute_dtype))
    return old, new, old_cache, new_cache, idx


def _check_jax_bounds(old, new, old_cache, new_cache, idx):
    """``tests/test_decode_layer.py:92-107``."""
    a, b = _np(old[:, -1]), _np(new[:, -1])
    assert np.abs(a - b).max() / (np.abs(a).max() + 1e-9) < 3e-2
    assert a.argmax(-1).tolist() == b.argmax(-1).tolist()
    for name in old_cache:
        at = (slice(None), slice(None), idx) if name in ("k", "v") else (..., idx)
        co, cn = _np(old_cache[name][at]), _np(new_cache[name][at])
        assert np.abs(co - cn).max() / (np.abs(co).max() + 1e-6) < 3e-2, name


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_fused_decode_matches_the_per_layer_decode(fmt, kv):
    """At the tiny widths the gate refuses the fused path, so ``forward``
    takes the boundary (int4) or per-layer (int8) decode: against the fused
    composition, called directly as JAX's test calls it."""
    _, tcfg, _, tp = _pair(fmt, "tiny", "scaled_attn_normal_mlp")
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    cache, x = _step_inputs(tcfg, kv)
    assert not tgptj._declayer_ok(tcfg, tp["blocks"], x, cache)
    _check_jax_bounds(*_per_layer_vs_fused(tcfg, tp, kv))


@functools.lru_cache(maxsize=None)
def _gated_lm(fmt):
    """A port-only LM at the kernels' geometry (8 heads of 256, d_model and
    d_ff 2048, 2 layers, the v1 adapter): ``forward`` takes the fused path."""
    tcfg = tgptj.GPTJConfig.tiny(n_layers=2, n_heads=8, d_model=2048, d_ff=2048, rotary_dim=64,
                                 param_dtype=torch.float32,
                                 mlp_adapter=TAdapterSpec("normal", 16))
    g = torch.Generator().manual_seed(0)
    p = tgptj.init_params(g, tcfg)
    for proj in ("down", "up"):  # trained-scale adapters so they matter
        ad = p["blocks"]["adapter_mlp"][proj]
        ad["kernel"] = torch.randn(ad["kernel"].shape, generator=g) * 0.05
    quant = tgptj.quantize_lm_params_int4 if fmt == "int4" else tgptj.quantize_lm_params
    return tcfg, quant(p)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_forward_takes_the_fused_path_at_the_kernel_geometry(fmt, kv):
    """On the CPU, as on the card: the gate holds, ``forward``'s decode step
    is the fused one, and it agrees with the same step through the
    per-layer path (no "bvecs") within JAX's bounds."""
    tcfg, tp = _gated_lm(fmt)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    cache, x = _step_inputs(tcfg, kv)
    assert tgptj._declayer_ok(tcfg, tp["blocks"], x, cache)
    fused, fused_cache = tgptj.forward(tcfg, tp, x, cache={k: v.clone() for k, v in cache.items()},
                                       cache_index=9)
    bv = tp["blocks"].pop("bvecs")
    try:
        assert not tgptj._declayer_ok(tcfg, tp["blocks"], x, cache)
        per_layer, per_layer_cache = tgptj.forward(tcfg, tp, x, cache=cache, cache_index=9)
    finally:
        tp["blocks"]["bvecs"] = bv
    _check_jax_bounds(per_layer, fused, per_layer_cache, fused_cache, 9)


# ---------------------------------------------------------------------------
# (f) greedy tokens over an int8 cache, identical to JAX's
# ---------------------------------------------------------------------------


def test_greedy_tokens_over_an_int8_cache_identical_to_jax():
    """bf16 weights, fp32 compute: the per-layer decode over the int8 cache
    through ``generate_tokens`` in both packages."""
    lm = dict(TINY, d_ff=512)
    jcfg = jgptj.GPTJConfig.tiny(**lm, compute_dtype=jnp.float32, param_dtype=jnp.float32,
                                 kv_cache_dtype="int8")
    tcfg = tgptj.GPTJConfig.tiny(**lm, compute_dtype=torch.float32, param_dtype=torch.float32,
                                 kv_cache_dtype="int8")
    p = jax.tree_util.tree_map(np.asarray, jgptj.init_params(jax.random.PRNGKey(0), jcfg))
    tp = from_jax_params({"lm": p, "image_prefix": {}}, None, tcfg, None)[0]["lm"]
    x = _normal((1, 24, 128), 3)
    ref, _ = jgenerate(jcfg, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                       jax.random.PRNGKey(0), max_steps=16, temperature=0.0)
    got, steps = tgenerate(tcfg, tp, torch.from_numpy(x), None, max_steps=16, temperature=0.0)
    assert steps == 16
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


ENC = dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)


def _mm_config_kwargs(impl):
    return dict(
        batch_size=2, train_steps=4, encoder_name="clip_resnet_large",
        adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 1}},
        use_image_embed_layernorm=True, image_embed_dropout_prob=0.1,
        # one head of 128: the port's flash kernel takes head_dim % 128 == 0
        lm_overrides=dict(n_layers=2, n_heads=1, d_model=128, d_ff=512, rotary_dim=16,
                          max_seq_len=128, attention_impl=impl, kv_cache_dtype="int8"),
        image_size=64, compute_dtype="float32", param_dtype="float32",
        frozen_dtype="float32", attention_impl=impl, encoder_overrides=ENC)


def _served_facade_pair(bits, tmp_path):
    """(JAX Magma, port Magma) from one checkpoint, both after
    ``quantize_for_serving(bits)``, and the embeddings of one request."""
    jm = JMagma(JConfig(**_mm_config_kwargs("xla")), rng=0)
    r = np.random.default_rng(0)
    jm.params = jax.tree_util.tree_map(
        lambda a: a + r.standard_normal(a.shape).astype(np.float32) * 0.02, jm.params)
    jm.params["lm"]["wte"] = jm.params["lm"]["wte"].at[jm.lm_config.vocab_size:].set(0)
    sd = to_torch_state_dict(jm.params, jm.state, jm.lm_config, jm.prefix_config)
    path = tmp_path / "mp_rank_00_model_states.pt"
    torch.save({"module": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    tm = TMagma.from_checkpoint(TConfig(**_mm_config_kwargs("flash")), path, device="cpu")
    assert tm.lm_config.kv_cache_dtype == jm.lm_config.kv_cache_dtype == "int8"
    jm.quantize_for_serving(bits)
    tm.quantize_for_serving(bits)
    img = Image.fromarray(np.random.default_rng(7).integers(0, 256, (48, 80, 3), dtype=np.uint8))
    return jm, tm, np.asarray(jm.preprocess_inputs([img, "Describe the painting:"]))


@pytest.mark.parametrize("bits", [4, 8])
def test_facade_greedy_tokens_over_an_int8_cache_identical_to_jax(bits, tmp_path):
    jm, tm, emb = _served_facade_pair(bits, tmp_path)
    ref = jm.generate(jnp.asarray(emb), max_steps=16, temperature=0.0, decode=False)
    got = tm.generate(torch.from_numpy(np.array(emb, np.float32)), max_steps=16,
                      temperature=0.0, decode=False)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("bits", [4, 8])
def test_greedy_eos_exit_over_an_int8_cache_identical_to_jax(bits, tmp_path):
    """EOS forced at the last step before ``max_steps`` at which greedy
    decoding first emits some token: the port's loop stops where JAX's does,
    with the same tokens and ``steps``, both where it reads its flag one step
    late (int4: a decode step is one K6 launch a layer) and where it reads
    the flag first (int8 at head_dim 128: the per-layer chain)."""
    jm, tm, emb = _served_facade_pair(bits, tmp_path)
    jlm = jax.tree_util.tree_map(jnp.asarray, jm.params["lm"])
    tlm, x = tm.params["lm"], torch.from_numpy(np.array(emb, np.float32))
    cache = tgptj.init_kv_cache(tm.lm_config, 1, 64)
    fused = tgptj.fused_decode(tm.lm_config, tlm["blocks"], x[:, :1], cache)
    assert fused == ("boundary" if bits == 4 else None)

    def both(eos):
        ref, ref_steps = jgenerate(jm.lm_config, jlm, jnp.asarray(emb), jax.random.PRNGKey(0),
                                   max_steps=16, temperature=0.0, eos_token=eos)
        got, steps = tgenerate(tm.lm_config, tlm, x, None, max_steps=16, temperature=0.0,
                               eos_token=eos)
        return np.asarray(ref), int(ref_steps), got.numpy(), steps

    _, _, row, _ = both(-1)
    row = row[0].tolist()
    k = max(i for i in range(1, 15) if row[i] not in row[:i])
    ref, ref_steps, got, steps = both(row[k])
    assert steps == ref_steps == k + 1
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# (g) guards and gate
# ---------------------------------------------------------------------------


def _guard_call(layer_idx, w_in):
    _, ins, call = _layer_inputs("int4", "tiny", "v1", "bf16", 5)
    return _k7("torch", call, ins, layer_idx, w_in)


def test_decode_layer_refuses_w_in_on_the_last_layer():
    with pytest.raises(ValueError, match="last layer"):
        _guard_call(1, True)


@pytest.mark.parametrize("idx", [0.0, torch.tensor(0.0), torch.tensor([0]), "0"],
                         ids=["float", "0d_float", "1d", "str"])
def test_decode_layer_refuses_a_non_integer_layer(idx):
    with pytest.raises(ValueError, match="concrete integer layer_idx"):
        _guard_call(idx, True)


@pytest.mark.parametrize("idx", [np.int64(0), torch.tensor(0)], ids=["np_int64", "0d"])
def test_decode_layer_takes_any_integer_layer(idx):
    assert len(_guard_call(idx, True)) == 5


def _payloads(fmt, D, F, L=2):
    if fmt == "int4":
        return ({"q4": torch.zeros((L, D // 2, 3 * D + F), dtype=torch.int8),
                 "s4": torch.zeros((L, D // 256, 3 * D + F))},
                {"q4": torch.zeros((L, (D + F) // 2, D), dtype=torch.int8),
                 "s4": torch.zeros((L, (D + F) // 256, D))})
    return ({"q": torch.zeros((L, D, 3 * D + F), dtype=torch.int8),
             "s": torch.zeros((L, 3 * D + F))},
            {"q": torch.zeros((L, D + F, D), dtype=torch.int8), "s": torch.zeros((L, 2, D))})


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_declayer_supported_gate(fmt):
    w_in, w_out = _payloads(fmt, 4096, 16384)
    kw = dict(b=1, s=1, n_heads=16, head_dim=256, d_ff=16384, max_len=256, w_in_proj=w_in,
              w_out_proj=w_out, has_bvecs=True)
    assert tdl.declayer_supported(**kw)  # GPT-J 6B at the slice's cache
    assert not tdl.declayer_supported(**dict(kw, b=2))
    assert not tdl.declayer_supported(**dict(kw, max_len=200))
    assert not tdl.declayer_supported(**dict(kw, has_bvecs=False))
    w_in, w_out = _payloads(fmt, 4096, 16384)
    assert not tdl.declayer_supported(**dict(kw, n_heads=32, head_dim=128))
    other = _payloads("int8" if fmt == "int4" else "int4", 4096, 16384)[0]
    assert not tdl.declayer_supported(**dict(kw, w_in_proj=other))
