"""The port's int8 ops (``magma_tpu_torch/ops/quant.py``) against the JAX
package's, same numpy-seeded inputs, on the CPU.

The JAX side runs its non-TPU fallbacks (as ``tests/test_quant.py`` runs
it); the port's public entries run their plain versions on CPU tensors.

* Quantisation is byte-identical: ``q`` and ``s`` equal.
* The int8 products agree at an fp32 tolerance: the JAX fallback computes
  x @ (W * s), the plain versions (x @ W) * s, both in fp32; the two differ
  by a few fp32 roundings, far below 1e-5 relative.
* The fused adapter at m <= 64 follows K5: int8 W exact, the scale on the
  fp32 product, h rounded to bf16.  JAX's fallback rounds W * s to bf16
  first (up to 2^-9 relative per weight), so the two agree to bf16 noise:
  2^-7 of the output's largest magnitude.  At m > 64 both run the same
  dequantising bf16 products: fp32 noise, except where an h on a bf16
  rounding boundary lands one ulp apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.models.adapters import AdapterSpec as JAdapterSpec
from magma_tpu.models.adapters import apply_adapter as japply_adapter
from magma_tpu.ops import quant as jq
from magma_tpu_torch.models.adapters import AdapterSpec as TAdapterSpec
from magma_tpu_torch.models.adapters import apply_adapter as tapply_adapter
from magma_tpu_torch.ops import quant as tq

RTOL, ATOL = 1e-5, 1e-5
L, K, N = 3, 256, 384
KO, KF = 256, 512


def _normal(shape, seed, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_pack(w):
    """The JAX package's int8 pack of w, as numpy."""
    p = jq.quantize_int8(jnp.asarray(w))
    return np.asarray(p["q"]), np.asarray(p["s"])


@pytest.mark.parametrize("shape", [(K, N), (L, K, N)], ids=["2d", "stacked"])
def test_quantize_int8_byte_identical(shape):
    w = _normal(shape, 0, 0.05)
    w[..., 0, 1] = 0.0  # a column of zeros below its max: scale from the clamp
    w[..., :, 2] = 0.0  # an all-zero column
    q, s = _jax_pack(w)
    got = tq.quantize_int8(_t(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), q)
    np.testing.assert_array_equal(got["s"].numpy(), s)


def test_quantize_int8_of_a_transposed_view_is_contiguous():
    """The head quantizes ``wte.T``: its pack comes back contiguous and
    equal to the pack of the copied transpose."""
    w = _normal((N, K), 1, 0.02)
    got = tq.quantize_int8(_t(w).T)
    assert got["q"].is_contiguous() and got["s"].is_contiguous()
    q, s = _jax_pack(np.ascontiguousarray(w.T))
    np.testing.assert_array_equal(got["q"].numpy(), q)
    np.testing.assert_array_equal(got["s"].numpy(), s)


def _adapter_weights(D=256, DH=128, seed=3):
    return (_normal((L, D, DH), seed, 0.1), _normal((L, DH), seed + 1, 0.1),
            _normal((L, DH, D), seed + 2, 0.1), _normal((L, D), seed + 3, 0.1))


@pytest.mark.parametrize("out_scale", [None, "scaled"])
def test_quantize_adapter_fused_byte_identical(out_scale):
    wd, bd, wu, bu = _adapter_weights()
    sc = None if out_scale is None else np.array([3.0, 0.5, -1.25], np.float32)
    ref = jq.quantize_adapter_fused(*map(jnp.asarray, (wd, bd, wu, bu)),
                                    out_scale=None if sc is None else jnp.asarray(sc))
    got = tq.quantize_adapter_fused(*map(_t, (wd, bd, wu, bu)),
                                    out_scale=None if sc is None else _t(sc))
    assert set(got) == set(ref) == {"wd", "sd", "bd", "wu", "su", "bu"}
    for k in ref:
        want = np.asarray(ref[k])
        assert got[k].dtype == (torch.int8 if want.dtype == np.int8 else torch.float32), k
        assert tuple(got[k].shape) == want.shape, k
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)


def test_quantize_adapter_fused_rejects_off_geometry():
    wd, bd, wu, bu = _adapter_weights(DH=64)
    assert tq.quantize_adapter_fused(*map(_t, (wd, bd, wu, bu))) is None


@pytest.mark.parametrize("m", [1, 5, 192])
@pytest.mark.parametrize("op", ["int8_matmul", "int8_matmul_stacked", "dual_matmul_stacked"])
def test_int8_products_match_jax(op, m):
    x = _normal((m, K), 10 + m)
    if op == "int8_matmul":
        q, s = _jax_pack(_normal((K, N), 1, 0.05))
        ref = [jq.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s))]
        got = [tq.int8_matmul(_t(x), _t(q), _t(s))]
    elif op == "int8_matmul_stacked":
        q, s = _jax_pack(_normal((L, K, N), 2, 0.05))
        ref = [jq.int8_matmul_stacked(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), i)
               for i in range(L)]
        got = [tq.int8_matmul_stacked(_t(x), _t(q), _t(s), i) for i in range(L)]
    else:  # the out_proj pack, as quantize_lm_params builds it
        h = _normal((m, KF), 20 + m)
        qo, so = _jax_pack(_normal((L, KO, N), 3, 0.05))
        qf, sf = _jax_pack(_normal((L, KF, N), 4, 0.05))
        w = {"q": np.concatenate([qo, qf], axis=1), "s": np.stack([so, sf], axis=1)}
        xo = _normal((m, KO), 30 + m)
        ref = [t for i in range(L) for t in jq.dual_matmul_stacked(
            jnp.asarray(xo), jnp.asarray(h), {k: jnp.asarray(v) for k, v in w.items()}, i)]
        got = [t for i in range(L) for t in tq.dual_matmul_stacked(
            _t(xo), _t(h), {k: _t(v) for k, v in w.items()}, i)]
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_out_dtype_and_leading_dims():
    q, s = _jax_pack(_normal((L, K, N), 2, 0.05))
    x = _normal((2, 3, K), 5)
    got = tq.int8_matmul_stacked(_t(x), _t(q), _t(s), 1, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, N)
    ref = np.asarray(jq.int8_matmul_stacked(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), 1,
                                            out_dtype=jnp.bfloat16).astype(jnp.float32))
    # both round the same fp32 product to bf16; a value on a rounding
    # boundary can land one bf16 ulp (2^-8 relative) apart
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("m", [1, 7, 64, 65, 160])
def test_fused_adapter_matches_jax(m):
    wd, bd, wu, bu = _adapter_weights()
    sc = np.array([3.0, 0.5, -1.25], np.float32)
    jfz = jq.quantize_adapter_fused(*map(jnp.asarray, (wd, bd, wu, bu)), out_scale=jnp.asarray(sc))
    tfz = tq.quantize_adapter_fused(*map(_t, (wd, bd, wu, bu)), out_scale=_t(sc))
    x = _normal((m, 256), 40 + m)
    for i in range(L):
        ref = np.asarray(jq.fused_adapter_stacked(jnp.asarray(x), jfz, i))
        got = tq.fused_adapter_stacked(_t(x), tfz, i)
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        # bf16 noise at m <= 64 (measured up to 5e-3 of the max); at m > 64
        # fp32 noise plus the rare h that lands one bf16 ulp apart
        rel = 2.0 ** -7 if m <= tq.FUSED_ADAPTER_MAX_ROWS else 2.0 ** -12
        atol = rel * np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol, err_msg=f"layer {i}")


def test_fused_adapter_plain_is_the_kernel_function():
    """At m <= 64 the plain version follows K5 exactly: x and h rounded to
    bf16, int8 weights exact, scales and biases on the fp32 products."""
    wd, bd, wu, bu = _adapter_weights()
    fz = tq.quantize_adapter_fused(*map(_t, (wd, bd, wu, bu)))
    x = _t(_normal((4, 256), 50))
    got = tq.fused_adapter_stacked_plain(x, fz, 2)
    xb = x.to(torch.bfloat16).double()
    h = torch.relu(xb @ fz["wd"][2].double() * fz["sd"][2, 0].double() + fz["bd"][2, 0].double())
    h = h.float().to(torch.bfloat16).double()
    want = h @ fz["wu"][2].double() * fz["su"][2, 0].double() + fz["bu"][2, 0].double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fused_adapter_without_its_layer_raises(pkg):
    """A stacked payload that arrives without its layer index must fail,
    not run layer 0's adapter in every layer."""
    wd, bd, wu, bu = _adapter_weights()
    x = _normal((1, 4, 256), 60)
    if pkg == "jax":
        fz = jq.quantize_adapter_fused(*map(jnp.asarray, (wd, bd, wu, bu)))
        with pytest.raises(KeyError):
            japply_adapter({"fused": fz}, JAdapterSpec("normal", 2), jnp.asarray(x), jnp.asarray(x))
    else:
        fz = tq.quantize_adapter_fused(*map(_t, (wd, bd, wu, bu)))
        with pytest.raises(KeyError):
            tapply_adapter({"fused": fz}, TAdapterSpec("normal", 2), _t(x), _t(x))


def test_int4_dual_payload_raises():
    """An int4 dual payload (q4) no longer raises: off the W4A8 geometry
    (Ko = 256 packs with group 128) both packages take the dequantising
    fp32 products, so a and m agree with JAX's to fp32 noise.  The W4A8
    geometry is held in tests/test_torch_int4.py."""
    qo = jq.quantize_int4(jnp.asarray(_normal((L, KO, N), 3, 0.05)))
    qf = jq.quantize_int4(jnp.asarray(_normal((L, KF, N), 4, 0.05)))
    w = {k: np.concatenate([np.asarray(qo[k]), np.asarray(qf[k])], axis=1) for k in ("q4", "s4")}
    ctx, h = _normal((2, KO), 5), _normal((2, KF), 6)
    for i in range(L):
        ref = jq.dual_matmul_stacked(jnp.asarray(ctx), jnp.asarray(h),
                                     {k: jnp.asarray(v) for k, v in w.items()}, i)
        got = tq.dual_matmul_stacked(_t(ctx), _t(h), {k: _t(v) for k, v in w.items()}, i)
        for g, r in zip(got, ref):
            assert g.dtype == torch.float32 and tuple(g.shape) == (2, N)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kernel", ["int8_matmul", "int8_matmul_stacked", "dual", "fused_adapter",
                                    "int4_matmul_stacked", "int4_dual", "boundary"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The wrappers launch or raise: a CPU tensor never reaches a plain
    version through them, and no launch is counted."""
    q, s = _jax_pack(_normal((L, K, N), 2, 0.05))
    x = _t(_normal((1, K), 7)).to(torch.bfloat16)
    calls = {
        "int8_matmul": (tq.int8_matmul_kernel, lambda: tq.int8_matmul_kernel(x, _t(q[0]), _t(s[0]))),
        "int8_matmul_stacked": (tq.int8_matmul_stacked_kernel,
                                lambda: tq.int8_matmul_stacked_kernel(x, _t(q), _t(s), 1)),
        "dual": (tq.dual_matmul_kernel,
                 lambda: tq.dual_matmul_kernel(x, x, _t(q), _t(np.stack([s, s], 1)), 0)),
        "fused_adapter": (tq.fused_adapter_kernel, lambda: tq.fused_adapter_kernel(
            x, tq.quantize_adapter_fused(*map(_t, _adapter_weights())), 0)),
    }
    q4 = tq.quantize_int4(_t(_normal((L, 512, N), 8, 0.05)))
    x4 = torch.zeros((1, 512), dtype=torch.bfloat16)
    dual4 = {k: torch.cat([v, v], dim=1) for k, v in q4.items()}
    vec = torch.zeros((L, 512))
    calls.update({
        "int4_matmul_stacked": (tq.int4_matmul_stacked_kernel,
                                lambda: tq.int4_matmul_stacked_kernel(x4, q4["q4"], q4["s4"], 1)),
        "int4_dual": (tq.int4_dual_kernel,
                      lambda: tq.int4_dual_kernel(x4, x4, dual4["q4"], dual4["s4"], 0)),
        "boundary": (tq.boundary_kernel, lambda: tq.boundary_kernel(
            x4, x4, x4, dual4, vec, vec, vec, 0)),
    })
    fn, call = calls[kernel]
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert fn.launches == before
