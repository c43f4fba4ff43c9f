"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode).  The file imports no jax, so on a machine with a GPU and
without jax it runs apart from tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from magma_tpu_torch.ops import quant
from magma_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                 flash_attention_kernel,
                                                 flash_attention_plain)

pytestmark = pytest.mark.cuda

# bf16 kernel vs fp32 plain version on the same bf16 inputs.  O: both round
# to bf16 at the end and the kernel also rounds P before the PV product, so
# two fp32 values near a rounding boundary land one bf16 ulp apart (2^-7
# relative at most), plus an absolute floor for values near 0.  lse: fp32
# in both, another summation order.
O_ATOL, O_RTOL = 1e-2, 2.0 ** -7
LSE_ATOL = 1e-3

CASES = {
    "prefill_b1": dict(b=1, s_q=256, s_k=256, hd=256, kv_len=[149], q_offset=0),
    "fully_masked_row": dict(b=2, s_q=256, s_k=256, hd=256, kv_len=[149, 0], q_offset=0),
    "q_offset": dict(b=1, s_q=128, s_k=256, hd=256, kv_len=None, q_offset=128),
    "ragged_seq_hd128": dict(b=2, s_q=200, s_k=200, hd=128, kv_len=[200, 33], q_offset=0),
}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(dev, b, s_q, s_k, hd, seed=0, h=4):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal((b, s, h, hd), dtype=np.float32))
                 .to(dev, torch.bfloat16) for s in (s_q, s_k, s_k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(case, dev):
    c = CASES[case]
    q, k, v = _qkv(dev, c["b"], c["s_q"], c["s_k"], c["hd"])
    kv_len = (None if c["kv_len"] is None
              else torch.tensor(c["kv_len"], dtype=torch.int32, device=dev))
    kw = dict(scale=c["hd"] ** -0.5, causal=True, kv_len=kv_len, q_offset=c["q_offset"])
    before = flash_attention_kernel.launches
    o, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=O_ATOL, rtol=O_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    if case == "fully_masked_row":
        assert torch.all(o[1] == 0)


def test_kernel_reads_strided_inputs(dev):
    """(b, s, h, hd) views of a fused qkv buffer: no copy, same result."""
    qkv = torch.randn((1, 256, 3, 4, 256), device=dev, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o, lse = flash_attention_kernel(q, k, v, None, scale=1 / 16, causal=True, q_offset=0)
    ref_o, ref_lse = flash_attention_plain(q, k, v, scale=1 / 16, causal=True)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=O_ATOL, rtol=O_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("bad", ["fp32", "head_dim_384", "cpu_kv_len", "negative_offset"])
def test_kernel_raises_on_what_it_does_not_take(bad, dev):
    q, k, v = _qkv(dev, 1, 128, 128, 256)
    kv_len, q_offset = None, 0
    if bad == "fp32":
        q, k, v = q.float(), k.float(), v.float()
    elif bad == "head_dim_384":
        q, k, v = _qkv(dev, 1, 128, 128, 384)
    elif bad == "cpu_kv_len":
        kv_len = torch.tensor([5], dtype=torch.int32)
    else:
        q_offset = -1
    before = flash_attention_kernel.launches
    with pytest.raises((TypeError, ValueError, NotImplementedError)):
        flash_attention_kernel(q, k, v, kv_len, scale=1.0, causal=True, q_offset=q_offset)
    assert flash_attention_kernel.launches == before


def test_tiny_lm_prefill_kernel_vs_plain_path(dev):
    """A bf16 tiny GPT-J (one 128-wide head) on the GPU: the prefill through
    the kernel agrees with the einsum path to bf16 noise, and greedy decode
    runs through one kernel launch per layer."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops.sampling import generate_tokens

    cfg = gptj.GPTJConfig.tiny(n_heads=1, attention_impl="flash",
                               param_dtype=torch.bfloat16)
    params = gptj.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    emb = torch.randn((1, 40, cfg.d_model), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    logits = {}
    for impl in ("flash", "xla"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        logits[impl], _ = gptj.forward(c, params, emb)
    torch.testing.assert_close(logits["flash"], logits["xla"], atol=5e-2, rtol=0)
    before = flash_attention_kernel.launches
    tokens, steps = generate_tokens(cfg, params, emb, None, max_steps=6, temperature=0.0)
    assert flash_attention_kernel.launches == before + cfg.n_layers
    assert tokens.shape == (1, 6) and steps >= 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_small_launches_take_the_mma_body(case, dev):
    """CASES (4 heads, at most 2 blocks of 128 rows a head) stay on the
    mma.sync body, as the caption prefill does."""
    c = CASES[case]
    q, k, v = _qkv(dev, c["b"], c["s_q"], c["s_k"], c["hd"])
    kv_len = (None if c["kv_len"] is None
              else torch.tensor(c["kv_len"], dtype=torch.int32, device=dev))
    before = (flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches)
    flash_attention_fwd(q, k, v, scale=c["hd"] ** -0.5, causal=True, kv_len=kv_len,
                        q_offset=c["q_offset"])
    assert (flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches) == (
        before[0] + 1, before[1])


# K1's wgmma body (csrc/flash_attn_fwd_wgmma.cu), at shapes that
# flash_fwd_takes_wgmma sends to it (16 heads: at least 132 blocks of 128
# rows), against the same plain version and tolerances; "direct" cases call
# the wrapper on unpadded inputs (s not a multiple of 64)
WGMMA_CASES = {
    "causal_s2048_hd256": dict(b=1, s_q=2048, s_k=2048, hd=256),
    "causal_s2048_hd128_kv_len": dict(b=1, s_q=2048, s_k=2048, hd=128, kv_len=[1000]),
    "causal_s1024_hd256_kv_len": dict(b=2, s_q=1024, s_k=1024, hd=256, kv_len=[1024, 611]),
    "causal_s1024_hd128": dict(b=2, s_q=1024, s_k=1024, hd=128),
    "fully_masked_row_hd256": dict(b=2, s_q=1024, s_k=1024, hd=256, kv_len=[1024, 0]),
    "fully_masked_row_hd128": dict(b=2, s_q=1024, s_k=1024, hd=128, kv_len=[0, 77]),
    "q_offset_hd256": dict(b=2, s_q=960, s_k=1024, hd=256, q_offset=64),
    "q_offset_hd128_kv_len": dict(b=2, s_q=896, s_k=1024, hd=128, kv_len=[1024, 900],
                                  q_offset=128),
    "not_causal_hd256_kv_len": dict(b=2, s_q=1024, s_k=1024, hd=256, kv_len=[1024, 300],
                                    causal=False),
    "not_causal_hd128": dict(b=1, s_q=2048, s_k=1536, hd=128, causal=False),
    "direct_ragged_hd128": dict(b=2, s_q=1000, s_k=1000, hd=128, kv_len=[1000, 517],
                                direct=True),
    "direct_ragged_hd256_q_offset": dict(b=2, s_q=1000, s_k=1100, hd=256, q_offset=100,
                                         direct=True),
}


def _wgmma_case(dev, c, seed=11):
    q, k, v = _qkv(dev, c["b"], c["s_q"], c["s_k"], c["hd"], seed=seed, h=16)
    kv_len = (None if c.get("kv_len") is None
              else torch.tensor(c["kv_len"], dtype=torch.int32, device=dev))
    kw = dict(scale=c["hd"] ** -0.5, causal=c.get("causal", True), kv_len=kv_len,
              q_offset=c.get("q_offset", 0))
    return q, k, v, kw


def _fwd(q, k, v, kw, direct):
    if direct:
        return flash_attention_kernel(q, k, v, kw["kv_len"], scale=kw["scale"],
                                      causal=kw["causal"], q_offset=kw["q_offset"])
    return flash_attention_fwd(q, k, v, **kw)


@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_wgmma_body_matches_plain(case, dev):
    c = WGMMA_CASES[case]
    q, k, v, kw = _wgmma_case(dev, c)
    before = (flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches)
    o, lse = _fwd(q, k, v, kw, c.get("direct", False))
    torch.cuda.synchronize()
    assert (flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches) == (
        before[0] + 1, before[1] + 1)
    ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), ref_o.float(), atol=O_ATOL, rtol=O_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    if kw["kv_len"] is not None:
        masked = kw["kv_len"] == 0
        assert torch.all(o[masked] == 0)
        assert torch.equal(lse[masked], ref_lse[masked])
    o2, lse2 = _fwd(q, k, v, kw, c.get("direct", False))
    assert torch.equal(o, o2) and torch.equal(lse, lse2)  # the same bits on a repeat


def test_wgmma_body_reads_path_b_strided_v(dev):
    """Path B's v, a view of the fused in_proj output ([q | k | v | fc_in]
    columns), loads in place: the bits of the same values made contiguous,
    and within the tolerances of the plain version."""
    b, s, h, hd = 1, 2048, 16, 256
    d = h * hd
    q, k, _ = _qkv(dev, b, s, s, hd, seed=12, h=h)
    fused = torch.randn((b, s, 7 * d), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(13)).to(torch.bfloat16)
    v = fused[..., 2 * d:3 * d].reshape(b, s, h, hd)
    assert v.stride() == (s * 7 * d, 7 * d, hd, 1)
    kw = dict(scale=hd ** -0.5, causal=True)
    before = flash_attention_kernel.wgmma_launches
    o, lse = flash_attention_fwd(q, k, v, **kw)
    o_dense, lse_dense = flash_attention_fwd(q, k, v.contiguous(), **kw)
    assert flash_attention_kernel.wgmma_launches == before + 2
    assert torch.equal(o, o_dense) and torch.equal(lse, lse_dense)
    ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=O_ATOL, rtol=O_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


def test_wgmma_body_raises_when_a_map_does_not_encode(dev):
    """A base that is not 16-byte aligned (which the wrapper's checks refuse
    first) makes the tensor map's encode fail: the launcher raises, and
    runs no other body."""
    from magma_tpu_torch.ops.flash_attention import _fwd_launch

    q, k, v = _qkv(dev, 1, 2048, 2048, 256, h=16)
    q_odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
    assert q_odd.data_ptr() % 16
    with pytest.raises(RuntimeError, match="tensor map"):
        _fwd_launch(True, q_odd, k, v, None, scale=1 / 16, causal=True, q_offset=0)


# ---------------------------------------------------------------------------
# int8 serving kernels: K2a/K2b and K4a (csrc/int8_matmul.cu), K5
# (csrc/fused_adapter.cu)
# ---------------------------------------------------------------------------


def _sum_tol(x, wq, s, k):
    """Both versions sum k exact fp32 products in another order: each sum
    is within k 2^-24 of the sum of |terms| (the classical bound), so the
    two are within twice that."""
    mag = (x.float().abs() @ wq.float().abs()) * s.abs()
    return 2 * k * 2.0 ** -24 * mag + 1e-30


def _int8_inputs(dev, m, k, n, layers=2, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (layers, k, n), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((layers, n), generator=g, device=dev) * 1e-3 + 1e-4
    return x, wq, s


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 37, 100, 192, 257, 2048])
def test_int8_matmul_stacked_kernel_matches_plain(m, dev):
    """M <= 8 takes the GEMV, larger M the wgmma tiles: a ragged M pads to
    the tile's 64, 128, 192 or 256 rows with zero rows that are never
    stored, and at N = 3584 the few tiles of M <= 256 split K over a
    cluster.  wgmma sums each k16 step's exact products inside the tensor
    core and adds them to the fp32 accumulator, one of k / 16 ordered
    additions, so the classical bound of _sum_tol holds as for mma.sync."""
    from magma_tpu_torch.ops import quant

    x, wq, s = _int8_inputs(dev, m, 512, 3584)
    before = quant.int8_matmul_stacked_kernel.launches
    out = quant.int8_matmul_stacked(x, wq, s, 1)
    torch.cuda.synchronize()
    assert quant.int8_matmul_stacked_kernel.launches == before + 1
    ref = quant.int8_matmul_stacked_plain(x, wq, s, 1)
    assert out.dtype == torch.float32 and out.shape == (m, 3584)
    assert torch.all((out - ref).abs() <= _sum_tol(x, wq[1], s[1], 512))
    # deterministic: the same bits from run to run
    assert torch.equal(out, quant.int8_matmul_stacked(x, wq, s, 1))


@pytest.mark.parametrize("m", [1, 8, 192])
@pytest.mark.parametrize("k, n", [(4096, 512), (512, 4096), (4096, 1024), (1024, 4096)],
                         ids=["v2_down", "v2_up", "v1_down", "v1_up"])
def test_int8_matmul_stacked_kernel_at_the_adapter_shapes(k, n, m, dev):
    """The int8 adapter mode's two products a layer (hidden 512 in v2, 1024
    in v1) on K2b: the GEMV at M <= 8 (N = 512 gives 16 slices, so K splits
    over a cluster), the tiles at the 192-row prefill (4 to 32 column tiles,
    K split over a cluster), each within the summation bound of the plain
    version and the same bits on a repeat."""
    x, wq, s = _int8_inputs(dev, m, k, n, layers=3, seed=k + n)
    before = quant.int8_matmul_stacked_kernel.launches
    out = quant.int8_matmul_stacked(x, wq, s, 2)
    torch.cuda.synchronize()
    assert quant.int8_matmul_stacked_kernel.launches == before + 1
    ref = quant.int8_matmul_stacked_plain(x, wq, s, 2)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert torch.all((out - ref).abs() <= _sum_tol(x, wq[2], s[2], k))
    assert torch.equal(out, quant.int8_matmul_stacked(x, wq, s, 2))


def test_int8_matmul_head_kernel_matches_plain(dev):
    from magma_tpu_torch.ops import quant

    x, wq, s = _int8_inputs(dev, 1, 4096, 50304, layers=1)
    before = quant.int8_matmul_kernel.launches
    out = quant.int8_matmul(x, wq[0], s[0])
    torch.cuda.synchronize()
    assert quant.int8_matmul_kernel.launches == before + 1
    ref = quant.int8_matmul_plain(x, wq[0], s[0])
    assert torch.all((out - ref).abs() <= _sum_tol(x, wq[0], s[0], 4096))


@pytest.mark.parametrize("m", [1, 5, 192])
def test_dual_kernel_matches_plain(m, dev):
    from magma_tpu_torch.ops import quant

    ko, kf, n = 512, 2048, 512
    ctx, _, _ = _int8_inputs(dev, m, ko, n, seed=1)
    h, wq, s1 = _int8_inputs(dev, m, kf, n, seed=2)
    wq = torch.cat([_int8_inputs(dev, 1, ko, n, seed=3)[1], wq], dim=1)
    s = torch.stack([s1.flip(0), s1], dim=1)
    before = quant.dual_matmul_kernel.launches
    a, mo = quant.dual_matmul_stacked(ctx, h, {"q": wq, "s": s}, 1)
    torch.cuda.synchronize()
    assert quant.dual_matmul_kernel.launches == before + 1
    ra, rm = quant.dual_matmul_stacked_plain(ctx, h, {"q": wq, "s": s}, 1)
    assert torch.all((a - ra).abs() <= _sum_tol(ctx, wq[1, :ko], s[1, 0], ko))
    assert torch.all((mo - rm).abs() <= _sum_tol(h, wq[1, ko:], s[1, 1], kf))
    # K split across a cluster (at M <= 8 the GEMV's, at M = 192 the tiles'
    # over fc_out's Kf = 4 Ko), summed in a fixed order: the same bits
    a2, mo2 = quant.dual_matmul_stacked(ctx, h, {"q": wq, "s": s}, 1)
    assert torch.equal(a, a2) and torch.equal(mo, mo2)


@pytest.mark.parametrize("m", [1, 3, 8, 9, 16, 33, 64])
@pytest.mark.parametrize("d, dh", [(512, 128), (4096, 1024)])
def test_fused_adapter_kernel_matches_plain(m, d, dh, dev):
    """h is rounded to bf16 in both: an h on a rounding boundary may land
    one bf16 ulp (2^-8 relative) apart, which moves out by at most
    2^-8 |h| |Wu| su; the sums differ as in the int8 products.  Rows pad
    to 8, 16, 32 or 64 (33: a ragged 40 of the 64 tile); the chunk sums
    have a fixed order, so a repeat gives the same bits."""
    _check_fused_adapter(dev, m, d, dh)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_fused_adapter_kernel_at_hidden_512(m, dev):
    """MAGMA_v2's adapters (both at k=8: hidden 512 of 4096), as above."""
    _check_fused_adapter(dev, m, 4096, 512)


def _check_fused_adapter(dev, m, d, dh):
    from magma_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(4)
    layers = 3
    w = {"wd": torch.randn((layers, d, dh), generator=g, device=dev) * 0.05,
         "bd": torch.randn((layers, dh), generator=g, device=dev) * 0.05,
         "wu": torch.randn((layers, dh, d), generator=g, device=dev) * 0.05,
         "bu": torch.randn((layers, d), generator=g, device=dev) * 0.05}
    fz = quant.quantize_adapter_fused(w["wd"], w["bd"], w["wu"], w["bu"],
                                      out_scale=torch.tensor([1.0, 2.0, -0.5], device=dev))
    x = torch.randn((m, d), generator=g, device=dev).to(torch.bfloat16)
    before = quant.fused_adapter_kernel.launches
    out = quant.fused_adapter_stacked(x, fz, 2)
    torch.cuda.synchronize()
    assert quant.fused_adapter_kernel.launches == before + 1
    ref = quant.fused_adapter_stacked_plain(x, fz, 2)
    h = torch.relu(quant.int8_matmul_plain(x, fz["wd"][2], fz["sd"][2, 0]) + fz["bd"][2, 0])
    up_mag = (h.abs() @ fz["wu"][2].float().abs()) * fz["su"][2, 0].abs()
    tol = 2.0 ** -8 * up_mag + _sum_tol(h, fz["wu"][2], fz["su"][2, 0], dh) + 1e-6
    assert torch.all((out - ref).abs() <= tol)
    assert torch.equal(out, quant.fused_adapter_stacked(x, fz, 2))


@pytest.mark.parametrize("bad", ["fp32_x", "k_not_128", "misaligned_x", "cpu_scales",
                                 "strided_weight", "adapter_rows_65", "zero_rows",
                                 "dual_zero_rows", "adapter_zero_rows"])
def test_int8_wrappers_raise_on_what_they_do_not_take(bad, dev):
    from magma_tpu_torch.ops import quant

    x, wq, s = _int8_inputs(dev, 4, 512, 384)
    fn, call = quant.int8_matmul_stacked_kernel, None
    if bad == "fp32_x":
        call = lambda: quant.int8_matmul_stacked_kernel(x.float(), wq, s, 0)  # noqa: E731
    elif bad == "k_not_128":
        x2, wq2, s2 = _int8_inputs(dev, 4, 520, 384)
        call = lambda: quant.int8_matmul_stacked_kernel(x2, wq2, s2, 0)  # noqa: E731
    elif bad == "misaligned_x":
        xb = torch.zeros((4, 520), device=dev, dtype=torch.bfloat16)[:, 1:513]
        call = lambda: quant.int8_matmul_stacked_kernel(xb, wq, s, 0)  # noqa: E731
    elif bad == "cpu_scales":
        call = lambda: quant.int8_matmul_stacked_kernel(x, wq, s.cpu(), 0)  # noqa: E731
    elif bad == "strided_weight":
        fn = quant.int8_matmul_kernel
        call = lambda: quant.int8_matmul_kernel(x, wq[0].t().t()[:, ::2], s[0, ::2])  # noqa: E731
    elif bad == "zero_rows":
        call = lambda: quant.int8_matmul_stacked_kernel(x[:0], wq, s, 0)  # noqa: E731
    elif bad == "dual_zero_rows":
        fn = quant.dual_matmul_kernel
        wd = torch.cat([wq, wq], dim=1)
        sd = torch.stack([s, s], dim=1)
        call = lambda: quant.dual_matmul_kernel(x[:0], x[:0], wd, sd, 0)  # noqa: E731
    else:
        fn = quant.fused_adapter_kernel
        fz = {"wd": wq[:, :, :128], "wu": wq[:, :128, :],
              "sd": s[:, None, :128], "bd": s[:, None, :128],
              "su": s[:, None, :], "bu": s[:, None, :]}
        xa = torch.zeros((0 if bad == "adapter_zero_rows" else 65, 512), device=dev,
                         dtype=torch.bfloat16)
        call = lambda: quant.fused_adapter_kernel(xa, fz, 0)  # noqa: E731
    before = fn.launches
    with pytest.raises((TypeError, ValueError)):
        call()
    assert fn.launches == before


def test_tiny_int8_lm_on_the_gpu_matches_its_cpu_run(dev):
    """A bf16 GPT-J with int8 packs on the GPU: prefill logits agree with
    the same model run on the CPU (the plain versions) to bf16 noise, and
    a greedy decode launches each kernel the expected number of times."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.models.adapters import AdapterSpec
    from magma_tpu_torch.ops import quant
    from magma_tpu_torch.ops.sampling import generate_tokens

    cfg = gptj.GPTJConfig.tiny(d_model=512, n_heads=4, d_ff=2048, attention_impl="flash",
                               param_dtype=torch.bfloat16,
                               mlp_adapter=AdapterSpec("normal", 4))
    params = gptj.init_params(torch.Generator().manual_seed(0), cfg)
    for proj in ("down", "up"):  # trained-scale adapters so they matter
        ad = params["blocks"]["adapter_mlp"][proj]
        ad["kernel"] = torch.randn(ad["kernel"].shape, generator=torch.Generator().manual_seed(1)) * 0.05
    params = gptj.quantize_lm_params(params)
    on_gpu = _to(params, dev)
    emb = torch.randn((1, 40, 512), generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    cpu_logits, _ = gptj.forward(cfg, params, emb)
    gpu_logits, _ = gptj.forward(cfg, on_gpu, emb.to(dev))
    torch.testing.assert_close(gpu_logits.cpu(), cpu_logits, atol=0.1, rtol=0)
    kernels = (quant.int8_matmul_kernel, quant.int8_matmul_stacked_kernel,
               quant.dual_matmul_kernel, quant.fused_adapter_kernel)
    before = [k.launches for k in kernels]
    tokens, steps = generate_tokens(cfg, on_gpu, emb.to(dev), None, max_steps=6,
                                    temperature=0.0)
    got = [k.launches - b for k, b in zip(kernels, before)]
    L = cfg.n_layers
    assert got == [steps, L * steps, L * steps, L * steps]  # 40 prompt rows: K5 in prefill too


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# int4 (W4A8) serving kernels: K3 and K4b (csrc/int4_matmul.cu), K6
# (csrc/boundary.cu)
# ---------------------------------------------------------------------------


def _int4_stack(dev, k, n, layers=2, seed=0):
    """A packed int4 stack (layers, k/2, n) with its group scales, from
    seeded weights quantised on the card."""
    from magma_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)
    packs = [quant.quantize_int4(torch.randn((k, n), generator=g, device=dev) * 0.02)
             for _ in range(layers)]
    return torch.stack([p["q4"] for p in packs]), torch.stack([p["s4"] for p in packs])


def _bf16_rows(dev, m, k, seed, std=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((m, k), generator=g, device=dev) * std).to(torch.bfloat16)


def _check_k3(dev, x, q4, s4):
    """K3 once (one launch) against the plain version and a repeat, bit for bit."""
    from magma_tpu_torch.ops import quant

    before = quant.int4_matmul_stacked_kernel.launches
    out = quant.int4_matmul_stacked(x, q4, s4, 1)
    torch.cuda.synchronize()
    assert quant.int4_matmul_stacked_kernel.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (x.shape[0], q4.shape[-1])
    assert torch.equal(out, quant.int4_matmul_stacked_plain(x, q4, s4, 1))
    assert torch.equal(out, quant.int4_matmul_stacked(x, q4, s4, 1))


def _check_k4b(dev, ctx, h, w):
    """K4b once (one launch) against the plain version and a repeat, bit for bit."""
    from magma_tpu_torch.ops import quant

    before = quant.int4_dual_kernel.launches
    a, mo = quant.dual_matmul_stacked(ctx, h, w, 1)
    torch.cuda.synchronize()
    assert quant.int4_dual_kernel.launches == before + 1
    ra, rm = quant.dual_matmul_stacked_plain(ctx, h, w, 1)
    assert torch.equal(a, ra) and torch.equal(mo, rm)
    a2, mo2 = quant.dual_matmul_stacked(ctx, h, w, 1)
    assert torch.equal(a, a2) and torch.equal(mo, mo2)


def _dual_payload(dev):
    qo, so = _int4_stack(dev, 4096, 4096, seed=2)
    qf, sf = _int4_stack(dev, 16384, 4096, seed=3)
    return {"q4": torch.cat([qo, qf], dim=1), "s4": torch.cat([so, sf], dim=1)}


@pytest.mark.parametrize("m", [1, 5, 9, 37, 64, 65, 192, 200, 2048])
def test_int4_matmul_stacked_kernel_matches_plain(m, dev):
    """K3 on the in_proj stack (K=4096, N=28672): the int8 dots are exact
    and the fp32 steps are the plain version's, in its order, so the two
    are equal bit for bit, and the same from run to run.  M > 8 runs the
    wgmma tile: 64 rows a block up to 64, 96 above, ragged at 9, 65, 200."""
    q4, s4 = _int4_stack(dev, 4096, 28672)
    _check_k3(dev, _bf16_rows(dev, m, 4096, 1), q4, s4)


@pytest.mark.parametrize("m", [1, 8, 9, 65, 192, 200])
def test_int4_dual_kernel_matches_plain(m, dev):
    w = _dual_payload(dev)
    _check_k4b(dev, _bf16_rows(dev, m, 4096, 4), _bf16_rows(dev, m, 16384, 5, 0.5), w)


def test_int4_kernels_with_zero_rows(dev):
    """Rows of x that are all zero quantise to codes 0 with scale 1, in the
    kernels as in the plain version: K3 and K4b at M = 200, with zero rows
    inside a row tile, at a tile's first row and at the last row."""
    zero = [0, 5, 6, 7, 95, 96, 150, 199]
    q4, s4 = _int4_stack(dev, 4096, 28672)
    x = _bf16_rows(dev, 200, 4096, 1)
    x[zero] = 0
    _check_k3(dev, x, q4, s4)
    ctx, h = _bf16_rows(dev, 200, 4096, 4), _bf16_rows(dev, 200, 16384, 5, 0.5)
    ctx[zero] = 0
    h[zero[1:]] = 0
    _check_k4b(dev, ctx, h, _dual_payload(dev))


def _boundary_payloads(dev, variant):
    """Full-width int4 payloads (D 4096, F 16384, NI 28672, 2 layers) and
    fused adapters (DH 1024) for the boundary: "v1" is an mlp adapter
    (normal); "scaled" adds an attention adapter fed from u_in, with o_bias;
    "v2" is MAGMA_v2's pair, both normal at DH 512 (the attention adapter
    fed from its branch's output), with o_bias."""
    from magma_tpu_torch.ops import quant

    D, F, L = 4096, 16384, 2
    qo, so = _int4_stack(dev, D, D, seed=6)
    qf, sf = _int4_stack(dev, F, D, seed=7)
    qi, si = _int4_stack(dev, D, 3 * D + F, seed=8)
    g = torch.Generator(device=dev).manual_seed(9)

    def vec(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev) * std

    def adapter(dh=1024):
        return quant.quantize_adapter_fused(vec(L, D, dh, std=0.05), vec(L, dh),
                                            vec(L, dh, D, std=0.05), vec(L, D),
                                            out_scale=torch.tensor([1.5, -0.75], device=dev))

    kw = dict(fz_mlp=adapter(), mlp_src="out")
    if variant == "scaled":
        kw.update(fz_attn=adapter(), attn_src="in", o_bias=vec(L, D))
    if variant == "v2":
        kw.update(fz_mlp=adapter(512), fz_attn=adapter(512), attn_src="out", o_bias=vec(L, D))
    return ({"q4": torch.cat([qo, qf], 1), "s4": torch.cat([so, sf], 1)},
            {"q4": qi, "s4": si}, vec(L, D), 1 + vec(L, D, std=0.1), vec(L, D), kw)


@pytest.mark.parametrize("w_in", [True, False], ids=["with_w_in", "last_layer"])
@pytest.mark.parametrize("variant", ["v1", "scaled", "v2"])
@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_boundary_kernel_matches_plain(m, variant, w_in, dev):
    """K6 against the composition of the plain K4b, K5 and K3.  The dual
    and in_proj sums are the plain version's bits; the adapters' int8 sums
    run in another order than PyTorch's matmul and the LN statistics in
    another order than torch's mean and var, so an h, a z or a u on a bf16
    rounding boundary may land one bf16 ulp apart and carry into y and
    fused: each output within 2^-6 of its largest magnitude, and at least
    90% of its elements equal.  In "v2" the attention adapter's z is
    several times a, and one h of its first row lies on a bf16 rounding
    tie (within 0.005 x 2^-24 of the sum of its |terms|): K5's order of
    the sums rounds it the other way, which moves 2% of that row's y, 3%
    of its u and 38% of its fused by an ulp
    (scripts/torch_k6_v2_witness.py, PERF.md).  There K6 must
    have at least half of its elements equal to the plain version (61.7% at
    M = 1; a kernel with its adapters fed from the wrong source reads under
    1%), and equal bit for bit the composition of the K4b, K5 and K3
    kernels, each held to its plain version by its own test."""
    from magma_tpu_torch.ops import quant

    dual, w_inp, bfo, ln_g, ln_b, kw = _boundary_payloads(dev, variant)
    ctx, mh = _bf16_rows(dev, m, 4096, 10), _bf16_rows(dev, m, 16384, 11, 0.5)
    x, u_in = _bf16_rows(dev, m, 4096, 12, 0.3), _bf16_rows(dev, m, 4096, 13)
    li = 0 if w_in else 1
    args = (ctx, mh, x, dual, bfo, ln_g, ln_b, li)
    kw = dict(kw, w_in=w_inp if w_in else None, u_in=u_in)
    before = quant.boundary_kernel.launches
    got = quant.boundary_fused_stacked(*args, **kw)
    torch.cuda.synchronize()
    assert quant.boundary_kernel.launches == before + 1
    ref = quant.boundary_fused_stacked_plain(*args, **kw)
    assert len(got) == len(ref) == (3 if w_in else 2)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        diff = (g.float() - r.float()).abs()
        assert diff.max() <= 2.0 ** -6 * r.float().abs().max()
        assert (g == r).float().mean() >= (0.5 if variant == "v2" else 0.9)
    if variant == "v2":
        composed = quant._boundary_compose(
            *args, **dict(kw, ln_eps=1e-5), dual=quant.dual_matmul_stacked,
            adapter=quant.fused_adapter_stacked, inproj=quant.int4_matmul_stacked)
        assert len(composed) == len(got) and all(map(torch.equal, got, composed))
    again = quant.boundary_fused_stacked(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("o_bias", [False, True], ids=["no_bias", "o_bias"])
@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_boundary_kernel_dual_and_in_proj_are_the_plain_products(m, o_bias, dev):
    """Without adapters K6's y is the plain version's bit for bit (each
    W4A8 group's term in w4a8_term's unfused steps, the groups added in
    order from 0, then the same bf16 adds), and its fused is the plain
    W4A8 in_proj of its own u, rounded to bf16, bit for bit."""
    from magma_tpu_torch.ops import quant

    dual, w_inp, bfo, ln_g, ln_b, _ = _boundary_payloads(dev, "v1")
    ctx, mh = _bf16_rows(dev, m, 4096, 20), _bf16_rows(dev, m, 16384, 21, 0.5)
    x = _bf16_rows(dev, m, 4096, 22, 0.3)
    ob = (torch.randn((2, 4096), generator=torch.Generator(device=dev).manual_seed(23),
                      device=dev) * 0.02) if o_bias else None
    args = (ctx, mh, x, dual, bfo, ln_g, ln_b, 0)
    y, u, fused = quant.boundary_fused_stacked(*args, w_in=w_inp, o_bias=ob)
    ry, _, _ = quant.boundary_fused_stacked_plain(*args, w_in=w_inp, o_bias=ob)
    torch.cuda.synchronize()
    assert torch.equal(y, ry)
    want = quant.int4_matmul_stacked_plain(u, w_inp["q4"], w_inp["s4"], 1).to(torch.bfloat16)
    assert torch.equal(fused, want)


def test_boundary_stamped_matches_kernel(dev):
    """The stamped build computes what the kernel does, bit for bit, and
    stamps every phase of the v1 layer on every block; it is not counted
    as a launch."""
    from magma_tpu_torch.ops import quant

    dual, w_inp, bfo, ln_g, ln_b, kw = _boundary_payloads(dev, "v1")
    ctx, mh = _bf16_rows(dev, 8, 4096, 10), _bf16_rows(dev, 8, 16384, 11, 0.5)
    x = _bf16_rows(dev, 8, 4096, 12, 0.3)
    args = (ctx, mh, x, dual, bfo, ln_g, ln_b, 0)
    got = quant.boundary_kernel(*args, w_in=w_inp, **kw)
    before = quant.boundary_kernel.launches
    *stamped, stamps = quant.boundary_stamped(*args, w_in=w_inp, **kw)
    torch.cuda.synchronize()
    assert quant.boundary_kernel.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, stamped))
    # every block stamps the item phases and the LN; the owners of sums
    # their sums
    ran = [name for i, name in enumerate(quant.BOUNDARY_PHASES)
           if bool((stamps[:, i, 1] > 0).any())]
    assert ran == list(quant.BOUNDARY_PHASES)
    assert bool((stamps[:, quant.BOUNDARY_PHASES.index("dual"), 1] > 0).all())
    phases = quant.phase_breakdown(stamps)
    assert phases["total"] > 0 and all(v >= 0 for k, v in phases.items() if "wait" not in k)


@pytest.mark.parametrize("bad", ["int4_zero_rows", "int4_k_not_512", "int4_fp32_x",
                                 "dual4_zero_rows", "boundary_9_rows", "boundary_last_layer",
                                 "boundary_cpu_vec", "boundary_in_without_u_in"])
def test_int4_wrappers_raise_on_what_they_do_not_take(bad, dev):
    from magma_tpu_torch.ops import quant

    q4, s4 = _int4_stack(dev, 1024, 512)
    x = _bf16_rows(dev, 4, 1024, 0)
    fn = quant.int4_matmul_stacked_kernel
    if bad == "int4_zero_rows":
        call = lambda: quant.int4_matmul_stacked_kernel(x[:0], q4, s4, 0)  # noqa: E731
    elif bad == "int4_k_not_512":
        q2, s2 = _int4_stack(dev, 768, 512)
        call = lambda: quant.int4_matmul_stacked_kernel(x[:, :768].contiguous(), q2, s2, 0)  # noqa: E731
    elif bad == "int4_fp32_x":
        call = lambda: quant.int4_matmul_stacked_kernel(x.float(), q4, s4, 0)  # noqa: E731
    elif bad == "dual4_zero_rows":
        fn = quant.int4_dual_kernel
        call = lambda: quant.int4_dual_kernel(x[:0], x[:0], torch.cat([q4, q4], 1),  # noqa: E731
                                              torch.cat([s4, s4], 1), 0)
    else:
        fn = quant.boundary_kernel
        D, F = 512, 1024
        dual = {"q4": torch.cat([_int4_stack(dev, D, D)[0], _int4_stack(dev, F, D)[0]], 1),
                "s4": torch.cat([_int4_stack(dev, D, D)[1], _int4_stack(dev, F, D)[1]], 1)}
        w_in = dict(zip(("q4", "s4"), _int4_stack(dev, D, 1024)))
        vec = torch.zeros((2, D), device=dev)
        m = 9 if bad == "boundary_9_rows" else 1
        rows = _bf16_rows(dev, m, D, 1)
        mh = _bf16_rows(dev, m, F, 2)
        kw = dict(w_in=w_in)
        li = 0
        if bad == "boundary_last_layer":
            li = 1
        elif bad == "boundary_cpu_vec":
            vec = vec.cpu()
        elif bad == "boundary_in_without_u_in":
            fz = quant.quantize_adapter_fused(torch.zeros((2, D, 128), device=dev),
                                              torch.zeros((2, 128), device=dev),
                                              torch.zeros((2, 128, D), device=dev),
                                              torch.zeros((2, D), device=dev))
            kw.update(fz_attn=fz, attn_src="in")
        call = lambda: quant.boundary_kernel(rows, mh, rows, dual, vec, vec, vec, li, **kw)  # noqa: E731
    before = fn.launches
    with pytest.raises((TypeError, ValueError)):
        call()
    assert fn.launches == before


def test_tiny_int4_lm_on_the_gpu_matches_its_cpu_run(dev):
    """A bf16 GPT-J at d_model 512 (every int4 product on its W4A8 kernel)
    on the GPU against the same model on the CPU (the plain versions):
    prefill logits agree to bf16 noise, and a greedy decode launches each
    kernel the expected number of times: per prefill K3, K4b and K5 (40
    rows) once a layer; per decode step K3 once (layer 0) and K6 once a
    layer; K2a once a forward."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.models.adapters import AdapterSpec
    from magma_tpu_torch.ops import quant
    from magma_tpu_torch.ops.sampling import generate_tokens

    cfg = gptj.GPTJConfig.tiny(d_model=512, n_heads=4, d_ff=2048, attention_impl="flash",
                               param_dtype=torch.bfloat16,
                               mlp_adapter=AdapterSpec("normal", 4))
    params = gptj.init_params(torch.Generator().manual_seed(0), cfg)
    for proj in ("down", "up"):  # trained-scale adapters so they matter
        ad = params["blocks"]["adapter_mlp"][proj]
        ad["kernel"] = torch.randn(ad["kernel"].shape, generator=torch.Generator().manual_seed(1)) * 0.05
    params = gptj.quantize_lm_params_int4(params)
    on_gpu = _to(params, dev)
    emb = torch.randn((1, 40, 512), generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    cpu_logits, _ = gptj.forward(cfg, params, emb)
    gpu_logits, _ = gptj.forward(cfg, on_gpu, emb.to(dev))
    torch.testing.assert_close(gpu_logits.cpu(), cpu_logits, atol=0.1, rtol=0)
    kernels = (quant.int8_matmul_kernel, quant.int4_matmul_stacked_kernel,
               quant.int4_dual_kernel, quant.boundary_kernel, quant.fused_adapter_kernel)
    before = [k.launches for k in kernels]
    tokens, steps = generate_tokens(cfg, on_gpu, emb.to(dev), None, max_steps=6,
                                    temperature=0.0)
    got = [k.launches - b for k, b in zip(kernels, before)]
    L = cfg.n_layers
    assert got == [steps, L + steps - 1, L, L * (steps - 1), L]


# ---------------------------------------------------------------------------
# whole decode layers: K7 and K8 (csrc/decode_layer.cu)
# ---------------------------------------------------------------------------

# K7's y, u and fused against the plain version: the boundary phases are
# K6's, so K6's tolerance (the adapters' int8 sums and the LN statistics in
# another order; here also the attention's chunked online softmax and the
# gelu against PyTorch's): each within 2^-6 of its largest magnitude, >= 90%
# of elements equal.  K8 chains the layers, so a flip of one layer carries
# into the next: 2^-5 of the largest |y| after three layers, >= 50% equal.
K7_REL_TOL, K7_MIN_EQUAL = 2.0 ** -6, 0.9
K8_REL_TOL, K8_MIN_EQUAL = 2.0 ** -5, 0.5


def _declayer_payloads(dev, fmt, kv, recipe, L=3, D=2048, F=2048, max_len=64, seed=20):
    """Stacks at a small head_dim-256 geometry (8 heads, D = F = 2048, NI =
    8192), a filled cache and the layer inputs, all from seeds on the card.
    Recipes: "v1" the mlp adapter; "scaled" both adapters (the attention's
    fed from u_in) and o_bias; "attn_no_bias" both adapters, no o_bias;
    "bias_no_adapter" o_bias and no adapter; "v2" MAGMA_v2's: both
    adapters normal (the attention's fed from its branch's output) and
    o_bias.  Every adapter's hidden is 512, v2's at full width."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def stack(k, n):
        if fmt == "int4":
            packs = [quant.quantize_int4(randn(k, n, std=0.02)) for _ in range(L)]
            return {"q4": torch.stack([p["q4"] for p in packs]),
                    "s4": torch.stack([p["s4"] for p in packs])}
        packs = [quant.quantize_int8(randn(k, n, std=0.02)) for _ in range(L)]
        return {"q": torch.stack([p["q"] for p in packs]), "s": torch.stack([p["s"] for p in packs])}

    o, f = stack(D, D), stack(F, D)
    if fmt == "int4":
        dual = {"q4": torch.cat([o["q4"], f["q4"]], 1), "s4": torch.cat([o["s4"], f["s4"]], 1)}
    else:
        dual = {"q": torch.cat([o["q"], f["q"]], 1), "s": torch.stack([o["s"], f["s"]], 1)}
    w_in = stack(D, 3 * D + F)

    def adapter():
        return quant.quantize_adapter_fused(randn(L, D, 512, std=0.05), randn(L, 512, std=0.02),
                                            randn(L, 512, D, std=0.05), randn(L, D, std=0.02),
                                            out_scale=1 + randn(L, std=0.5))

    kw = dict(n_heads=D // 256, scale=1 / 16)
    if recipe != "bias_no_adapter":
        kw.update(fz_mlp=adapter(), mlp_src="out")
    if recipe in ("scaled", "attn_no_bias"):
        kw.update(fz_attn=adapter(), attn_src="in")
    if recipe == "v2":
        kw.update(fz_attn=adapter(), attn_src="out")
    if recipe in ("scaled", "bias_no_adapter", "v2"):
        kw.update(o_bias=randn(L, D, std=0.02))
    shape = (L, 1, max_len, D // 256, 256)
    kc, vc = randn(*shape).to(torch.bfloat16), randn(*shape).to(torch.bfloat16)
    kvs = None
    if kv == "int8":
        (kc, ks), (vc, vs) = gptj._quantize_kv(kc), gptj._quantize_kv(vc)
        kvs = (ks, vs)
    from magma_tpu_torch.ops.rotary import rotary_sincos

    ins = dict(fused=randn(1, 3 * D + F).to(torch.bfloat16),
               x=randn(1, D, std=0.3).to(torch.bfloat16), u=randn(1, D).to(torch.bfloat16))
    vecs = (randn(L, F, std=0.1), randn(L, D, std=0.02), 1 + randn(L, D, std=0.1),
            randn(L, D, std=0.02))
    sincos = rotary_sincos(torch.tensor([37], device=dev), 64)
    return dual, w_in, vecs, (kc, vc, kvs), sincos, ins, kw


def _check_k7_like(got, ref, names, rel, min_equal):
    for gt, rf, name in zip(got, ref, names):
        assert gt.dtype == torch.bfloat16 and gt.shape == rf.shape, name
        diff = (gt.float() - rf.float()).abs()
        if name == "v_new":
            assert torch.equal(gt, rf), name
        elif name == "k_new":  # the fp32 rotary in the plain version's order
            assert torch.all(diff <= 2.0 ** -7 * rf.float().abs()), name
        else:
            assert diff.max() <= rel * rf.float().abs().max(), name
            assert (diff == 0).float().mean() >= min_equal, name


@pytest.mark.parametrize("layer", [1, 2], ids=["with_w_in", "last_layer"])
@pytest.mark.parametrize("recipe", ["v1", "scaled", "v2"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_layer_kernel_matches_plain(fmt, kv, recipe, layer, dev):
    from magma_tpu_torch.ops import decode_layer as dl

    dual, w_in, (bfi, bfo, ln_g, ln_b), (kc, vc, kvs), sincos, ins, kw = \
        _declayer_payloads(dev, fmt, kv, recipe)
    with_in = layer == 1
    args = (ins["fused"], ins["x"], sincos, kc, vc, kvs, 37, dual, bfi, bfo, ln_g, ln_b, layer)
    kw = dict(kw, w_in=w_in if with_in else None, u_in=ins["u"])
    before = dl.decode_layer_kernel.launches
    got = dl.decode_layer_fused(*args, **kw)
    torch.cuda.synchronize()
    assert dl.decode_layer_kernel.launches == before + 1
    ref = dl.decode_layer_plain(*args, **kw)
    names = ("y", "u", "fused", "k_new", "v_new") if with_in else ("y", "u", "k_new", "v_new")
    assert len(got) == len(ref) == len(names)
    _check_k7_like(got, ref, names, K7_REL_TOL, K7_MIN_EQUAL)
    again = dl.decode_layer_fused(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no float atomics


def _k8_args(dev, fmt, kv, recipe, pos, max_len=256):
    from magma_tpu_torch.ops.rotary import rotary_sincos

    dual, w_in, (bfi, bfo, ln_g, ln_b), (kc, vc, kvs), _, ins, kw = \
        _declayer_payloads(dev, fmt, kv, recipe, max_len=max_len)
    sincos = rotary_sincos(torch.tensor([pos], device=dev), 64)
    args = (ins["fused"], ins["x"], ins["u"], sincos, kc, vc, kvs,
            torch.tensor([pos], dtype=torch.int32, device=dev), dual, w_in, bfi, bfo, ln_g, ln_b)
    return args, kw


@pytest.mark.parametrize("pos", [37, 0])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_all_layers_kernel_matches_plain(fmt, kv, pos, dev):
    from magma_tpu_torch.ops import decode_layer as dl

    args, kw = _k8_args(dev, fmt, kv, "scaled", pos, max_len=64)
    before = dl.decode_all_layers_kernel.launches
    got = dl.decode_all_layers_fused(*args, **kw)
    torch.cuda.synchronize()
    assert dl.decode_all_layers_kernel.launches == before + 1
    ref = dl.decode_all_layers_plain(*args, **kw)
    assert got[1].shape == (3, 1, 2048)
    _check_k7_like(got[:1], ref[:1], ("y",), K8_REL_TOL, K8_MIN_EQUAL)
    # layer 0's rows come before any chained difference
    _check_k7_like((got[1][0], got[2][0]), (ref[1][0], ref[2][0]), ("k_new", "v_new"), 0, 1)


# K8 against its plain version at positions that cross the attention's
# 16-position chunks (none, a partial first chunk, one short of, at and one
# past a chunk's end, the slice's 180 and max_len - 1 of a 256-position
# cache) and over the adapter recipes.  The share of bit-equal elements is
# no property of a kernel once a bf16 flip in one layer has moved every
# later one: the earlier phase-per-barrier kernel, whose int4 bits this one
# repeats, kept under half of y equal at int4 / int8 cache / pos 180, and
# on chained inputs a layer's fused falls under 90% equal too.  So these
# cases hold the bounds: K8
# bit-equal to its layers run as K7 launches, each layer within K7's 2^-6
# of the plain layer on the same inputs (k_new within a bf16 ulp, v_new
# exact), the chain's y within K8's 2^-5 of the chained plain version, and
# layer 0's rows exact.
K8_POSITIONS = [0, 1, 15, 16, 17, 180, 255]


def _check_k8_layerwise(dev, fmt, kv, recipe, pos):
    from magma_tpu_torch.ops import decode_layer as dl

    args, kw = _k8_args(dev, fmt, kv, recipe, pos)
    before = dl.decode_all_layers_kernel.launches
    got = dl.decode_all_layers_fused(*args, **kw)
    torch.cuda.synchronize()
    assert dl.decode_all_layers_kernel.launches == before + 1
    again = dl.decode_all_layers_fused(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no float atomics
    fused0, x0, u0, sincos, kc, vc, kvs, pos_t, dual, w_in, *vecs = args
    f, xx, uu, rows = fused0, x0, u0, []
    for layer in range(3):
        lkw = dict(kw, w_in=w_in if layer < 2 else None, u_in=uu)
        largs = (f, xx, sincos, kc, vc, kvs, pos_t, dual, *vecs, layer)
        outs = dl.decode_layer_fused(*largs, **lkw)
        ref = dl.decode_layer_plain(*largs, **lkw)
        names = ("y", "u", "fused", "k_new", "v_new") if layer < 2 else ("y", "u", "k_new", "v_new")
        _check_k7_like(outs, ref, names, K7_REL_TOL, 0.0)
        xx, uu = outs[:2]
        if layer < 2:
            f = outs[2]
        rows.append(outs[-2:])
    torch.cuda.synchronize()
    assert torch.equal(xx, got[0])
    assert torch.equal(torch.stack([r[0] for r in rows]), got[1])
    assert torch.equal(torch.stack([r[1] for r in rows]), got[2])
    ref = dl.decode_all_layers_plain(*args, **kw)
    diff = (got[0].float() - ref[0].float()).abs()
    assert diff.max() <= K8_REL_TOL * ref[0].float().abs().max()
    _check_k7_like((got[1][0], got[2][0]), (ref[1][0], ref[2][0]), ("k_new", "v_new"), 0, 1)


@pytest.mark.parametrize("pos", K8_POSITIONS)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_all_layers_kernel_matches_plain_layerwise(fmt, kv, pos, dev):
    _check_k8_layerwise(dev, fmt, kv, "scaled", pos)


@pytest.mark.parametrize("recipe", ["v1", "attn_no_bias", "bias_no_adapter", "v2"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_all_layers_kernel_recipes_match_plain(fmt, kv, recipe, dev):
    """With and without the attention adapter, with and without o_bias, with
    no adapter at all (the dual's tiles then write y themselves), and
    MAGMA_v2's normal attention adapter fed from its branch's output."""
    _check_k8_layerwise(dev, fmt, kv, recipe, 180)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_all_layers_kernel_repeats_bits(fmt, kv, dev):
    """No float atomics and a fixed order of every sum: a second launch
    gives the same bits, and so do the layers one K7 launch each."""
    from magma_tpu_torch.ops import decode_layer as dl

    args, kw = _k8_args(dev, fmt, kv, "scaled", 180)
    got = dl.decode_all_layers_fused(*args, **kw)
    again = dl.decode_all_layers_fused(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    fused0, x0, u0, sincos, kc, vc, kvs, pos_t, dual, w_in, *vecs = args
    f, xx, uu, rows = fused0, x0, u0, []
    for layer in range(3):
        outs = dl.decode_layer_fused(f, xx, sincos, kc, vc, kvs, pos_t, dual, *vecs, layer,
                                     w_in=w_in if layer < 2 else None, u_in=uu, **kw)
        xx, uu = outs[:2]
        if layer < 2:
            f = outs[2]
        rows.append(outs[-2:])
    torch.cuda.synchronize()
    assert torch.equal(xx, got[0])
    assert torch.equal(torch.stack([r[0] for r in rows]), got[1])
    assert torch.equal(torch.stack([r[1] for r in rows]), got[2])


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_all_layers_stamped_matches_kernel(fmt, dev):
    """The stamped measurement build computes K8's bits, stamps every phase
    of every layer in every block, and counts no launch."""
    from magma_tpu_torch.ops import decode_layer as dl

    args, kw = _k8_args(dev, fmt, "bf16", "v1", 180)
    got = dl.decode_all_layers_fused(*args, **kw)
    before = dl.decode_all_layers_kernel.launches
    *stamped, stamps = dl.decode_all_layers_stamped(*args, **kw)
    torch.cuda.synchronize()
    assert dl.decode_all_layers_kernel.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, stamped))
    assert stamps.shape == (dl.decode_layers_grid(), 3, len(dl.PHASES), 2)
    assert bool((stamps > 0).all()) and bool((stamps[..., 1] >= stamps[..., 0]).all())
    phases = dl.phase_breakdown(stamps)
    assert phases["total"] > 0 and all(v >= 0 for v in phases.values())


@pytest.mark.parametrize("bad", ["batch_2", "head_dim_128", "max_len_200", "cpu_cache",
                                 "fp32_fused", "last_layer_w_in", "int64_pos"])
def test_decode_layer_wrappers_raise_on_what_they_do_not_take(bad, dev):
    from magma_tpu_torch.ops import decode_layer as dl

    dual, w_in, (bfi, bfo, ln_g, ln_b), (kc, vc, kvs), sincos, ins, kw = \
        _declayer_payloads(dev, "int4", "bf16", "v1")
    fused, x, layer, pos = ins["fused"], ins["x"], 0, torch.tensor([5], dtype=torch.int32,
                                                                   device=dev)
    if bad == "batch_2":
        kc, vc = kc.expand(-1, 2, -1, -1, -1).contiguous(), vc.expand(-1, 2, -1, -1, -1).contiguous()
    elif bad == "head_dim_128":
        kc, vc = (t.reshape(3, 1, 64, 16, 128) for t in (kc, vc))
        kw = dict(kw, n_heads=16)
    elif bad == "max_len_200":
        kc = torch.zeros((3, 1, 200, 8, 256), dtype=torch.bfloat16, device=dev)
        vc = kc.clone()
    elif bad == "cpu_cache":
        kc = kc.cpu()
    elif bad == "fp32_fused":
        fused = fused.float()
    elif bad == "last_layer_w_in":
        layer = 2
    else:
        pos = pos.long()
    fn = dl.decode_layer_kernel
    before = fn.launches
    with pytest.raises((TypeError, ValueError)):
        fn(fused, x, sincos, kc, vc, kvs, pos, dual, bfi, bfo, ln_g, ln_b, layer, w_in=w_in,
           **kw)
    assert fn.launches == before


@pytest.mark.parametrize("bad", ["int8_cache_bf16_scales", "unaligned_stack", "strided_stack",
                                 "in_proj_of_other_width", "scratch_refused"])
def test_decode_all_layers_kernel_raises_on_what_it_does_not_take(bad, dev, monkeypatch):
    """K8's wrapper raises, and launches nothing, on a cache or a stack the
    kernel does not take; a launch the C entry refuses raises too."""
    from magma_tpu_torch.ops import decode_layer as dl

    args, kw = _k8_args(dev, "int4", "int8", "v1", 37)
    args = list(args)
    kc, kvs, dual, w_in = args[4], args[6], args[8], args[9]
    if bad == "int8_cache_bf16_scales":
        args[6] = (kvs[0].float(), kvs[1].float())
    elif bad == "unaligned_stack":
        raw = torch.empty(dual["q4"].numel() + 8, dtype=torch.int8, device=dev)
        args[8] = dict(dual, q4=raw[8:].view(dual["q4"].shape).copy_(dual["q4"]))
    elif bad == "strided_stack":
        args[4] = kc.transpose(3, 4).contiguous().transpose(3, 4)
    elif bad == "in_proj_of_other_width":
        args[9] = {k: v[..., :-128].contiguous() for k, v in w_in.items()}
    else:  # the C entry's own checks: too few arrival counters
        plan = dl.stream_plan
        monkeypatch.setattr(dl, "stream_plan", lambda **k: dict(plan(**k), counters=0))
    fn = dl.decode_all_layers_kernel
    before = fn.launches
    with pytest.raises(RuntimeError if bad == "scratch_refused" else (TypeError, ValueError)):
        fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_gated_lm_decode_runs_through_k8(fmt, dev):
    """A GPT-J at the kernels' geometry (8 heads of 256, 2 layers) on the
    GPU: every decode step of a b=1 request is one K8 launch plus layer 0's
    in_proj, no K5, K6 or K7."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.models.adapters import AdapterSpec
    from magma_tpu_torch.ops import decode_layer as dl
    from magma_tpu_torch.ops import quant
    from magma_tpu_torch.ops.sampling import generate_tokens

    cfg = gptj.GPTJConfig.tiny(n_layers=2, n_heads=8, d_model=2048, d_ff=2048, rotary_dim=64,
                               attention_impl="flash", param_dtype=torch.bfloat16,
                               mlp_adapter=AdapterSpec("normal", 4))
    params = gptj.init_params(torch.Generator().manual_seed(0), cfg)
    quantize = gptj.quantize_lm_params_int4 if fmt == "int4" else gptj.quantize_lm_params
    params = _to(quantize(params), dev)
    emb = torch.randn((1, 40, 2048), generator=torch.Generator().manual_seed(2)).to(dev)
    inproj = quant.int4_matmul_stacked_kernel if fmt == "int4" else quant.int8_matmul_stacked_kernel
    kernels = (dl.decode_all_layers_kernel, dl.decode_layer_kernel, quant.boundary_kernel,
               quant.fused_adapter_kernel, inproj)
    before = [k.launches for k in kernels]
    tokens, steps = generate_tokens(cfg, params, emb, None, max_steps=6, temperature=0.0)
    got = [k.launches - b for k, b in zip(kernels, before)]
    L = cfg.n_layers
    # the prefill's 40 rows take K5 once a layer; decode never does
    assert got == [steps - 1, 0, 0, L, L + steps - 1]


# ---------------------------------------------------------------------------
# Training kernels: K9a/K9b (csrc/flash_attn_bwd.cu), K10
# (csrc/int8_matmul_dx.cu)
# ---------------------------------------------------------------------------

# K9a/K9b against the fp32 plain backward on the same bf16 inputs, O and lse:
# the kernels round P and dS to bf16 for the tensor cores (2^-9 relative
# each) and their outputs to bf16, so each gradient is held within 2e-2 of
# its own largest magnitude (about 5x the 2^-8 a sum of such roundings
# reaches)
K9_REL_TOL = 2e-2

BWD_CASES = {
    "causal_hd256": dict(b=2, s=256, hd=256, kv_len=None, q_offset=0, causal=True),
    "causal_hd128_blocks": dict(b=1, s=384, hd=128, kv_len=None, q_offset=0, causal=True),
    "kv_len_masked_row_hd128": dict(b=2, s=200, hd=128, kv_len=[200, 0], q_offset=0,
                                    causal=True),
    "kv_len_hd256": dict(b=2, s=256, hd=256, kv_len=[149, 256], q_offset=0, causal=True),
    "q_offset_hd256": dict(b=1, s=128, hd=256, kv_len=None, q_offset=128, causal=True,
                           s_k=256),
    "not_causal_hd128": dict(b=1, s=256, hd=128, kv_len=[100], q_offset=0, causal=False),
    "train_hd256": dict(b=2, s=2048, hd=256, kv_len=None, q_offset=0, causal=True),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_backward_kernels_match_plain(case, dev):
    from magma_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_dkv_kernel,
                                                     flash_attention_bwd_dq_kernel,
                                                     flash_attention_bwd_plain)

    c = BWD_CASES[case]
    s_k = c.get("s_k", c["s"])
    q, k, v = _qkv(dev, c["b"], c["s"], s_k, c["hd"], seed=3)
    kv_len = (None if c["kv_len"] is None
              else torch.tensor(c["kv_len"], dtype=torch.int32, device=dev))
    kw = dict(scale=c["hd"] ** -0.5, causal=c["causal"], kv_len=kv_len, q_offset=c["q_offset"])
    o, lse = flash_attention_plain(q, k, v, **kw)
    do = torch.randn(o.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(4)
                     ).to(torch.bfloat16)
    before = (flash_attention_bwd_dkv_kernel.launches, flash_attention_bwd_dq_kernel.launches)
    got = flash_attention_bwd(q, k, v, o, lse.contiguous(), do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkv_kernel.launches, flash_attention_bwd_dq_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all(), name
        err = (a.float() - r).abs().max().item()
        assert err <= K9_REL_TOL * r.abs().max().item() + 1e-6, (name, err)
    if case == "kv_len_masked_row_hd128":  # the fully masked row's gradients are 0
        assert not got[0][1].any() and not got[1][1].any() and not got[2][1].any()


def test_flash_attention_grad_runs_k9(dev):
    """torch.autograd through ``flash_attention``: one K1, one K9a, one K9b;
    q, k, v gradients within the tolerance of the plain einsum path's."""
    from magma_tpu_torch.ops.attention import xla_attention
    from magma_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv_kernel,
                                                     flash_attention_bwd_dq_kernel)

    q, k, v = (t.requires_grad_() for t in _qkv(dev, 2, 200, 200, 256, seed=5))
    kv_len = torch.tensor([200, 77], dtype=torch.int32, device=dev)
    g = torch.randn((2, 200, 4, 256), device=dev).to(torch.bfloat16)
    before = [f.launches for f in (flash_attention_kernel, flash_attention_bwd_dkv_kernel,
                                   flash_attention_bwd_dq_kernel)]
    o = flash_attention(q, k, v, scale=1 / 16, kv_len=kv_len)
    got = torch.autograd.grad(o, (q, k, v), g)
    after = [f.launches for f in (flash_attention_kernel, flash_attention_bwd_dkv_kernel,
                                  flash_attention_bwd_dq_kernel)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(xla_attention(qf, kf, vf, scale=1 / 16, kv_len=kv_len).float(),
                              (qf, kf, vf), g.float())
    for a, r in zip(got, ref):
        assert (a.float() - r).abs().max().item() <= K9_REL_TOL * r.abs().max().item()


def test_flash_attention_grad_runs_wgmma_body_and_k9(dev):
    """torch.autograd through ``flash_attention`` at a shape of K1's wgmma
    body: one K1 (on that body), one K9a, one K9b; the gradients within
    K9_REL_TOL of the plain einsum path's."""
    from magma_tpu_torch.ops.attention import xla_attention
    from magma_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_bwd_dkv_kernel,
                                                     flash_attention_bwd_dq_kernel)

    b, s, h, hd = 2, 1024, 16, 256
    q, k, v = (t.requires_grad_() for t in _qkv(dev, b, s, s, hd, seed=14, h=h))
    kv_len = torch.tensor([1024, 700], dtype=torch.int32, device=dev)
    g = torch.randn((b, s, h, hd), device=dev).to(torch.bfloat16)
    fns = (flash_attention_kernel, flash_attention_bwd_dkv_kernel, flash_attention_bwd_dq_kernel)
    before = [f.launches for f in fns] + [flash_attention_kernel.wgmma_launches]
    o = flash_attention(q, k, v, scale=hd ** -0.5, kv_len=kv_len)
    got = torch.autograd.grad(o, (q, k, v), g)
    after = [f.launches for f in fns] + [flash_attention_kernel.wgmma_launches]
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1, 1]
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(xla_attention(qf, kf, vf, scale=hd ** -0.5, kv_len=kv_len).float(),
                              (qf, kf, vf), g.float())
    for a, r in zip(got, ref):
        assert (a.float() - r).abs().max().item() <= K9_REL_TOL * r.abs().max().item()


def _bwd_inputs(dev, b, s, h, hd, seed):
    r = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(r.standard_normal((b, s, h, hd), dtype=np.float32))
                   .to(dev, torch.bfloat16) for _ in range(4))
    return q, k, v, do


@pytest.mark.parametrize("case", ["causal_hd256", "kv_len_masked_row_hd128", "q_offset_hd256",
                                  "not_causal_hd128"])
def test_flash_backward_kernels_repeat_bit_for_bit(case, dev):
    """Each gradient element is one thread's fixed-order sum: two runs on the
    same inputs give the same bits."""
    from magma_tpu_torch.ops.flash_attention import flash_attention_bwd

    c = BWD_CASES[case]
    q, k, v = _qkv(dev, c["b"], c["s"], c.get("s_k", c["s"]), c["hd"], seed=6)
    kv_len = (None if c["kv_len"] is None
              else torch.tensor(c["kv_len"], dtype=torch.int32, device=dev))
    kw = dict(scale=c["hd"] ** -0.5, causal=c["causal"], kv_len=kv_len, q_offset=c["q_offset"])
    o, lse = flash_attention_plain(q, k, v, **kw)
    do = torch.randn(o.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(7)
                     ).to(torch.bfloat16)
    first = flash_attention_bwd(q, k, v, o, lse.contiguous(), do, **kw)
    second = flash_attention_bwd(q, k, v, o, lse.contiguous(), do, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_backward_kernels_read_path_b_strided_v(dev):
    """Path B hands K9a/K9b v as a view of the fused in_proj output ([q | k |
    v | fc_in] columns, an s stride of 3 D + 4 D): the tensor maps read it
    in place, to the bits of the same values made contiguous, and within
    the tolerance of the plain backward."""
    from magma_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain)

    b, s, h, hd = 2, 256, 4, 256
    d = h * hd
    q, k, _, do = _bwd_inputs(dev, b, s, h, hd, seed=8)
    fused = torch.randn((b, s, 3 * d + 4 * d), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9)).to(torch.bfloat16)
    v = fused[..., 2 * d:3 * d].reshape(b, s, h, hd)
    assert v.stride() == (s * 7 * d, 7 * d, hd, 1)
    kw = dict(scale=hd ** -0.5, causal=True, kv_len=None, q_offset=0)
    o, lse = flash_attention_plain(q, k, v, **kw)
    lse = lse.contiguous()
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    dense = flash_attention_bwd(q, k, v.contiguous(), o, lse, do, **kw)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, a, a_dense, r in zip(("dq", "dk", "dv"), got, dense, ref):
        assert torch.equal(a, a_dense), name
        assert (a.float() - r).abs().max().item() <= K9_REL_TOL * r.abs().max().item(), name


# the wgmma forms of csrc/tma_wgmma.cuh that K9a/K9b and K1's wgmma body
# build on, one warpgroup each (magma_wgmma_forms_check in
# csrc/wgmma_forms.cu): id -> (B K-major, N, K, seed).  B K-major: ss, A
# and B from shared memory (D = A B^T, B given as (N, K)); B MN-major: rs,
# A from registers, B through trans-b (D = A B, B given as (K, N)).  Small
# integers make every sum exact, so D equals torch.matmul's fp32 result bit
# for bit.
WGMMA_FORMS = {
    "ss_n64_k256": (True, 64, 256, 320),
    "ss_n64_k128": (True, 64, 128, 192),
    "ss_n48_k256": (True, 48, 256, 1304),
    "ss_n80_k256": (True, 80, 256, 4336),
    "ss_n80_k128": (True, 80, 128, 4208),
    "rs_trans_b_n256_k64": (False, 256, 64, 2320),
    "rs_trans_b_n256_k48": (False, 256, 48, 2304),
    "rs_trans_b_n256_k32": (False, 256, 32, 2288),
    "rs_trans_b_n128_k64": (False, 128, 64, 3192),
}


@pytest.mark.parametrize("name", sorted(WGMMA_FORMS))
def test_wgmma_forms_match_matmul(name, dev):
    import ctypes

    from magma_tpu_torch.cuda_build import load_library

    kmajor, n, k, seed = WGMMA_FORMS[name]
    r = np.random.default_rng(seed)
    a = torch.from_numpy(r.integers(-4, 5, (64, k)).astype(np.float32)).to(dev, torch.bfloat16)
    b_shape = (n, k) if kmajor else (k, n)
    b = torch.from_numpy(r.integers(-4, 5, b_shape).astype(np.float32)).to(dev, torch.bfloat16)
    d = torch.full((64, n), float("nan"), dtype=torch.float32, device=dev)
    fn = load_library().magma_wgmma_forms_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), n, k, int(kmajor),
             torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0, f"cudaError {err}"
    ref = torch.matmul(a.float(), b.float().T if kmajor else b.float())
    torch.cuda.synchronize()
    assert torch.equal(d, ref), (d - ref).abs().max().item()


@pytest.mark.parametrize("shape", [(5, 256, 384), (9, 384, 640), (192, 512, 1024),
                                   (2048, 4096, 4096), (256, 4096, 50304)],
                         ids=["small", "m9_ragged_k", "m192", "qlora_o", "qlora_head"])
def test_int8_dx_kernel_matches_plain(shape, dev):
    """Rows past M and dx columns past K (a 256-wide tile over K = 384) are
    zero-filled and never stored; the head's 32 tiles at M = 256 split N over
    a cluster and add the parts in rank order: the same bits on a repeat."""
    m, k, n = shape
    g = torch.Generator(device=dev).manual_seed(6)
    grad = torch.randn((m, n), generator=g, device=dev)
    wq = torch.randint(-127, 128, (2, k, n), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((2, n), generator=g, device=dev) * 1e-3 + 1e-4
    before = quant.int8_matmul_dx_kernel.launches
    dx = quant.int8_matmul_dx_kernel(grad, wq[1], s[1])
    torch.cuda.synchronize()
    assert quant.int8_matmul_dx_kernel.launches == before + 1
    ref = quant.int8_matmul_dx_plain(grad, wq[1], s[1])
    gs = (grad * s[1]).to(torch.bfloat16)
    # products of bf16 values are exact in fp32: only the summation order differs
    tol = 2 * n * 2.0 ** -24 * (gs.float().abs() @ wq[1].float().abs().T) + 1e-30
    assert ((dx - ref).abs() <= tol).all()
    assert torch.equal(dx, quant.int8_matmul_dx_kernel(grad, wq[1], s[1]))


def test_int8_matmul_grad_runs_k10(dev):
    """autograd through int8_matmul_stacked and int8_matmul: K2b/K2a forward,
    K10 backward, no gradient for the weights or scales."""
    x, wq, s = _int8_inputs(dev, 37, 512, 384)
    x = x.requires_grad_()
    before = quant.int8_matmul_dx_kernel.launches
    y = quant.int8_matmul_stacked(x, wq, s, 1, out_dtype=torch.bfloat16)
    y2 = quant.int8_matmul(x, wq[0], s[0])
    g1 = torch.randn_like(y)
    (gx,) = torch.autograd.grad((y.float() * g1.float()).sum() + y2.sum(), (x,))
    assert quant.int8_matmul_dx_kernel.launches == before + 2
    assert gx.dtype == torch.bfloat16 and not wq.requires_grad and wq.grad is None
    terms = [(g1.float(), wq[1], s[1]), (torch.ones((37, 384), device=dev), wq[0], s[0])]
    r1, r2 = (quant.int8_matmul_dx_plain(*t) for t in terms)
    # gx = bf16(bf16(dx1) + bf16(dx2)): autograd rounds each product's dx to
    # x's dtype and sums the two in it.  Each of the three roundings is within
    # 2^-8 of its value; the kernel's fp32 summation order adds up to
    # 2 n 2^-24 (|g s| @ |W|^T) to each dx before they round.
    order = sum(2 * 384 * 2.0 ** -24 * ((gg * ss).to(torch.bfloat16).float().abs()
                                        @ w.float().abs().T) for gg, w, ss in terms)
    tol = 2.0 ** -8 * (1 + 2.0 ** -8) * (r1.abs() + r2.abs() + (r1 + r2).abs()) + 2 * order
    assert ((gx.float() - (r1 + r2)).abs() <= tol).all()


@pytest.mark.parametrize("bad", ["bf16_g", "k_not_128", "cpu_w", "wrong_n"])
def test_training_wrappers_raise_on_what_they_do_not_take(bad, dev):
    g = torch.randn((4, 256), device=dev)
    wq = torch.zeros((256, 256), dtype=torch.int8, device=dev)
    s = torch.ones((256,), device=dev)
    if bad == "bf16_g":
        g = g.to(torch.bfloat16)
    elif bad == "k_not_128":
        wq = torch.zeros((200, 256), dtype=torch.int8, device=dev)
    elif bad == "cpu_w":
        wq = wq.cpu()
    else:
        g = torch.randn((4, 384), device=dev)
    before = quant.int8_matmul_dx_kernel.launches
    with pytest.raises((TypeError, ValueError)):
        quant.int8_matmul_dx_kernel(g, wq, s)
    assert quant.int8_matmul_dx_kernel.launches == before


@pytest.mark.parametrize("layout", ["bf16", "qlora"])
def test_train_step_reads_nothing_from_the_card(layout, dev):
    """``Trainer.train_step(sync=False)`` on a tiny model (2 layers, one
    128-wide head, K1/K9 and in the QLoRA layout K2a/K2b/K10) queues a whole
    step, the optimizer's decisions included, without the host waiting for
    the card: under ``set_sync_debug_mode("error")`` any synchronising call
    raises."""
    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.training.train_loop import Trainer

    qlora = layout == "qlora"
    cfg = MultimodalConfig(
        batch_size=4, train_steps=4, gradient_accumulation_steps=2, lr=2e-3, warmup_num_steps=1,
        gradient_clipping=1.0, image_enc_lr=1e-3, encoder_name="clip_resnet_large",
        adapter_config={"mlp": {"adapter_type": "normal", "downsample_factor": 4}},
        use_image_embed_layernorm=True, image_embed_dropout_prob=0.1,
        freeze_img_encoder=qlora, train_lm_int8=qlora, image_size=64, mesh_dp=1, mesh_tp=1,
        lm_overrides=dict(n_layers=2, n_heads=1, d_model=128, d_ff=512, rotary_dim=16,
                          max_seq_len=64, attention_impl="flash"),
        encoder_overrides=dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64))
    trainer = Trainer(Magma(cfg, seed=0, device=dev), cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn((4, 3, 64, 64), generator=g, device=dev)
    captions = torch.full((4, 64), 50256, dtype=torch.long, device=dev)
    captions[:, :20] = torch.randint(0, 50000, (4, 20), generator=g, device=dev)
    trainer.train_step(images, captions)  # loads the kernels; returns a float
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [trainer.train_step(images, captions, sync=False) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(isinstance(x, torch.Tensor) and x.is_cuda for x in losses)
    assert torch.isfinite(torch.stack(losses)).all()
    assert int(trainer.optimizer.count) == 4 and int(trainer.optimizer.total_notfinite) == 0


# ---------------------------------------------------------------------------
# The serving engine on the card: its decode windows (K8 at one slot; K2b,
# K4a, K5 or K3 and K6 at 8; the int8 and W4A8 tiles and K5 at 16), a step
# at cache_index = max_len, and a dispatch that waits for nothing
# ---------------------------------------------------------------------------

# a decode step through the kernels against the plain path (the same model
# on the CPU): JAX's bound for two decode paths of one model
# (tests/test_decode_layer.py:92-107), logits within 3e-2 of their largest
# magnitude, argmax equal
SERVE_REL_TOL = 3e-2
SERVE_L, SERVE_MAX_LEN = 2, 256


def _serving_lm(dev, fmt):
    """The kernels' geometry at 2 layers (8 heads of 256, d_model 2048,
    d_ff 2048), the v1 mlp adapter (fused: hidden 512); int8 weights over a
    bf16 cache or int4 weights over an int8 cache.  Returns (cfg, params on
    the CPU, params on the card)."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.models.adapters import AdapterSpec

    cfg = gptj.GPTJConfig.tiny(n_layers=SERVE_L, n_heads=8, d_model=2048, d_ff=2048,
                               rotary_dim=64, attention_impl="flash", param_dtype=torch.bfloat16,
                               mlp_adapter=AdapterSpec("normal", 4),
                               kv_cache_dtype="int8" if fmt == "int4" else "bf16")
    params = gptj.init_params(torch.Generator().manual_seed(0), cfg)
    for proj in ("down", "up"):  # trained-scale adapters so they matter
        ad = params["blocks"]["adapter_mlp"][proj]
        ad["kernel"] = torch.randn(ad["kernel"].shape,
                                   generator=torch.Generator().manual_seed(1)) * 0.05
    quantize = gptj.quantize_lm_params_int4 if fmt == "int4" else gptj.quantize_lm_params
    params = quantize(params)
    return cfg, params, _to(params, dev)


def _serving_wrappers():
    from magma_tpu_torch.ops import decode_layer as dl

    return {n: getattr(quant, n) for n in (
        "int8_matmul_kernel", "int8_matmul_stacked_kernel", "dual_matmul_kernel",
        "fused_adapter_kernel", "int4_matmul_stacked_kernel", "int4_dual_kernel",
        "boundary_kernel")} | {"decode_all_layers_kernel": dl.decode_all_layers_kernel}


def _want_window_launches(fmt, B, steps):
    """Launches of ``steps`` decode steps of a B-row pool."""
    L = SERVE_L
    inproj = "int4_matmul_stacked_kernel" if fmt == "int4" else "int8_matmul_stacked_kernel"
    if B == 1:  # layer 0's in_proj, then all layers in one K8
        want = {inproj: 1, "decode_all_layers_kernel": 1}
    elif fmt == "int4" and B <= 8:  # layer 0's in_proj, then K6 a layer
        want = {inproj: 1, "boundary_kernel": L}
    else:
        dual = "int4_dual_kernel" if fmt == "int4" else "dual_matmul_kernel"
        want = {inproj: L, dual: L, "fused_adapter_kernel": L}
    want["int8_matmul_kernel"] = 1  # the head
    return {n: want.get(n, 0) * steps for n in _serving_wrappers()}


def _admitted_engine(dev, cfg, params, B, **kw):
    """An engine of one (B, 256) pool with B requests of 40-100 positions
    installed (its prefills: K1 and the prefill products)."""
    from magma_tpu_torch.serving import LMServingEngine

    eng = LMServingEngine(cfg, params, cache_classes=((B, SERVE_MAX_LEN),), device=dev,
                          decode_window=2, prefill_bucket=64, **kw)
    g = torch.Generator().manual_seed(5)
    for i in range(B):
        s = 40 + (i * 37) % 61
        eng.submit(torch.randn((s, cfg.d_model), generator=g).to(torch.bfloat16),
                   max_new_tokens=8)
    eng._admit({})
    assert all(s is not None for s in eng.groups[0].slots)
    return eng


def _window_logits(cfg, params, cache, last, lens, dev, steps=2, force=None):
    """``steps`` greedy decode steps of a pool through the engine's window,
    recording each step's logits; ``force`` (B, steps) feeds those tokens
    instead of the argmax.  Returns (logits (steps, B, V), tokens)."""
    from magma_tpu_torch.serving import engine as teng

    seen = []

    def greedy(_, logits):
        seen.append(logits.float().cpu())
        if force is not None:
            return force[:, len(seen) - 1].to(logits.device)
        return logits.argmax(-1)

    B = last.shape[0]
    with torch.no_grad():
        _, toks = teng._decode(cfg, params, cache, last.to(dev), lens.to(dev),
                               torch.ones(B, dtype=torch.bool, device=dev), None, greedy,
                               n_steps=steps, eos_token=50256)
    return torch.stack(seen), toks.cpu()


@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_engine_window_matches_plain_path(fmt, B, dev):
    """A pool's decode window on the card against the same window of the
    same model on the CPU (the plain versions), fed the card's tokens:
    logits within SERVE_REL_TOL of their largest magnitude at each step;
    the same bits on a repeat; exact launches.  (K8 sits within 2^-3 of
    its plain version's y after its layers, so a near tie may take
    another argmax: the tokens are not held.)"""
    cfg, cpu_params, params = _serving_lm(dev, fmt)
    eng = _admitted_engine(dev, cfg, params, B, pipeline_windows=False)
    g = eng.groups[0]
    last = torch.from_numpy(g.last_toks.copy())
    lens = torch.from_numpy(g.cur_lens.copy())
    state = {k: t.clone() for k, t in g.cache.items()}
    wrappers = _serving_wrappers()
    before = {n: fn.launches for n, fn in wrappers.items()}
    got, toks = _window_logits(cfg, params, {k: t.clone() for k, t in state.items()}, last,
                               lens, dev)
    torch.cuda.synchronize()
    assert {n: fn.launches - before[n] for n, fn in wrappers.items()} == \
        _want_window_launches(fmt, B, 2)
    again, toks2 = _window_logits(cfg, params, {k: t.clone() for k, t in state.items()}, last,
                                  lens, dev)
    assert torch.equal(got, again) and torch.equal(toks, toks2)
    ref, _ = _window_logits(cfg, cpu_params, {k: t.cpu() for k, t in state.items()}, last,
                            lens, torch.device("cpu"), force=toks)
    for step in range(got.shape[0]):
        rel = ((got[step] - ref[step]).abs().max() / ref[step].abs().max()).item()
        assert rel <= SERVE_REL_TOL, (step, rel)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_decode_step_at_max_len(fmt, b, dev):
    """A decode step of rows whose cache is full (cache_index = max_len, as
    a slot retired for "length" rides along in the engine): K8 (b = 1) or
    the b <= 8 path (int8: K5 a layer; int4: K6 a layer) run without a
    fault, the logits agree with the plain path's (SERVE_REL_TOL), the
    write clamps to position max_len - 1 and every other position keeps
    its bytes."""
    from magma_tpu_torch.models import gptj

    cfg, cpu_params, params = _serving_lm(dev, fmt)
    L, h, hd, n = cfg.n_layers, cfg.n_heads, cfg.head_dim, SERVE_MAX_LEN
    g = torch.Generator().manual_seed(9)
    cache = gptj.init_kv_cache(cfg, b, n)
    gptj._write_cache(cache, *(torch.randn((L, b, n, h, hd), generator=g).to(torch.bfloat16)
                               for _ in range(2)), 0)
    x = torch.randn((b, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    idx = torch.full((b,), n, dtype=torch.int32)
    on_card = {k: t.to(dev) for k, t in cache.items()}
    wrappers = _serving_wrappers()
    before = {k: fn.launches for k, fn in wrappers.items()}
    with torch.no_grad():
        logits, on_card = gptj.forward(cfg, params, x.to(dev), cache=on_card,
                                       cache_index=idx.to(dev))
    torch.cuda.synchronize()
    got = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    assert got == _want_window_launches(fmt, b, 1)
    ref_cache = {k: t.clone() for k, t in cache.items()}
    with torch.no_grad():
        ref, ref_cache = gptj.forward(cfg, cpu_params, x, cache=ref_cache, cache_index=idx)
    logits = logits.float().cpu()
    assert torch.isfinite(logits).all()
    rel = ((logits - ref).abs().max() / ref.abs().max()).item()
    assert rel <= SERVE_REL_TOL, rel
    for k, t in on_card.items():
        t = t.cpu()
        pos = (slice(None),) * (3 if k.endswith("_scale") else 2)
        keep = pos + (slice(0, n - 1),)
        assert torch.equal(t[keep], cache[k][keep]), k  # untouched below max_len - 1
        last = pos + (slice(n - 1, n),)
        assert not torch.equal(t[last], cache[k][last]), k  # the clamped write
        assert torch.equal(ref_cache[k][keep], cache[k][keep]), k  # the plain path's too


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_engine_dispatch_waits_for_nothing(fmt, dev, monkeypatch):
    """Every step's admission, prefills, chunks, installs and window
    dispatches run under ``set_sync_debug_mode("error")``: only the
    collect of the previous window (the one device-to-host copy a window)
    reads the card.  Greedy, top_k = 1, sampled and top-p rows, and a
    chunked prompt riding the windows."""
    cfg, _, params = _serving_lm(dev, fmt)
    from magma_tpu_torch.serving import LMServingEngine

    eng = LMServingEngine(cfg, params, cache_classes=((8, SERVE_MAX_LEN),), device=dev,
                          decode_window=2, prefill_bucket=64, prefill_chunk=64)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randn((s, cfg.d_model), generator=g).to(torch.bfloat16).to(dev)
               for s in (45, 70, 33, 150, 20)]
    sampling = [{}, dict(temperature=0.8, top_k=1), dict(temperature=1.0),
                dict(temperature=0.7, top_p=0.9), dict(temperature=0.7, top_k=5, top_p=0.5)]
    ids = [eng.submit(p, max_new_tokens=6, **kw) for p, kw in zip(prompts, sampling)]
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):  # the mode is on where it is set
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch.ones(1, device=dev).item()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    orig = eng._collect_window
    collects = []

    def collect(gi, prev, emitted):
        torch.cuda.set_sync_debug_mode(0)
        collects.append(prev is not None)
        orig(gi, prev, emitted)

    monkeypatch.setattr(eng, "_collect_window", collect)
    steps = 0
    while eng.has_work:
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        steps += 1
        assert steps < 50
    assert any(collects)
    res = eng.finished
    assert set(res) == set(ids)
    for r in ids:
        assert 1 <= len(res[r].tokens) <= 6 and res[r].finish_reason in ("eos", "length")
        assert all(0 <= t < cfg.vocab_size for t in res[r].tokens)


# ---------------------------------------------------------------------------
# The pooled towers, the loader's pinned batches and the train CLI on the card
# ---------------------------------------------------------------------------

# a tower's prefix in fp32 on the card (TF32 off) against the same weights
# in fp32 on the CPU: another summation order, compounded over the blocks;
# each element within 1e-4 of the CPU prefix's largest magnitude
TOWER_REL_TOL = 1e-4


def _tree_to(tree, dev):
    from magma_tpu_torch.utils import tree_map

    return tree_map(lambda t: t.to(dev), tree)


@pytest.mark.parametrize("name,ov", [
    ("clip", {}),  # the ViT-B/32 at its published widths
    ("nfresnet50", dict(width=16, blocks=(1, 2, 1, 1), input_resolution=96)),
    ("clip_resnet_large", dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64)),
], ids=["vit_b32", "nfresnet", "clip_resnet"])
def test_tower_prefix_on_the_card_matches_the_cpu(name, ov, dev):
    from magma_tpu_torch.models import image_prefix as ip_mod

    allow = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = ip_mod.ImagePrefixConfig(
            encoder_name=name, out_dim=256, use_layernorm=True, dropout_prob=0.1,
            encoder_overrides=tuple(sorted(dict(ov, compute_dtype=torch.float32).items())),
            compute_dtype=torch.float32)
        params, stats = ip_mod.init_params(torch.Generator().manual_seed(0), cfg)
        res = cfg.input_resolution
        images = torch.randn((2, 3, res, res), generator=torch.Generator().manual_seed(1))
        ref, _ = ip_mod.apply(params, stats, images, cfg)
        out, _ = ip_mod.apply(_tree_to(params, dev), _tree_to(stats, dev), images.to(dev), cfg)
        assert out.shape == ref.shape == (2, cfg.out_seq_len, 256)
        err = (out.cpu() - ref).abs().max() / ref.abs().max()
        assert err <= TOWER_REL_TOL, err
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = allow


def test_loader_pins_batches_and_the_trainer_copies_them_async(dev):
    """BatchLoader(device="cuda") yields pinned host tensors; the Trainer's
    copy of them to the card is non-blocking and gives the same values."""
    from magma_tpu_torch.data.loader import BatchLoader
    from magma_tpu_torch.training.train_loop import Trainer

    class DS:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return np.full((1, 3, 4, 4), i, np.float32), np.full((1, 8), i, np.int32)

    loader = BatchLoader(DS(), batch_size=4, gradient_accumulation_steps=2, seq_len=8,
                         num_workers=2, device=dev)
    try:
        images, captions = next(loader)
    finally:
        loader.close()
    assert images.is_pinned() and captions.is_pinned() and images.shape == (2, 2, 3, 4, 4)
    trainer = Trainer.__new__(Trainer)
    trainer.device, trainer.config = dev, type("C", (), {"run_blind": False})()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gi, gc = trainer._batch(images, captions)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert gi.is_cuda and gc.dtype == torch.long
    assert torch.equal(gi.cpu(), images) and torch.equal(gc.cpu(), captions.long())


def test_train_cli_two_steps_on_the_card(dev, tmp_path):
    """``magma_tpu_torch.train.main`` at a tiny width on the card: 2 steps
    from JPEGs on disk (K1 and K9 on a 128-wide head), eval, captions, VQA,
    a save, all logged."""
    import json

    from PIL import Image

    from magma_tpu_torch import train

    rng = np.random.default_rng(0)
    for sub, n in (("train", 8), ("vqa", 2)):
        (tmp_path / sub / "images" / "0").mkdir(parents=True)
        (tmp_path / sub / "image_data" / "0").mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40 + 8 * i, 64, 3), dtype=np.uint8)).save(
                tmp_path / sub / "images" / "0" / f"{i}.jpg")
            rec = {"image_path": f"images/0/{i}.jpg", "captions": [f"picture {i}"],
                   "metadata": {"question": "what is it?", "answers": ["thing"]}}
            (tmp_path / sub / "image_data" / "0" / f"{i}.json").write_text(json.dumps(rec))
    yml = tmp_path / "tiny.yml"
    yml.write_text(f"""{{
 encoder_name: 'clip_resnet_large', batch_size: 4, gradient_accumulation_steps: 2,
 train_steps: 2, log_every: 1, eval_every: 2, eval_steps: 1, save_every: 2,
 save: '{tmp_path}/ckpt', load: null, train_dataset_dir: '{tmp_path}/train',
 eval_dataset_dir: null, eval_dataset_pct: 0.25, vqa_dir: '{tmp_path}/vqa', image_size: 64,
 num_workers: 2, warmup_num_steps: 1,
 adapter_config: {{"mlp": {{"adapter_type": "normal", "downsample_factor": 4}}}},
 use_image_embed_layernorm: true, image_embed_dropout_prob: 0.1,
 lm_overrides: {{n_layers: 2, n_heads: 1, d_model: 128, d_ff: 512, rotary_dim: 16,
                 max_seq_len: 64}},
 encoder_overrides: {{width: 16, blocks: [1, 1, 1, 1], input_resolution: 64}},
}}""")
    before = flash_attention_kernel.launches
    trainer = train.main(["--config", str(yml)])
    assert trainer.global_step == 2 and trainer.device.type == "cuda"
    assert flash_attention_kernel.launches > before
    log = [json.loads(x) for x in (tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    losses = [m["train/loss"] for m in log if "train/loss" in m]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert any("eval/loss" in m for m in log) and any("eval/vqa_accuracy" in m for m in log)
    assert (tmp_path / "ckpt" / "latest").read_text() == "step_2"


# ---------------------------------------------------------------------------
# Parallelism: the padded head shard, a ring step's merge, NCCL at world 1
# ---------------------------------------------------------------------------


def test_padded_head_shard_kernel_matches_plain(dev):
    """K2a on the int8 head's tp 2 shard (50304 / 2 = 25152 columns, zero-
    padded to 25216 by ``shard_lm_params``): the kernel takes it, its real
    columns equal the plain version's, the padding gives 0."""
    from magma_tpu_torch.parallel import sharding
    from magma_tpu_torch.parallel.mesh import Mesh

    r = np.random.default_rng(5)
    wte = torch.from_numpy(r.standard_normal((50304, 512), dtype=np.float32) * 0.02)
    head = quant.quantize_int8(wte.T.contiguous(), compiled=True)
    mesh = Mesh(np.arange(2).reshape(1, 2), ("dp", "tp"), 1, [0, 1], {})
    shard = sharding.shard_lm_params(mesh, {"lm_head_q": head})["lm_head_q"]
    assert shard["q"].shape == (512, 25216) and not shard["q"][:, 25152:].any()
    x = torch.from_numpy(r.standard_normal((3, 512), dtype=np.float32)).to(dev, torch.bfloat16)
    q, s = shard["q"].to(dev), shard["s"].to(dev)
    before = quant.int8_matmul_kernel.launches
    got = quant.int8_matmul(x, q, s)
    assert quant.int8_matmul_kernel.launches == before + 1
    want = quant.int8_matmul_plain(x, q, s)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    assert not got[:, 25152:].any()


def test_ring_step_merge_matches_flash(dev):
    """Rank 1 of a ring of 2 in one process: its diagonal block (causal)
    and its past block (unmasked) through K1, merged through their lse,
    against K1 over the whole sequence (that rank's rows); then the
    backward of both blocks through K9a/K9b under the merged O and lse
    against the flash backward of the whole sequence with the other rank's
    output gradient zero."""
    from magma_tpu_torch.ops.flash_attention import flash_attention_bwd
    from magma_tpu_torch.parallel import ring_attention as ring

    q, k, v = _qkv(dev, 1, 512, 512, 128, seed=3, h=2)
    scale, half = 128 ** -0.5, 256
    q1 = q[:, half:].contiguous()
    k0, v0, k1, v1 = (t.contiguous() for t in (k[:, :half], v[:, :half], k[:, half:],
                                                v[:, half:]))
    o_d, lse_d = ring._step_fwd(q1, k1, v1, scale=scale, causal=True)
    o_p, lse_p = ring._step_fwd(q1, k0, v0, scale=scale, causal=False)
    o, lse = ring._merge(o_d.float(), lse_d, o_p, lse_p)
    o = o.to(torch.bfloat16)
    o_ref, lse_ref = flash_attention_fwd(q, k, v, scale=scale, causal=True)
    assert ((o.float() - o_ref[:, half:].float()).abs()
            <= O_ATOL + O_RTOL * o_ref[:, half:].float().abs()).all()
    torch.testing.assert_close(lse, lse_ref[..., half:], atol=LSE_ATOL, rtol=0)

    r = np.random.default_rng(4)
    do = torch.from_numpy(r.standard_normal(tuple(q1.shape), dtype=np.float32)).to(
        dev, torch.bfloat16)
    lse = lse.contiguous()
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dq_d, dk1, dv1 = ring._step_bwd(q1, k1, v1, o, lse, do, di, scale=scale, causal=True)
    dq_p, dk0, dv0 = ring._step_bwd(q1, k0, v0, o, lse, do, di, scale=scale, causal=False)
    do_full = torch.cat([torch.zeros_like(do), do], dim=1)
    o_full = torch.cat([o_ref[:, :half], o], dim=1)
    lse_full = torch.cat([lse_ref[..., :half], lse], dim=-1).contiguous()
    dq, dk, dv = flash_attention_bwd(q, k, v, o_full, lse_full, do_full, scale=scale,
                                     causal=True)
    for got, want in ((dq_d.float() + dq_p.float(), dq[:, half:]),
                      (torch.cat([dk0, dk1], 1), dk), (torch.cat([dv0, dv1], 1), dv)):
        want = want.float()
        assert (got.float() - want).abs().max() <= 2e-2 * want.abs().max()


def test_init_distributed_nccl_at_world_1(dev, monkeypatch):
    """torchrun's environment for one rank: NCCL on cuda:0, and a mesh whose
    groups all_reduce a tensor on the card."""
    import socket

    import torch.distributed as dist

    from magma_tpu_torch.parallel.mesh import all_reduce, make_mesh
    from magma_tpu_torch.utils import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, val in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, val)
    assert init_distributed("cuda") == (0, 0, 1)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1, 1, sp=1)
        assert mesh.distributed and mesh.group(("dp", "tp")) is not None
        t = torch.arange(4.0, device=dev)
        assert torch.equal(all_reduce(t.clone(), mesh, "tp"), t)
    finally:
        dist.destroy_process_group()
