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


def _qkv(dev, b, s_q, s_k, hd, seed=0):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal((b, s, 4, hd), dtype=np.float32))
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


@pytest.mark.parametrize("m", [1, 3, 8, 9, 64])
@pytest.mark.parametrize("d, dh", [(512, 128), (4096, 1024)])
def test_fused_adapter_kernel_matches_plain(m, d, dh, dev):
    """h is rounded to bf16 in both: an h on a rounding boundary may land
    one bf16 ulp (2^-8 relative) apart, which moves out by at most
    2^-8 |h| |Wu| su; the sums differ as in the int8 products."""
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
    (normal); "scaled" adds an attention adapter fed from u_in, with o_bias."""
    from magma_tpu_torch.ops import quant

    D, F, L = 4096, 16384, 2
    qo, so = _int4_stack(dev, D, D, seed=6)
    qf, sf = _int4_stack(dev, F, D, seed=7)
    qi, si = _int4_stack(dev, D, 3 * D + F, seed=8)
    g = torch.Generator(device=dev).manual_seed(9)

    def vec(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev) * std

    def adapter():
        return quant.quantize_adapter_fused(vec(L, D, 1024, std=0.05), vec(L, 1024),
                                            vec(L, 1024, D, std=0.05), vec(L, D),
                                            out_scale=torch.tensor([1.5, -0.75], device=dev))

    kw = dict(fz_mlp=adapter(), mlp_src="out")
    if variant == "scaled":
        kw.update(fz_attn=adapter(), attn_src="in", o_bias=vec(L, D))
    return ({"q4": torch.cat([qo, qf], 1), "s4": torch.cat([so, sf], 1)},
            {"q4": qi, "s4": si}, vec(L, D), 1 + vec(L, D, std=0.1), vec(L, D), kw)


@pytest.mark.parametrize("w_in", [True, False], ids=["with_w_in", "last_layer"])
@pytest.mark.parametrize("variant", ["v1", "scaled"])
@pytest.mark.parametrize("m", [1, 8])
def test_boundary_kernel_matches_plain(m, variant, w_in, dev):
    """K6 against the composition of the plain K4b, K5 and K3.  The dual
    and in_proj sums are the plain version's bits; the adapters' int8 sums
    run in another order than PyTorch's matmul and the LN statistics in
    another order than torch's mean and var, so an h, a z or a u on a bf16
    rounding boundary may land one bf16 ulp apart and carry into y and
    fused: each output within 2^-6 of its largest magnitude, and at least
    90% of its elements equal."""
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
        assert (diff == 0).float().mean() >= 0.9
    again = quant.boundary_fused_stacked(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
    8192), a filled cache and the layer inputs, all from seeds on the card."""
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

    kw = dict(n_heads=D // 256, scale=1 / 16, fz_mlp=adapter(), mlp_src="out")
    if recipe == "scaled":
        kw.update(fz_attn=adapter(), attn_src="in", o_bias=randn(L, D, std=0.02))
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
@pytest.mark.parametrize("recipe", ["v1", "scaled"])
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


@pytest.mark.parametrize("pos", [37, 0])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_all_layers_kernel_matches_plain(fmt, kv, pos, dev):
    from magma_tpu_torch.ops import decode_layer as dl
    from magma_tpu_torch.ops.rotary import rotary_sincos

    dual, w_in, (bfi, bfo, ln_g, ln_b), (kc, vc, kvs), _, ins, kw = \
        _declayer_payloads(dev, fmt, kv, "scaled")
    sincos = rotary_sincos(torch.tensor([pos], device=dev), 64)
    args = (ins["fused"], ins["x"], ins["u"], sincos, kc, vc, kvs,
            torch.tensor([pos], dtype=torch.int32, device=dev), dual, w_in, bfi, bfo, ln_g, ln_b)
    before = dl.decode_all_layers_kernel.launches
    got = dl.decode_all_layers_fused(*args, **kw)
    torch.cuda.synchronize()
    assert dl.decode_all_layers_kernel.launches == before + 1
    ref = dl.decode_all_layers_plain(*args, **kw)
    assert got[1].shape == (3, 1, 2048)
    _check_k7_like(got[:1], ref[:1], ("y",), K8_REL_TOL, K8_MIN_EQUAL)
    # layer 0's rows come before any chained difference
    _check_k7_like((got[1][0], got[2][0]), (ref[1][0], ref[2][0]), ("k_new", "v_new"), 0, 1)


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


# the wgmma forms of csrc/tma_wgmma.cuh that K9a/K9b build on, one
# warpgroup each (magma_wgmma_forms_check in csrc/flash_attn_bwd.cu):
# id -> (form, N, K).  Forms 0, 1: A and B from shared memory, both K-major
# (D = A B^T, B given as (N, K)); 2, 3: A from registers, B MN-major through
# trans-b (D = A B, B given as (K, N)).  Small integers make every sum exact,
# so D equals torch.matmul's fp32 result bit for bit.
WGMMA_FORMS = {
    "ss_n64_k256": (0, 64, 256),
    "ss_n64_k128": (0, 64, 128),
    "ss_n48_k256": (1, 48, 256),
    "rs_trans_b_n256_k64": (2, 256, 64),
    "rs_trans_b_n256_k48": (2, 256, 48),
    "rs_trans_b_n256_k32": (2, 256, 32),
    "rs_trans_b_n128_k64": (3, 128, 64),
}


@pytest.mark.parametrize("name", sorted(WGMMA_FORMS))
def test_wgmma_forms_match_matmul(name, dev):
    import ctypes

    from magma_tpu_torch.cuda_build import load_library

    form, n, k = WGMMA_FORMS[name]
    r = np.random.default_rng(form * 1000 + n + k)
    a = torch.from_numpy(r.integers(-4, 5, (64, k)).astype(np.float32)).to(dev, torch.bfloat16)
    b_shape = (n, k) if form < 2 else (k, n)
    b = torch.from_numpy(r.integers(-4, 5, b_shape).astype(np.float32)).to(dev, torch.bfloat16)
    d = torch.full((64, n), float("nan"), dtype=torch.float32, device=dev)
    fn = load_library().magma_wgmma_forms_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), form, k,
             torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0, f"cudaError {err}"
    ref = torch.matmul(a.float(), b.float().T if form < 2 else b.float())
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
