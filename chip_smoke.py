#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``magma_tpu_torch``) through its caption
paths once on one NVIDIA GPU, and check what comes out.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases (any failed check or exception ends the run with a non-zero exit):

0. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and convolutions.
1. Build: the CUDA kernels from ``magma_tpu_torch/csrc`` (one nvcc per
   source, all started together, sm_90a), with ptxas's resource report.
2. K1 (flash attention) against its plain PyTorch version on the same bf16
   inputs at the caption prefill's shapes; kernel, plain version and one
   ``scaled_dot_product_attention`` call with the same boolean mask timed
   (median of CUDA events).
2b. The int8 kernels against their plain versions on seeded bf16/int8
   inputs at the slice's shapes: K2b (in_proj) at M = 1, 5, 37, 192, K4a
   (o_proj + fc_out) at M = 1, 192, K5 (the adapter) at M = 1, 64, K2a
   (the head) at M = 1; each timed with its plain version and a bf16
   ``torch.matmul`` over weights dequantised outside the timed call.
   Timed calls cycle through the layers of a stack larger than the 50 MB
   L2, as decode reads each layer's weights once per token.
3. The bf16 caption path at full width: ``Magma`` from configs/MAGMA_v1.yml
   (GPT-J 6B + mlp adapters + CLIP RN50x16 at 384 px) with bf16 weights
   drawn from a seed on the GPU, answering three requests of one image and
   "Describe the painting:" (one greedy, two sampled).  Launch counts are
   set to 0 just before and read just after.
4. The greedy request's prefill logits through K1 against the plain
   attention path, and the greedy tokens of both.
2c. The int4 (W4A8) kernels against their plain versions on seeded
   inputs at the slice's shapes: K3 (in_proj) at M = 1, 5, 37, 192, K4b
   (o_proj + fc_out) at M = 1, 192, K6 (the layer boundary) at M = 1, 8
   with and without the next in_proj, for the v1 adapter and for an
   attention adapter (scaled_parallel) beside the mlp one with o_bias; each
   timed with its plain version and bf16 PyTorch calls over weights
   dequantised outside the timed call (K6: the same ops as a chain).
5. The int8 caption path: the same model after
   ``quantize_for_serving(bits=8)`` answers the same three requests; every
   kernel's launches are checked exactly against the steps taken; the
   greedy prefill logits are held against the bf16 path over the int8
   packs dequantised back to bf16 (W s).
6. The int4 caption path: the int8 model is freed, a fresh ``Magma`` from
   the same seed takes ``quantize_for_serving(bits=4)`` and answers the
   same three requests, with exact launch counts (K6 once a layer of each
   decode step); the greedy prefill logits are held against the bf16 path
   over the int4 packs dequantised to bf16.

The last two lines are one JSON object of the kernels' numbers and one
JSON object saying the run is ok and on which device.
"""

import dataclasses
import functools
import gc
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "MAGMA_v1.yml"
PROMPT = "Describe the painting:"
MAX_STEPS = 32
# H100 SXM data sheet: HBM bytes/s, dense bf16 tensor-core FLOP/s and
# dense int8 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
# bf16 O: both versions round to bf16 at the end and the kernel also rounds
# P before the PV product, so two fp32 values near a rounding boundary land
# one bf16 ulp apart (2^-7 relative at most); an absolute floor covers
# values near 0.  Checked as |O - plain| <= O_ATOL + O_RTOL * |plain|.
O_ATOL, O_RTOL = 1e-2, 2.0 ** -7
# lse: fp32 in both, another summation order and exp implementation
LSE_TOL = 1e-3
# fp32 last-position prefill logits (std ~1.3 at these random weights) of
# the kernel path vs the plain einsum path: both round attention to bf16
# at different points, ~2^-8 relative per layer, compounded over 28
# layers of a bf16 residual stream
LOGIT_TOL = 0.25
# int8 kernel path vs the bf16 path over the dequantised packs: the bf16
# path rounds each W s to bf16 (2^-9 relative per weight) and both round
# every product's output to bf16 at their own points, compounded over 28
# layers; PR 1's two bf16 paths of the same structure differed by 0.074
INT8_LOGIT_TOL = 0.5
INT8_KERNELS = {  # wrapper name in ops/quant.py -> (JSON name, TPU kernel it replaces)
    "int8_matmul_kernel": ("int8_matmul", "magma_tpu/ops/quant.py:65"),
    "int8_matmul_stacked_kernel": ("int8_matmul_stacked", "magma_tpu/ops/quant.py:123"),
    "dual_matmul_kernel": ("int8_dual", "magma_tpu/ops/quant.py:529"),
    "fused_adapter_kernel": ("fused_adapter", "magma_tpu/ops/quant.py:813"),
}
INT4_KERNELS = {  # wrapper name -> (JSON name, TPU kernel it replaces, source)
    "int4_matmul_stacked_kernel": ("int4_matmul_stacked", "magma_tpu/ops/quant.py:429",
                                   "magma_tpu_torch/csrc/int4_matmul.cu"),
    "int4_dual_kernel": ("int4_dual", "magma_tpu/ops/quant.py:601",
                         "magma_tpu_torch/csrc/int4_matmul.cu"),
    "boundary_kernel": ("boundary", "magma_tpu/ops/quant.py:942",
                        "magma_tpu_torch/csrc/boundary.cu"),
}
# K3 and K4b against their plain versions: the int8 dots are exact in both
# and the fp32 steps are the same operations in the same order (neither
# side contracts them into FMAs), so the tolerance is 0
INT4_TOL = 0.0
# K6 against the composition of the plain K4b, K5 and K3: the dual and
# in_proj sums are bit-identical, but the adapters' int8 sums and the LN
# statistics run in another order, so an h, a z or a u on a bf16 rounding
# boundary may land one bf16 ulp apart and carry into y and fused: each
# output within 2^-6 of its largest magnitude, and >= 90% of it equal
K6_REL_TOL, K6_MIN_EQUAL = 2.0 ** -6, 0.9
# int4 kernel path vs the bf16 path over the int4 packs dequantised to
# bf16: the W4A8 activation rounding (half a code step, up to 0.4% of each
# 256-block's max, ~0.7% RMS noise on each product) in 3 products a layer,
# compounded over 28 layers of the residual stream: ~5% of the logit scale
# (std ~1.3) a logit, its largest over 50k logits ~4.5 times that (~0.3)
INT4_LOGIT_TOL = 1.0


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(fail(msg))


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median ms of ``fn()`` over ``iters`` runs, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float, ops_per_s: float = BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take,
    each byte moved once at the HBM rate or each operation at the
    tensor-core rate of its type (bf16 unless given), whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _kernel_events(torch, prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(torch, fn, match: str, calls: int = 20):
    """Mean device time (ms) a call of the kernels whose name contains
    ``match``, from torch.profiler over ``calls`` calls: the kernel alone,
    without the host time that CUDA events around a short call include.
    None when the profiler records no such kernel in two tries (a trace
    now and then comes back without device events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in _kernel_events(torch, prof)
                 if match in e.name]
        if times:
            return sum(times) / calls / 1e3
    return None


def _fmt_ms(ms) -> str:
    return "not measured (the profiler saw no such kernel)" if ms is None else f"{ms:.4f} ms"


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN")
    return smi


def phase_build():
    from magma_tpu_torch import cuda_build

    result = cuda_build.build()
    print(f"[build] {result.path.name}: {result.seconds:.2f} s "
          f"({'built' if result.seconds else 'up to date'})")
    for line in result.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    cuda_build.load_library()


def phase_kernel(torch):
    """K1 vs its plain version.  Returns its JSON entry (launches unset)."""
    import torch.nn.functional as F

    from magma_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)

    dev = torch.device("cuda")
    hd = 256
    cases = [
        ("slice prefill b=1 kv_len=[149]", 1, 256, 256, [149], 0),
        ("b=2 kv_len=[149, 0] (row 1 fully masked)", 2, 256, 256, [149, 0], 0),
        ("q_offset=128 s_q=128 s_k=256", 1, 128, 256, None, 128),
    ]
    rng = np.random.default_rng(0)
    worst = 0.0
    timed = None
    for name, b, s_q, s_k, kv_len, q_offset in cases:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, s, 16, hd), dtype=np.float32))
                   .to(dev, torch.bfloat16) for s in (s_q, s_k, s_k))
        kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=dev)
        kw = dict(scale=hd ** -0.5, causal=True, kv_len=kvl, q_offset=q_offset)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o.float() - ref_o.float()).abs()
        o_err = err.max().item()
        o_ok = bool((err <= O_ATOL + O_RTOL * ref_o.float().abs()).all())
        valid = (torch.ones((b,), dtype=torch.bool, device=dev) if kvl is None else kvl > 0)
        lse_err = (lse - ref_lse)[valid].abs().max().item()
        print(f"[K1] {name}: max|O-plain| {o_err:.3e} (tol {O_ATOL} + 2^-7 |O|), "
              f"max|lse-plain| {lse_err:.3e} (tol {LSE_TOL})")
        check(torch.isfinite(o.float()).all().item(), f"K1 {name}: non-finite O")
        check(o_ok, f"K1 {name}: O error {o_err} beyond {O_ATOL} + {O_RTOL} |O|")
        check(lse_err <= LSE_TOL, f"K1 {name}: lse error {lse_err} > {LSE_TOL}")
        if kvl is not None and not valid.all():
            masked_o = o[~valid].float().abs().max().item()
            print(f"[K1]   fully masked row: max|O| {masked_o}, lse equal to plain: "
                  f"{torch.equal(lse[~valid], ref_lse[~valid])}")
            check(masked_o == 0.0, "K1: a fully masked row must output 0")
            check(torch.equal(lse[~valid], ref_lse[~valid]), "K1: masked-row lse differs")
        worst = max(worst, o_err)
        if timed is None:
            timed = (q, k, v, kw, kv_len[0])
    q, k, v, kw, kv = timed
    b, s, h, _ = q.shape
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw))
    dev_ms = device_ms(torch, lambda: flash_attention_fwd(q, k, v, **kw), "flash_fwd_kernel")
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw))
    # the library call: SDPA over (b, h, s, hd) views with the same boolean
    # mask (causal and kv_len), built outside the timed call
    cols = torch.arange(s, device=dev)
    mask = ((cols[None, :] <= cols[:, None]) & (cols < kv)[None, :])[None, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=kw["scale"])
    lib_err = (lib_o.transpose(1, 2).float() - flash_attention_plain(q, k, v, **kw)[0].float())
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                            scale=kw["scale"]))
    # this run's work: each attended (query, key) pair costs a 2 hd QK^T and
    # a 2 hd PV product per head; bytes: Q and O in bf16 at all s rows, K and
    # V only at the kv_len rows the kernel reads, and the fp32 lse
    pairs = sum(min(i + 1, kv) for i in range(s))
    kv_bytes = 2 * b * kv * h * hd * k.element_size()
    bound_ms, bound_by = bound(nbytes(q, q) + kv_bytes + b * h * s * 4, 4 * hd * pairs * h * b)
    print(f"[K1] slice prefill shape (b*h=16, s=256, hd=256, kv_len={kv}): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA with the boolean mask {lib_ms:.4f} ms "
          f"(max|SDPA-plain| {lib_err.abs().max().item():.3e}), bound {bound_ms:.4f} ms "
          f"({bound_by}) (median of 50, CUDA events); kernel alone {_fmt_ms(dev_ms)} "
          f"(profiler)")
    return {"name": "flash_attn_fwd", "route": "cuda",
            "source": "magma_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "magma_tpu/ops/flash_attention.py:75",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def _sum_tol(x, wq, s, k):
    """Both versions sum k exact fp32 products (bf16 x int8) in another
    order; each sum is within k 2^-24 of the sum of |terms|, so the two are
    within twice that."""
    return 2 * k * 2.0 ** -24 * (x.float().abs() @ wq.float().abs()) * s.abs()


def _timing(torch, label, m, kernel, plain, library, n_bytes, flops, match,
            ops_per_s=BF16_FLOPS, library_is="bf16 torch.matmul over pre-dequantised W"):
    """Time a kernel (CUDA events a call, the profiler alone), its plain
    version and its library yardstick; print them beside the bound and
    return the JSON numbers."""
    ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain, iters=10), cuda_ms(library)
    dev_ms = device_ms(torch, kernel, match)
    bound_ms, bound_by = bound(n_bytes, flops, ops_per_s)
    share = "" if dev_ms is None else f", the kernel alone at {bound_ms / dev_ms:.2%} of it"
    print(f"[{label}] M={m} timing: kernel {ms:.4f} ms a call (CUDA events, wrapper "
          f"included), kernel alone {_fmt_ms(dev_ms)} (profiler), plain {plain_ms:.4f} ms, "
          f"library ({library_is}) {lib_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}){share}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "kernel_alone_ms": dev_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_int8_kernels(torch):
    """K2a, K2b, K4a and K5 against their plain versions.  Returns their
    JSON entries by wrapper name (launches unset)."""
    from magma_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    D, F_, V, DH = 4096, 16384, 50304, 1024
    N_IN = 3 * D + F_

    def bf16(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=g, device=dev) * 2e-4 + 1e-5

    def deq(wq, s):  # the library's weight: W s in bf16, made before timing
        return (wq.float() * s[..., None, :]).to(torch.bfloat16)

    entries = {}

    def report(wrapper, label, m, err, tol_ok, timing=None):
        print(f"[{label}] M={m}: max|kernel-plain| {err:.3e}, within tolerance: {tol_ok}")
        check(tol_ok, f"{label} M={m}: kernel differs from its plain version by {err}")
        entry = entries.setdefault(wrapper, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if timing is not None:
            entry.update(timing)

    timing = functools.partial(_timing, torch)

    # K2b: the in_proj, 4 layers (470 MB of int8) cycled
    L = 4
    wq, s = int8(L, D, N_IN), scales(L, N_IN)
    w_lib = [deq(wq[i], s[i]) for i in range(L)]
    for m in (1, 5, 37, 192):
        x = bf16(m, D)
        out = quant.int8_matmul_stacked(x, wq, s, 1)
        ref = quant.int8_matmul_stacked_plain(x, wq, s, 1)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        tm = None
        if m in (1, 192):
            it = itertools.cycle(range(L))
            tm = timing("K2b in_proj", m, lambda: quant.int8_matmul_stacked(x, wq, s, next(it)),
                        lambda: quant.int8_matmul_stacked_plain(x, wq, s, next(it)),
                        lambda: torch.matmul(x, w_lib[next(it)]),
                        nbytes(x, wq[0], s[0]) + m * N_IN * 4, 2 * m * D * N_IN,
                        "gemv_kernel" if m <= 8 else "mma_kernel")
        # the JSON line carries decode's (M=1) numbers; the log has M=192's
        report("int8_matmul_stacked_kernel", "K2b in_proj", m, err.max().item(),
               bool((err <= _sum_tol(x, wq[1], s[1], D)).all()), tm if m == 1 else None)
    del wq, s, w_lib

    # K4a: o_proj + fc_out, 4 layers (335 MB) cycled
    wq, s = int8(L, D + F_, D), scales(L, 2, D)
    lib_o = [deq(wq[i, :D], s[i, 0]) for i in range(L)]
    lib_f = [deq(wq[i, D:], s[i, 1]) for i in range(L)]
    for m in (1, 192):
        ctx, h = bf16(m, D), bf16(m, F_)
        w = {"q": wq, "s": s}
        a, mo = quant.dual_matmul_stacked(ctx, h, w, 2)
        ra, rm = quant.dual_matmul_stacked_plain(ctx, h, w, 2)
        torch.cuda.synchronize()
        ea, em = (a - ra).abs(), (mo - rm).abs()
        ok = bool((ea <= _sum_tol(ctx, wq[2, :D], s[2, 0], D)).all()
                  and (em <= _sum_tol(h, wq[2, D:], s[2, 1], F_)).all())
        it = itertools.cycle(range(L))

        def library():
            i = next(it)
            return torch.matmul(ctx, lib_o[i]), torch.matmul(h, lib_f[i])

        tm = timing("K4a out_proj", m, lambda: quant.dual_matmul_stacked(ctx, h, w, next(it)),
                    lambda: quant.dual_matmul_stacked_plain(ctx, h, w, next(it)), library,
                    nbytes(ctx, h, wq[0], s[0]) + 2 * m * D * 4, 2 * m * (D + F_) * D,
                    "gemv_kernel" if m <= 8 else "mma_kernel")
        report("dual_matmul_kernel", "K4a out_proj", m, max(ea.max().item(), em.max().item()),
               ok, tm if m == 1 else None)
    del wq, s, lib_o, lib_f

    # K5: the v1 adapter (D=4096, DH=1024) of all 28 layers (235 MB) cycled
    L = 28
    fz = {"wd": int8(L, D, DH), "sd": scales(L, 1, DH), "bd": scales(L, 1, DH) * 100,
          "wu": int8(L, DH, D), "su": scales(L, 1, D), "bu": scales(L, 1, D) * 100}
    lib_d = [deq(fz["wd"][i], fz["sd"][i, 0]) for i in range(L)]
    lib_u = [deq(fz["wu"][i], fz["su"][i, 0]) for i in range(L)]
    lib_b = [(fz["bd"][i, 0].to(torch.bfloat16), fz["bu"][i, 0].to(torch.bfloat16))
             for i in range(L)]
    for m in (1, 64):
        x = bf16(m, D)
        out = quant.fused_adapter_stacked(x, fz, 5)
        ref = quant.fused_adapter_stacked_plain(x, fz, 5)
        torch.cuda.synchronize()
        # h is rounded to bf16 in both: an h on a rounding boundary can land
        # one bf16 ulp (2^-8 relative) apart and move out by 2^-8 |h| |Wu| su
        hh = torch.relu(quant.int8_matmul_plain(x, fz["wd"][5], fz["sd"][5, 0]) + fz["bd"][5, 0])
        up = (hh.abs() @ fz["wu"][5].float().abs()) * fz["su"][5, 0]
        err = (out - ref).abs()
        ok = bool((err <= 2.0 ** -8 * up + _sum_tol(hh, fz["wu"][5], fz["su"][5, 0], DH)
                   + 1e-6).all())
        it = itertools.cycle(range(L))

        def library():
            i = next(it)
            return torch.relu(x @ lib_d[i] + lib_b[i][0]) @ lib_u[i] + lib_b[i][1]

        tm = timing("K5 adapter", m, lambda: quant.fused_adapter_stacked(x, fz, next(it)),
                    lambda: quant.fused_adapter_stacked_plain(x, fz, next(it)), library,
                    nbytes(x, fz["wd"][0], fz["wu"][0]) + 4 * (2 * DH + 2 * D) + m * D * 4,
                    2 * m * 2 * D * DH, "fused_adapter_kernel")
        report("fused_adapter_kernel", "K5 adapter", m, err.max().item(), ok,
               tm if m == 1 else None)
    del fz, lib_d, lib_u, lib_b

    # K2a: the untied head, decode's M=1; 206 MB, larger than L2 by itself
    wq, s = int8(D, V), scales(V)
    w_lib = deq(wq, s)
    x = bf16(1, D)
    out, ref = quant.int8_matmul(x, wq, s), quant.int8_matmul_plain(x, wq, s)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    tm = timing("K2a head", 1, lambda: quant.int8_matmul(x, wq, s),
                lambda: quant.int8_matmul_plain(x, wq, s), lambda: torch.matmul(x, w_lib),
                nbytes(x, wq, s) + V * 4, 2 * D * V, "gemv_kernel")
    report("int8_matmul_kernel", "K2a head", 1, err.max().item(),
           bool((err <= _sum_tol(x, wq, s, D)).all()), tm)
    for wrapper, (name, replaces) in INT8_KERNELS.items():
        entries[wrapper].update(name=name, route="cuda", replaces=replaces, source=(
            "magma_tpu_torch/csrc/fused_adapter.cu" if name == "fused_adapter"
            else "magma_tpu_torch/csrc/int8_matmul.cu"))
    return entries


def phase_int4_kernels(torch):
    """K3, K4b and K6 against their plain versions.  Returns their JSON
    entries by wrapper name (launches unset)."""
    from magma_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    D, F_, DH = 4096, 16384, 1024
    N_IN = 3 * D + F_
    timing = functools.partial(_timing, torch, ops_per_s=INT8_OPS)

    def bf16(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(torch.bfloat16)

    def int4_stack(layers, k, n):  # seeded weights packed on the card, one layer at a time
        packs = [quant.quantize_int4(torch.randn((k, n), generator=g, device=dev) * 0.02,
                                     compiled=True) for _ in range(layers)]
        return torch.stack([p["q4"] for p in packs]), torch.stack([p["s4"] for p in packs])

    def deq(q4, s4):  # the library's weight: bf16, made before timing
        return quant.dequantize_int4(q4, s4).to(torch.bfloat16)

    entries = {}

    def report(wrapper, label, m, err, ok, timed=None):
        print(f"[{label}] M={m}: max|kernel-plain| {err:.3e}, within tolerance: {ok}")
        check(ok, f"{label} M={m}: kernel differs from its plain version by {err}")
        entry = entries.setdefault(wrapper, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if timed is not None:
            entry.update(timed)

    # K3: the in_proj, 2 layers of 60.6 MB (one is larger than L2) cycled
    L = 2
    q4, s4 = int4_stack(L, D, N_IN)
    w_lib = [deq(q4[i], s4[i]) for i in range(L)]
    for m in (1, 5, 37, 192):
        x = bf16(m, D)
        out = quant.int4_matmul_stacked(x, q4, s4, 1)
        ref = quant.int4_matmul_stacked_plain(x, q4, s4, 1)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        it = itertools.cycle(range(L))
        tm = timing("K3 in_proj", m, lambda: quant.int4_matmul_stacked(x, q4, s4, next(it)),
                    lambda: quant.int4_matmul_stacked_plain(x, q4, s4, next(it)),
                    lambda: torch.matmul(x, w_lib[next(it)]),
                    nbytes(x, q4[0], s4[0]) + m * N_IN * 4, 2 * m * D * N_IN,
                    "w4a8_gemv_kernel" if m <= 8 else "w4a8_mma")
        # the JSON line carries decode's (M=1) numbers; the log has M=192's
        report("int4_matmul_stacked_kernel", "K3 in_proj", m, err, err <= INT4_TOL,
               tm if m == 1 else None)
    del q4, s4, w_lib

    # K4b: o_proj + fc_out, 2 layers of 42.6 MB cycled
    qo, so = int4_stack(L, D, D)
    qf, sf = int4_stack(L, F_, D)
    w = {"q4": torch.cat([qo, qf], 1), "s4": torch.cat([so, sf], 1)}
    lib_o = [deq(qo[i], so[i]) for i in range(L)]
    lib_f = [deq(qf[i], sf[i]) for i in range(L)]
    del qo, so, qf, sf
    for m in (1, 192):
        ctx, h = bf16(m, D), bf16(m, F_, std=0.5)
        a, mo = quant.dual_matmul_stacked(ctx, h, w, 1)
        ra, rm = quant.dual_matmul_stacked_plain(ctx, h, w, 1)
        torch.cuda.synchronize()
        err = max((a - ra).abs().max().item(), (mo - rm).abs().max().item())
        it = itertools.cycle(range(L))

        def library():
            i = next(it)
            return torch.matmul(ctx, lib_o[i]), torch.matmul(h, lib_f[i])

        tm = timing("K4b out_proj", m, lambda: quant.dual_matmul_stacked(ctx, h, w, next(it)),
                    lambda: quant.dual_matmul_stacked_plain(ctx, h, w, next(it)), library,
                    nbytes(ctx, h, w["q4"][0], w["s4"][0]) + 2 * m * D * 4,
                    2 * m * (D + F_) * D, "w4a8_gemv_kernel" if m <= 8 else "w4a8_mma")
        # the main path runs K4b in prefill only: the JSON line has M=192
        report("int4_dual_kernel", "K4b out_proj", m, err, err <= INT4_TOL,
               tm if m == 192 else None)
    del lib_o, lib_f

    # K6: K4b's 2-layer dual payload, 3 layers of the in_proj (layer i reads
    # in_proj layer i + 1), the v1 adapter and an attention adapter; layers
    # 0 and 1 cycled; the last-layer case (no in_proj) runs layer 1
    L = 3
    w_in = dict(zip(("q4", "s4"), int4_stack(L, D, N_IN)))

    def vec(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev) * std

    def adapter():
        return quant.quantize_adapter_fused(
            vec(L, D, DH, std=0.05), vec(L, DH), vec(L, DH, D, std=0.05), vec(L, D),
            out_scale=1 + vec(L, std=0.5))

    b_fc_out, ln_g, ln_b, o_bias = vec(L, D), 1 + vec(L, D, std=0.1), vec(L, D), vec(L, D)
    variants = {"v1 (mlp adapter)": dict(fz_mlp=adapter(), mlp_src="out"),
                "attn scaled_parallel + mlp normal, o_bias": dict(
                    fz_mlp=adapter(), mlp_src="out", fz_attn=adapter(), attn_src="in",
                    o_bias=o_bias)}
    for name, kw in variants.items():
        for m in (1, 8):
            ctx, mh, x, u_in = bf16(m, D), bf16(m, F_, std=0.5), bf16(m, D, std=0.3), bf16(m, D)
            for with_in in (True, False):
                li = 0 if with_in else 1
                args = (ctx, mh, x, w, b_fc_out, ln_g, ln_b, li)
                ckw = dict(kw, w_in=w_in if with_in else None, u_in=u_in)
                got = quant.boundary_fused_stacked(*args, **ckw)
                ref = quant.boundary_fused_stacked_plain(*args, **ckw)
                torch.cuda.synchronize()
                errs, ok = [], True
                for gt, rf in zip(got, ref):
                    diff = (gt.float() - rf.float()).abs()
                    errs.append(diff.max().item())
                    equal = (diff == 0).float().mean().item()
                    ok = ok and errs[-1] <= K6_REL_TOL * rf.float().abs().max().item() \
                        and equal >= K6_MIN_EQUAL
                    print(f"[K6 boundary]   {name}, M={m}, w_in {with_in}: max|diff| "
                          f"{errs[-1]:.3e} (tol 2^-6 max|plain| = "
                          f"{K6_REL_TOL * rf.float().abs().max().item():.3e}), "
                          f"{equal:.4%} of elements equal")
                tm = _time_boundary(torch, quant, f"K6 boundary, {name}, w_in {with_in}",
                                    args, ckw, w)
                # the JSON line carries the main path's case: M=1, v1, w_in
                report("boundary_kernel", f"K6 boundary, {name}, w_in {with_in}", m,
                       max(errs), ok, tm if m == 1 and with_in and "v1" in name else None)
    for wrapper, (name, replaces, source) in INT4_KERNELS.items():
        entries[wrapper].update(name=name, route="cuda", replaces=replaces, source=source)
    return entries


def _time_boundary(torch, quant, label, args, kw, w):
    """K6 at one case, cycling layers 0 and 1; its library yardstick is the
    same ops as bf16 PyTorch calls over weights dequantised before timing:
    the two dual matmuls, the biases, each adapter (two matmuls, relu), the
    residual, F.layer_norm and, with ``w_in``, the next in_proj matmul."""
    import torch.nn.functional as F

    ctx, mh, x, _, b_fc_out, ln_g, ln_b, _ = args
    m, D = ctx.shape
    bf = torch.bfloat16
    w_in, u_in, o_bias = kw["w_in"], kw["u_in"], kw.get("o_bias")
    adapters = [(kw[f"fz_{k}"], kw[f"{k}_src"]) if kw.get(f"fz_{k}") is not None else None
                for k in ("attn", "mlp")]
    deq = quant.dequantize_int4

    def deq_adapter(fz, i):
        return dict(wd=(fz["wd"][i].float() * fz["sd"][i]).to(bf), bd=fz["bd"][i, 0].to(bf),
                    wu=(fz["wu"][i].float() * fz["su"][i]).to(bf), bu=fz["bu"][i, 0].to(bf))

    lib = []
    for i in (0, 1):
        lib.append(dict(
            o=deq(w["q4"][i, :D // 2], w["s4"][i, :D // 256]).to(bf),
            f=deq(w["q4"][i, D // 2:], w["s4"][i, D // 256:]).to(bf),
            ad=[None if a is None else deq_adapter(a[0], i) for a in adapters],
            ob=None if o_bias is None else o_bias[i].to(bf),
            bfo=b_fc_out[i].to(bf), g=ln_g[i], b=ln_b[i],
            w_in=None if w_in is None else deq(w_in["q4"][i + 1], w_in["s4"][i + 1]).to(bf)))
    it = itertools.cycle((0, 1))

    def adapter(src, q):
        return torch.relu(src @ q["wd"] + q["bd"]) @ q["wu"] + q["bu"]

    def library():
        p = lib[next(it)]
        a = ctx @ p["o"]
        if p["ob"] is not None:
            a = a + p["ob"]
        if p["ad"][0] is not None:
            a = a + adapter(u_in if adapters[0][1] == "in" else a, p["ad"][0])
        mm = mh @ p["f"] + p["bfo"]
        if p["ad"][1] is not None:
            mm = mm + adapter(u_in if adapters[1][1] == "in" else mm, p["ad"][1])
        y = x + a + mm
        u = F.layer_norm(y.float(), (D,), p["g"], p["b"]).to(bf)
        return (y, u) if p["w_in"] is None else (y, u, u @ p["w_in"])

    it_k, it_p = itertools.cycle((0, 1)), itertools.cycle((0, 1))
    rest = args[:7]
    # each input read once (a layer's weights, u_in where an adapter reads
    # it), each output written once
    reads = [ctx, mh, x, w["q4"][0], w["s4"][0]]
    ops = 2 * m * (mh.shape[1] + D) * D
    n_vec = 3 + (o_bias is not None)
    if any(a is not None and a[1] == "in" for a in adapters):
        reads.append(u_in)
    for a in adapters:
        if a is not None:
            reads += [a[0]["wd"][0], a[0]["wu"][0]]
            n_vec += 2 * a[0]["wd"].shape[2] / D + 2
            ops += 4 * m * D * a[0]["wd"].shape[2]
    n_out = 2 * m * D * 2
    if w_in is not None:
        reads += [w_in["q4"][1], w_in["s4"][1]]
        ops += 2 * m * D * w_in["q4"].shape[-1]
        n_out += m * w_in["q4"].shape[-1] * 2
    return _timing(torch, label, m,
                   lambda: quant.boundary_fused_stacked(*rest, next(it_k), **kw),
                   lambda: quant.boundary_fused_stacked_plain(*rest, next(it_p), **kw),
                   library, nbytes(*reads) + n_vec * D * 4 + n_out, ops, "boundary_kernel",
                   ops_per_s=INT8_OPS, library_is="the same ops as a chain of bf16 PyTorch calls")


def _requests():
    return [
        ("greedy", dict(temperature=0.0)),
        ("top_p=0.9 T=0.7", dict(temperature=0.7, top_k=0, top_p=0.9)),
        ("top_k=5 T=0.7", dict(temperature=0.7, top_k=5)),
    ]


def _image():
    from PIL import Image

    pixels = np.random.default_rng(1).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    return Image.fromarray(pixels)


def _run_request(torch, model, i, name, kw, tag):
    """One caption request: returns (embeddings, tokens, steps)."""
    dev = model.device
    lm = model.lm_config
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    emb = model.preprocess_inputs([_image(), PROMPT])
    end.record()
    end.synchronize()
    vision_ms = start.elapsed_time(end)
    n_text = model.tokenizer.encode(PROMPT).shape[1]
    want = (1, model.image_prefix_seq_len + n_text, lm.d_model)
    check(tuple(emb.shape) == want, f"embeddings {tuple(emb.shape)} != {want}")
    check(torch.isfinite(emb.float()).all().item(), "non-finite embeddings")
    timing = {}
    g = torch.Generator(device=dev).manual_seed(100 + i)
    tokens = model.generate(emb, max_steps=MAX_STEPS, decode=False, generator=g,
                            timing=timing, **kw)
    text = model.tokenizer._decode_ids(
        [t for t in tokens[0].tolist() if t < model.tokenizer.image_token_id])
    steps = timing["steps"]
    per_tok = timing["decode_ms"] / max(steps - 1, 1)
    print(f"[{tag}] request {i} ({name}): embeddings {tuple(emb.shape)}, {steps} tokens "
          f"{tokens[0, :steps].tolist()} -> {text!r}")
    print(f"[{tag}]   vision+prefix {vision_ms:.2f} ms, prefill {timing['prefill_ms']:.2f} ms, "
          f"decode {per_tok:.2f} ms/token ({timing['decode_ms']:.1f} ms over "
          f"{steps - 1} forwards and {steps} samplings)")
    check(((tokens >= 0) & (tokens < lm.vocab_size)).all(), "token out of vocab")
    return emb, tokens, steps


def phase_slice(torch):
    """Three bf16 caption requests at full width.  Returns (model, greedy
    request embeddings, greedy tokens, K1 launches)."""
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Magma(CONFIG, seed=0, device=dev)
    torch.cuda.synchronize()
    lm = model.lm_config
    n_lm = nbytes(*_leaves(model.params["lm"]))
    print(f"[slice] Magma({CONFIG.name}) on {torch.cuda.get_device_name(0)} in "
          f"{time.perf_counter() - t0:.1f} s: {lm.n_layers} layers, d_model {lm.d_model}, "
          f"{lm.n_heads} heads x {lm.head_dim}, d_ff {lm.d_ff}, rotary {lm.rotary_dim}, "
          f"vocab {lm.vocab_size} -> {lm.padded_vocab_size}, mlp adapter "
          f"{lm.mlp_adapter}, LM weights {n_lm / 1e9:.2f} GB "
          f"({lm.param_dtype}), attention {lm.attention_impl}")
    print(f"[slice] tokenizer {type(model.tokenizer).__name__}: {PROMPT!r} -> "
          f"{model.tokenizer.encode(PROMPT).shape[1]} tokens")

    flash_attention_kernel.launches = 0  # count the main path only
    greedy = None
    for i, (name, kw) in enumerate(_requests()):
        before = flash_attention_kernel.launches
        emb, tokens, _ = _run_request(torch, model, i, name, kw, "slice")
        launches = flash_attention_kernel.launches - before
        print(f"[slice]   K1 launches {launches}")
        check(launches == lm.n_layers, f"request {i}: {launches} K1 launches, "
              f"expected {lm.n_layers} (one per layer's prefill)")
        if greedy is None:
            greedy = (emb, tokens)
    launches = flash_attention_kernel.launches
    print(f"[slice] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return model, greedy[0], greedy[1], launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _prefill_last_logits(torch, cfg, lm_params, emb):
    """fp32 logits at the last true position of a padded prefill."""
    from magma_tpu_torch.models import gptj

    pad = (-emb.shape[1]) % 64
    padded = torch.nn.functional.pad(emb, (0, 0, 0, pad))
    s = emb.shape[1]
    kv_len = torch.full((1,), s, dtype=torch.int32, device=emb.device)
    cache = gptj.init_kv_cache(cfg, 1, padded.shape[1] + 64, device=emb.device)
    hidden, _ = gptj.forward(cfg, lm_params, padded, cache=cache, cache_index=0,
                             kv_len=kv_len, return_hidden=True)
    return gptj.lm_head(cfg, lm_params, hidden[:, s - 1:s])[0, 0]


def _profile_forward(torch, fn, tag, what):
    """Wall time of ``fn`` (a synchronised forward) by the host clock
    (median of 5), device busy time and kernel count from torch.profiler,
    and the idle share 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    kernels = _kernel_events(torch, prof)
    if not kernels:
        print(f"[{tag}] {what}: wall {wall:.2f} ms; device time not measured "
              f"(the profiler saw no kernels)")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[{tag}] {what}: wall {wall:.2f} ms (host clock, median of 5), device busy "
          f"{busy:.2f} ms in {len(kernels)} kernels, idle share {1 - busy / wall:.3f}")
    for name, ms in top:
        print(f"[{tag}]   {ms:.3f} ms  {name[:90]}")


def profile_decode_step(torch, model, emb, tag):
    """The prompt's prefill forward (the last position's head included) and
    one decode forward after it (b=1, sampling not included), each profiled
    by ``_profile_forward``."""
    from magma_tpu_torch.models import gptj

    cfg, lm, dev = model.lm_config, model.params["lm"], emb.device
    s = emb.shape[1]
    padded = torch.nn.functional.pad(emb, (0, 0, 0, (-s) % 64))
    cache = gptj.init_kv_cache(cfg, 1, padded.shape[1] + 64, device=dev)
    kv_len = torch.full((1,), s, dtype=torch.int32, device=dev)

    def prefill():
        hidden, _ = gptj.forward(cfg, lm, padded, cache=cache, cache_index=0, kv_len=kv_len,
                                 return_hidden=True)
        gptj.lm_head(cfg, lm, hidden[:, s - 1:s])
        torch.cuda.synchronize()

    _profile_forward(torch, prefill, tag, f"the prefill forward (b=1, {s} tokens padded to "
                                          f"{padded.shape[1]})")
    x = gptj.embed_tokens(cfg, lm, torch.full((1, 1), model.eos_token, device=dev))
    pos = torch.full((1,), s, dtype=torch.int32, device=dev)

    def step():
        gptj.forward(cfg, lm, x, cache=cache, cache_index=pos)
        torch.cuda.synchronize()

    _profile_forward(torch, step, tag, f"one decode step (b=1, {s}-token prompt, no sampling)")


def phase_kernel_vs_plain_path(torch, model, emb, greedy_tokens):
    """Prefill logits and greedy tokens, kernel path vs plain einsum path."""
    kernel_cfg = model.lm_config
    plain_cfg = dataclasses.replace(kernel_cfg, attention_impl="xla")
    logits = {name: _prefill_last_logits(torch, cfg, model.params["lm"], emb)
              for name, cfg in (("kernel", kernel_cfg), ("plain", plain_cfg))}
    diff = (logits["kernel"] - logits["plain"])[: kernel_cfg.vocab_size].abs().max().item()
    std = logits["plain"].std().item()
    print(f"[e2e] last-position prefill logits (fp32), kernel vs plain path: "
          f"max|diff| {diff:.4e} (tol {LOGIT_TOL}; logit std {std:.3f})")
    check(torch.isfinite(logits["kernel"]).all().item(), "non-finite prefill logits")
    check(diff <= LOGIT_TOL, f"prefill logits differ by {diff} > {LOGIT_TOL}")

    model.lm_config = plain_cfg
    plain_tokens = model.generate(emb, max_steps=MAX_STEPS, temperature=0.0, decode=False)
    model.lm_config = kernel_cfg
    _print_agreement("[e2e] greedy tokens, kernel vs plain attention", plain_tokens,
                     greedy_tokens)
    profile_decode_step(torch, model, emb, "bf16")


def _print_agreement(label, a, b):
    same = int((a[0] == b[0]).sum())
    first_diff = next((i for i, (x, y) in enumerate(zip(a[0], b[0])) if x != y), None)
    print(f"{label}: equal at {same}/{MAX_STEPS} positions (first difference at {first_diff})")


def _dequantised_lm(torch, lm, cfg):
    """The bf16 LM of the unquantized layout made from the int8 packs
    (W s per layer) or the int4 ones (``dequantize_int4``), its head
    ``lm_head_q`` a bf16 (D, V) tensor, which ``gptj.lm_head`` multiplies in
    fp32; embeddings keep ``wte``."""
    from magma_tpu_torch.ops.quant import dequantize_int4

    D = cfg.d_model
    blocks = lm["blocks"]

    def deq(w, s):  # (L, K, N) int8, (L, N) -> bf16, one layer at a time
        return torch.stack([(w[i].float() * s[i]).to(torch.bfloat16) for i in range(w.shape[0])])

    def deq4(q4, s4):  # (L, K/2, N) packed, (L, K/256, N) -> bf16 (L, K, N)
        return torch.stack([dequantize_int4(q4[i], s4[i]).to(torch.bfloat16)
                            for i in range(q4.shape[0])])

    ip, op = blocks["attn"]["in_proj"], blocks["attn"]["out_proj"]
    if "q4" in ip:
        w_in = deq4(ip["q4"], ip["s4"])
        w_o = deq4(op["q4"][:, :D // 2], op["s4"][:, :D // 256])
        w_f = deq4(op["q4"][:, D // 2:], op["s4"][:, D // 256:])
    else:
        w_in = deq(ip["q"], ip["s"])
        w_o, w_f = deq(op["q"][:, :D], op["s"][:, 0]), deq(op["q"][:, D:], op["s"][:, 1])
    attn = {"q": w_in[..., :D], "k": w_in[..., D:2 * D], "v": w_in[..., 2 * D:3 * D],
            "o": w_o}
    if "o_bias" in blocks["attn"]:
        attn["o_bias"] = blocks["attn"]["o_bias"]
    out = {"wte": lm["wte"], "ln_f": lm["ln_f"],
           "lm_head_q": (lm["lm_head_q"]["q"].float() * lm["lm_head_q"]["s"]).to(torch.bfloat16),
           "blocks": {"ln_1": blocks["ln_1"], "attn": attn, "mlp": {
               "fc_in": {"kernel": w_in[..., 3 * D:], "bias": blocks["mlp"]["fc_in"]["bias"]},
               "fc_out": {"kernel": w_f,
                          "bias": blocks["mlp"]["fc_out"]["bias"]}}}}
    for key in ("adapter_mlp", "adapter_attn"):
        if key in blocks:
            fz = blocks[key]["fused"]
            out["blocks"][key] = {
                "down": {"kernel": deq(fz["wd"], fz["sd"][:, 0]), "bias": fz["bd"][:, 0]},
                "up": {"kernel": deq(fz["wu"], fz["su"][:, 0]), "bias": fz["bu"][:, 0]}}
    return out


def _want_launches(bits, L, steps):
    """Exact launches of one request of ``steps`` tokens (1 prefill + steps-1
    decode forwards) on the v1 recipe, by wrapper."""
    if bits == 8:
        # K2b and K4a once a layer a forward, K2a once a forward; K5 once a
        # layer in decode only (the prefill's 192 rows take the dequantising
        # matmul); K1 once a layer's prefill
        want = {"int8_matmul_stacked_kernel": L * steps, "dual_matmul_kernel": L * steps,
                "int8_matmul_kernel": steps, "fused_adapter_kernel": L * (steps - 1)}
    else:
        # prefill: K3 and K4b once a layer; a decode step: K3 for layer 0's
        # in_proj, then K6 once a layer (the next in_proj and the adapter
        # inside it); K2a (the int8 head) once a forward; no K5
        want = {"int4_matmul_stacked_kernel": L + steps - 1, "int4_dual_kernel": L,
                "boundary_kernel": L * (steps - 1), "int8_matmul_kernel": steps}
    want["flash_attention_kernel"] = L
    return {k: want.get(k, 0) for k in (*INT8_KERNELS, *INT4_KERNELS, "flash_attention_kernel")}


def phase_quantized(torch, model, bits):
    """The int8 (bits=8) or int4 (bits=4) caption path:
    quantize_for_serving(bits), three requests with exact launch counts of
    every kernel, and the greedy prefill logits against the bf16 path over
    the dequantised packs.  Returns the launches by wrapper."""
    from magma_tpu_torch.ops import quant
    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel

    tag = f"int{bits}"
    tol = INT8_LOGIT_TOL if bits == 8 else INT4_LOGIT_TOL
    lm = model.lm_config
    L = lm.n_layers
    check(lm.mlp_adapter is not None and lm.attn_adapter is None,
          "the launch counts below assume the v1 recipe: an mlp adapter only")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.quantize_for_serving(bits)
    torch.cuda.synchronize()
    n_lm = nbytes(*_leaves(model.params["lm"]))
    check("fused" in model.params["lm"]["blocks"]["adapter_mlp"], "the adapter was not fused")
    print(f"[{tag}] quantize_for_serving({bits}) in {time.perf_counter() - t0:.1f} s: LM "
          f"{n_lm / 1e9:.2f} GB ({tag} packs, fp32 scales, bf16 wte), vision tower BN-folded")
    ref_lm = _dequantised_lm(torch, model.params["lm"], lm)

    wrappers = {name: getattr(quant, name) for name in (*INT8_KERNELS, *INT4_KERNELS)}
    wrappers["flash_attention_kernel"] = flash_attention_kernel
    for fn in wrappers.values():
        fn.launches = 0  # count the main path only
    greedy = None
    for i, (name, kw) in enumerate(_requests()):
        before = {k: fn.launches for k, fn in wrappers.items()}
        emb, tokens, steps = _run_request(torch, model, i, name, kw, tag)
        got = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        want = _want_launches(bits, L, steps)
        print(f"[{tag}]   launches {got}")
        check(got == want, f"{tag} request {i}: launches {got}, expected {want}")
        if greedy is None:
            greedy = (emb, tokens)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({tag} model, its dequantised bf16 copy and the requests)")

    emb, tokens = greedy
    # the same config: the dequantised tree takes the bf16 branches
    got = _prefill_last_logits(torch, lm, model.params["lm"], emb)
    ref = _prefill_last_logits(torch, lm, ref_lm, emb)
    diff = (got - ref)[: lm.vocab_size].abs().max().item()
    print(f"[{tag}] last-position prefill logits (fp32), {tag} kernels vs the bf16 path over "
          f"the dequantised packs: max|diff| {diff:.4e} (tol {tol}; logit std "
          f"{ref.std().item():.3f}), argmax equal: {int(got.argmax()) == int(ref.argmax())}")
    check(torch.isfinite(got).all().item(), f"non-finite {tag} prefill logits")
    check(diff <= tol, f"{tag} prefill logits differ by {diff} > {tol}")
    params = model.params["lm"]
    model.params["lm"] = ref_lm
    ref_tokens = model.generate(emb, max_steps=MAX_STEPS, temperature=0.0, decode=False)
    model.params["lm"] = params
    _print_agreement(f"[{tag}] greedy tokens, {tag} kernels vs dequantised bf16 path",
                     ref_tokens, tokens)
    del ref_lm
    profile_decode_step(torch, model, emb, tag)
    return launches


def phase_int4(torch):
    """Phase 6: a fresh model from the same seed (int4 starts from full
    precision), then the int4 caption path."""
    from magma_tpu_torch.models.magma import Magma

    t0 = time.perf_counter()
    model = Magma(CONFIG, seed=0, device=torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"[int4] Magma({CONFIG.name}) rebuilt from seed 0 in {time.perf_counter() - t0:.1f} s")
    return phase_quantized(torch, model, 4)


def main() -> int:
    if not (ROOT / "magma_tpu_torch").is_dir():
        return fail("run from a checkout of the repository: magma_tpu_torch/ is missing")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: this script measures the port on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))

    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    k1 = phase_kernel(torch)
    int8_entries = phase_int8_kernels(torch)
    int4_entries = phase_int4_kernels(torch)
    model, emb, greedy_tokens, bf16_launches = phase_slice(torch)
    check(bf16_launches > 0, "the bf16 path launched no K1 kernel")
    phase_kernel_vs_plain_path(torch, model, emb, greedy_tokens)
    launches8 = phase_quantized(torch, model, 8)
    for wrapper in (*INT8_KERNELS, "flash_attention_kernel"):
        check(launches8[wrapper] > 0, f"the int8 path launched no {wrapper}")
    del model, emb, greedy_tokens  # free the int8 model before the int4 one
    gc.collect()
    torch.cuda.empty_cache()
    launches4 = phase_int4(torch)
    for wrapper in (*INT4_KERNELS, "int8_matmul_kernel", "flash_attention_kernel"):
        check(launches4[wrapper] > 0, f"the int4 path launched no {wrapper}")

    k1["launches"] = (bf16_launches + launches8["flash_attention_kernel"]
                      + launches4["flash_attention_kernel"])
    kernels = [k1]
    for wrapper in INT8_KERNELS:
        kernels.append(dict(int8_entries[wrapper],
                            launches=launches8[wrapper] + launches4[wrapper]))
    for wrapper in INT4_KERNELS:
        kernels.append(dict(int4_entries[wrapper], launches=launches4[wrapper]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"done in {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
