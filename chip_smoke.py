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
   inputs at the slice's shapes: K2b (in_proj) at M = 1, 5, 37, 192, 256,
   2048 and on the QLoRA layout's o and fc_out at M = 2048, K4a (o_proj +
   fc_out) at M = 1, 192, K5 (the adapter) at M = 1, 64, K2a (the head) at
   M = 1 and at path B's 256-position loss chunk; each timed with its plain
   version and a bf16 ``torch.matmul`` over weights dequantised outside
   the timed call, and every M > 8 result the same bits on a repeat.
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
   inputs at the slice's shapes: K3 (in_proj) at M = 1, 5, 9, 37, 65, 192,
   2048, K4b (o_proj + fc_out) at M = 1, 9, 65, 192 (bit for bit, and the
   same bits on a repeat; above M = 8 the activation pre-pass and the
   wgmma tile), K6 (the layer boundary) at M = 1, 8
   with and without the next in_proj, for the v1 adapter and for an
   attention adapter (scaled_parallel) beside the mlp one with o_bias; each
   timed with its plain version and bf16 PyTorch calls over weights
   dequantised outside the timed call (K6: the same ops as a chain).
2d. K7 and K8 (whole decode layers, ``ops/decode_layer.py``) against their
   plain versions at full width, on seeded int4 and int8 28-layer stacks
   built on the card, over a bf16 and an int8 cache of 256 positions filled
   to pos = 180, for the v1 adapter and for an attention adapter
   (scaled_parallel) beside the mlp one with o_bias: K7 at layer 13 with
   the next in_proj and at layer 27 without, K8 over all 28 layers, and K8
   at pos = 0 (the token alone).  Each case timed with its plain version,
   its bound and the same ops as a chain of bf16 PyTorch calls over
   weights dequantised before timing; then 28 K7 launches against one K8
   launch for the same step, and the time of one grid barrier of K8's grid
   alone.
5. The int8 caption path: the same model after
   ``quantize_for_serving(bits=8)`` answers the same three requests; every
   kernel's launches are checked exactly against the steps taken (each
   b=1 decode step: layer 0's in_proj (K2b), one K8, the head (K2a)); the
   greedy prefill logits are held against the bf16 path over the int8
   packs dequantised back to bf16 (W s).
5b. Decode-path agreement (int8): on the greedy request's prefilled cache,
   bf16 and int8, one decode step through K8, through the path a b <= 8
   step takes (the per-layer chain: K2b, K4a, K5), through 28 K7 launches
   and through K8's plain version: K8's logits within 3e-2 relative of the
   b <= 8 path's and argmax equal, its new cache entries within 3e-2 of
   their largest value (JAX's bounds for this comparison; the int8 codes
   as the values they stand for, code x scale); the plain version's
   distance printed beside K8's, and the distance of each layer's keys;
   the K7 chain equal to K8 bit for bit.
6. The int4 caption path: the int8 model is freed, a fresh ``Magma`` from
   the same seed takes ``quantize_for_serving(bits=4)`` and answers the
   same three requests, with exact launch counts (one K8 a decode step);
   the greedy prefill logits are held against the bf16 path over the int4
   packs dequantised to bf16.
6b. Decode-path agreement (int4), as 5b with the boundary path (layer 0's
   K3, then K6 once a layer).
7. The int8-cache caption path: the int4 model with
   ``kv_cache_dtype="int8"`` answers the same three requests with exact
   launches; its greedy prefill logits equal phase 6's bit for bit (the
   prefill reads fresh keys, never the cache).
2e. The training kernels against their plain versions: K9a/K9b (the flash
   backward) at (b 2, s 2048, h 16, hd 256, causal) and at a padded
   kv_len case of hd 128, each gradient within 2e-2 of its largest
   magnitude and the same bits on a repeat; K1 timed at that training
   shape beside SDPA's causal forward; K10 (the int8 input gradient) at
   M = 2048 on the in_proj, o, fc_out and head shapes and at the head's
   M = 256 loss chunk, within the fp32 summation bound and the same bits
   on a repeat.  Each timed
   with its plain version, its bound and one library call (the backward of
   ``scaled_dot_product_attention(is_causal=True)``; a bf16 matmul of g s
   against weights dequantised before timing).
8. Path A, bf16 adapter training: ``Magma`` from configs/MAGMA_v1.yml as
   it stands (trainable RN50x16, dropout 0.1, flash, remat, seq 2048) with
   warmup_num_steps 1 and a global batch of ga 2 x micro 2, its
   ``Trainer`` taking 3 steps on seeded batches: exact launches a step
   (K1 2L, K9a L, K9b L a micro-step), finite losses, the frozen LM
   bit-unchanged (checksums), every trainable group moved, step ms,
   tokens/s and peak memory; one micro-batch's loss and gradients through
   the kernels against the plain path (einsum attention and autograd) per
   parameter group; one step profiled (device busy, kernels, idle share);
   the optimizer's update of one more step timed alone (wall, the card
   synchronised around it).
9. Path B, QLoRA: the same with ``train_lm_int8`` (frozen int8 LM, bf16
   adapters, encoder frozen), ga 2 x micro 1: K2b 6L, K2a 16 and K10
   3L + 8 a micro-step beside K1/K9 (the plain path also swaps K2a, K2b and
   K10 for their plain versions), then the overfit gate: 10 steps on one
   fixed batch, the 10th loss below the 1st by OVERFIT_MARGIN.

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
DECODE_KERNELS = {  # wrapper name in ops/decode_layer.py -> (JSON name, TPU kernel, source)
    "decode_layer_kernel": ("decode_layer", "magma_tpu/ops/decode_layer.py:89",
                            "magma_tpu_torch/csrc/decode_layer.cu"),
    "decode_all_layers_kernel": ("decode_all_layers", "magma_tpu/ops/decode_layer.py:830",
                                 "magma_tpu_torch/csrc/decode_layer.cu"),
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
# K7 against its plain version: its boundary phases are K6's, so K6's
# tolerance, which also covers its own differences from the plain version:
# the attention's chunked online softmax (exp(s - m_chunk) exp(m_chunk - m)
# against exp(s - m)), the gelu's tanh against PyTorch's, each an fp32
# rounding that can move a ctx or an mh across a bf16 rounding boundary.
# k_new within one bf16 ulp of each value (the fp32 rotary, in the plain
# version's order of operations); v_new is a copy, so exactly.
K7_REL_TOL, K7_MIN_EQUAL = K6_REL_TOL, K6_MIN_EQUAL
# K8's y after 28 chained layers: each layer adds K7's differences, and a
# flip in one layer's y, u or fused moves every later layer a little; 28
# independent layer errors of at most 2^-6 max|y| add to about
# sqrt(28) 2^-6 = 0.083 max|y|, under 2^-3.  Its k_new and v_new rows are
# held to the same bound (layer 0's, before any chained difference, as K7's)
K8_REL_TOL = 2.0 ** -3
# decode-path agreement: JAX's bounds (tests/test_decode_layer.py:92-107)
PATH_REL_TOL = 3e-2
TRAIN_KERNELS = {  # wrapper name -> (JSON name, TPU kernel it replaces, source)
    "flash_attention_bwd_dkv_kernel": ("flash_attn_bwd_dkv", "magma_tpu/ops/flash_attention.py:199",
                                       "magma_tpu_torch/csrc/flash_attn_bwd.cu"),
    "flash_attention_bwd_dq_kernel": ("flash_attn_bwd_dq", "magma_tpu/ops/flash_attention.py:274",
                                      "magma_tpu_torch/csrc/flash_attn_bwd.cu"),
    "int8_matmul_dx_kernel": ("int8_matmul_dx", "magma_tpu/ops/quant.py:201",
                              "magma_tpu_torch/csrc/int8_matmul_dx.cu"),
}
# K9a/K9b against the fp32 plain backward on the same bf16 inputs: the
# kernels round P and dS to bf16 for the tensor cores (2^-9 relative each)
# and their outputs to bf16; each gradient within 2e-2 of its own largest
# magnitude (about 5x the 2^-8 a sum of such roundings reaches)
K9_REL_TOL = 2e-2
# one micro-batch through the kernels vs the plain path (einsum attention;
# path B also the plain int8 products): both round attention to bf16 at
# different points, 2^-8 relative a layer, compounded over 28 layers forward
# and backward (phase 4's prefill logits of the two paths differ by 0.074
# at std 1.3); held per parameter group as |g - g_plain|_2 / |g_plain|_2, and
# the loss relative
TRAIN_GRAD_TOL = 0.1
TRAIN_LOSS_TOL = 1e-2
# path B on one fixed batch: the loss of step 10 below step 1's by at least
# this much (step 1 runs at the warmup's lr 0; 8 updates at lr 8e-4 reach
# the 10th loss; JAX's tiny-model gate asks 0.1 over 5 steps)
OVERFIT_MARGIN = 0.1
TRAIN_STEPS = 3


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
    """Device time (ms) of one call of the kernels whose name contains
    ``match``, from torch.profiler over ``calls`` calls: the kernel alone,
    without the host time that CUDA events around a short call include.
    Each matching kernel launches once a call, so a call takes the sum over
    their names of each one's mean duration: a trace that lost some of its
    device events (torch.profiler's traces now and then do) still gives
    it.  None when two traces record no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in _kernel_events(torch, prof):
            if match in e.name:
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if by_name:
            return sum(statistics.fmean(t) for t in by_name.values()) / 1e3
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
            ops_per_s=BF16_FLOPS, library_is="bf16 torch.matmul over pre-dequantised W",
            plain_iters=10):
    """Time a kernel (CUDA events a call, the profiler alone), its plain
    version and its library yardstick; print them beside the bound and
    return the JSON numbers."""
    ms, lib_ms = cuda_ms(kernel), cuda_ms(library)
    plain_ms = cuda_ms(plain, iters=plain_iters, warmup=min(5, plain_iters))
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
    for m in (1, 5, 37, 192, 256, 2048):
        x = bf16(m, D)
        out = quant.int8_matmul_stacked(x, wq, s, 1)
        ref = quant.int8_matmul_stacked_plain(x, wq, s, 1)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        check(torch.equal(out, quant.int8_matmul_stacked(x, wq, s, 1)),
              f"K2b in_proj M={m}: another result on a repeat")
        tm = None
        if m in (1, 192, 2048):
            it = itertools.cycle(range(L))
            tm = timing("K2b in_proj", m, lambda: quant.int8_matmul_stacked(x, wq, s, next(it)),
                        lambda: quant.int8_matmul_stacked_plain(x, wq, s, next(it)),
                        lambda: torch.matmul(x, w_lib[next(it)]),
                        nbytes(x, wq[0], s[0]) + m * N_IN * 4, 2 * m * D * N_IN,
                        "gemv_kernel" if m <= 8 else "int8_wgmma_tile_kernel")
        # the JSON line carries decode's (M=1) numbers; the log has the others
        report("int8_matmul_stacked_kernel", "K2b in_proj", m, err.max().item(),
               bool((err <= _sum_tol(x, wq[1], s[1], D)).all()), tm if m == 1 else None)
    del wq, s, w_lib

    # K2b at path B's M = 2048 on the QLoRA layout's o and fc_out (each its
    # own stacked product there), 4 and 2 layers cycled
    for label, (k_, layers) in (("o", (D, 4)), ("fc_out", (F_, 2))):
        wq, s = int8(layers, k_, D), scales(layers, D)
        w_lib = [deq(wq[i], s[i]) for i in range(layers)]
        x = bf16(2048, k_)
        out = quant.int8_matmul_stacked(x, wq, s, 1)
        ref = quant.int8_matmul_stacked_plain(x, wq, s, 1)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        check(torch.equal(out, quant.int8_matmul_stacked(x, wq, s, 1)),
              f"K2b {label} M=2048: another result on a repeat")
        it = itertools.cycle(range(layers))
        timing(f"K2b {label}", 2048, lambda: quant.int8_matmul_stacked(x, wq, s, next(it)),
               lambda: quant.int8_matmul_stacked_plain(x, wq, s, next(it)),
               lambda: torch.matmul(x, w_lib[next(it)]),
               nbytes(x, wq[0], s[0]) + 2048 * D * 4, 2 * 2048 * k_ * D, "int8_wgmma_tile_kernel")
        report("int8_matmul_stacked_kernel", f"K2b {label}", 2048, err.max().item(),
               bool((err <= _sum_tol(x, wq[1], s[1], k_)).all()))
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
                    "gemv_kernel" if m <= 8 else "int8_wgmma_tile_kernel")
        a2, mo2 = quant.dual_matmul_stacked(ctx, h, w, 2)
        check(torch.equal(a, a2) and torch.equal(mo, mo2),
              f"K4a M={m}: another result on a repeat")
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

    # K2a: the untied head, decode's M=1 and path B's 256-position loss
    # chunk; 206 MB, larger than L2 by itself
    wq, s = int8(D, V), scales(V)
    w_lib = deq(wq, s)
    for m in (1, 256):
        x = bf16(m, D)
        out, ref = quant.int8_matmul(x, wq, s), quant.int8_matmul_plain(x, wq, s)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        check(torch.equal(out, quant.int8_matmul(x, wq, s)),
              f"K2a M={m}: another result on a repeat")
        tm = timing("K2a head", m, lambda: quant.int8_matmul(x, wq, s),
                    lambda: quant.int8_matmul_plain(x, wq, s), lambda: torch.matmul(x, w_lib),
                    nbytes(x, wq, s) + m * V * 4, 2 * m * D * V,
                    "gemv_kernel" if m <= 8 else "int8_wgmma_tile_kernel")
        report("int8_matmul_kernel", "K2a head", m, err.max().item(),
               bool((err <= _sum_tol(x, wq, s, D)).all()), tm if m == 1 else None)
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
    for m in (1, 5, 9, 37, 65, 192, 2048):
        x = bf16(m, D)
        out = quant.int4_matmul_stacked(x, q4, s4, 1)
        ref = quant.int4_matmul_stacked_plain(x, q4, s4, 1)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(torch.equal(out, quant.int4_matmul_stacked(x, q4, s4, 1)),
              f"K3 in_proj M={m}: another result on a repeat")
        tm = None
        if m in (1, 192, 2048):
            it = itertools.cycle(range(L))
            # alone: the GEMV at M <= 8, else the activation pre-pass and the tile
            tm = timing("K3 in_proj", m, lambda: quant.int4_matmul_stacked(x, q4, s4, next(it)),
                        lambda: quant.int4_matmul_stacked_plain(x, q4, s4, next(it)),
                        lambda: torch.matmul(x, w_lib[next(it)]),
                        nbytes(x, q4[0], s4[0]) + m * N_IN * 4, 2 * m * D * N_IN,
                        "w4a8_gemv_kernel" if m <= 8 else "w4a8_wgmma",
                        plain_iters=3 if m == 2048 else 10)
        # the JSON line carries the prefill's (M=192) numbers; the log has the others
        report("int4_matmul_stacked_kernel", "K3 in_proj", m, err, err <= INT4_TOL,
               tm if m == 192 else None)
    del q4, s4, w_lib

    # K4b: o_proj + fc_out, 2 layers of 42.6 MB cycled
    qo, so = int4_stack(L, D, D)
    qf, sf = int4_stack(L, F_, D)
    w = {"q4": torch.cat([qo, qf], 1), "s4": torch.cat([so, sf], 1)}
    lib_o = [deq(qo[i], so[i]) for i in range(L)]
    lib_f = [deq(qf[i], sf[i]) for i in range(L)]
    del qo, so, qf, sf
    for m in (1, 9, 65, 192):
        ctx, h = bf16(m, D), bf16(m, F_, std=0.5)
        a, mo = quant.dual_matmul_stacked(ctx, h, w, 1)
        ra, rm = quant.dual_matmul_stacked_plain(ctx, h, w, 1)
        torch.cuda.synchronize()
        err = max((a - ra).abs().max().item(), (mo - rm).abs().max().item())
        a2, mo2 = quant.dual_matmul_stacked(ctx, h, w, 1)
        check(torch.equal(a, a2) and torch.equal(mo, mo2),
              f"K4b M={m}: another result on a repeat")
        if m not in (1, 192):
            report("int4_dual_kernel", "K4b out_proj", m, err, err <= INT4_TOL)
            continue
        it = itertools.cycle(range(L))

        def library():
            i = next(it)
            return torch.matmul(ctx, lib_o[i]), torch.matmul(h, lib_f[i])

        tm = timing("K4b out_proj", m, lambda: quant.dual_matmul_stacked(ctx, h, w, next(it)),
                    lambda: quant.dual_matmul_stacked_plain(ctx, h, w, next(it)), library,
                    nbytes(ctx, h, w["q4"][0], w["s4"][0]) + 2 * m * D * 4,
                    2 * m * (D + F_) * D, "w4a8_gemv_kernel" if m <= 8 else "w4a8_wgmma")
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


def _declayer_stacks(torch, g, fmt, L, D, F_, DH):
    """Seeded 28-layer serving stacks of ``fmt`` built on the card, one layer
    at a time: the dual (o_proj + fc_out), the in_proj, two fused adapters
    and the vectors."""
    from magma_tpu_torch.ops import quant

    dev = torch.device("cuda")

    def w(k, n):
        return torch.randn((k, n), generator=g, device=dev) * 0.02

    def stack(k, n):
        q = (lambda a: quant.quantize_int4(a, compiled=True)) if fmt == "int4" else \
            (lambda a: quant.quantize_int8(a, compiled=True))
        packs = [q(w(k, n)) for _ in range(L)]
        return {key: torch.stack([p[key] for p in packs]) for key in packs[0]}

    o, f = stack(D, D), stack(F_, D)
    if fmt == "int4":
        dual = {"q4": torch.cat([o["q4"], f["q4"]], 1), "s4": torch.cat([o["s4"], f["s4"]], 1)}
    else:
        dual = {"q": torch.cat([o["q"], f["q"]], 1), "s": torch.stack([o["s"], f["s"]], 1)}
    del o, f
    w_in = stack(D, 3 * D + F_)

    def vec(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev) * std

    def adapter():
        return quant.quantize_adapter_fused(vec(L, D, DH, std=0.05), vec(L, DH),
                                            vec(L, DH, D, std=0.05), vec(L, D),
                                            out_scale=1 + vec(L, std=0.5))

    vecs = dict(b_fc_in=vec(L, F_, std=0.1), b_fc_out=vec(L, D), ln_g=1 + vec(L, D, std=0.1),
                ln_b=vec(L, D), o_bias=vec(L, D))
    return dual, w_in, adapter(), adapter(), vecs


def _dequant_chain_weights(torch, quant, dual, w_in, fz_list, D, L):
    """bf16 copies of every layer's weights for the chain yardstick."""
    bf = torch.bfloat16

    def deq(q, s):
        if "q4" in q:
            return quant.dequantize_int4(q["q4"], q["s4"]).to(bf)
        return (q["q"].float() * s).to(bf)

    out = []
    for l in range(L):
        if "q4" in dual:
            wo = quant.dequantize_int4(dual["q4"][l, :D // 2], dual["s4"][l, :D // 256]).to(bf)
            wf = quant.dequantize_int4(dual["q4"][l, D // 2:], dual["s4"][l, D // 256:]).to(bf)
            wi = quant.dequantize_int4(w_in["q4"][l], w_in["s4"][l]).to(bf)
        else:
            wo = (dual["q"][l, :D].float() * dual["s"][l, 0]).to(bf)
            wf = (dual["q"][l, D:].float() * dual["s"][l, 1]).to(bf)
            wi = (w_in["q"][l].float() * w_in["s"][l]).to(bf)
        ads = [None if fz is None else dict(
            wd=(fz["wd"][l].float() * fz["sd"][l]).to(bf), bd=fz["bd"][l, 0].to(bf),
            wu=(fz["wu"][l].float() * fz["su"][l]).to(bf), bu=fz["bu"][l, 0].to(bf))
            for fz in fz_list]
        out.append(dict(o=wo, f=wf, w_in=wi, ad=ads))
    return out


def _chain_step(torch, lib, vecs, fused, x, u_in, sincos, kc, vc, kvs, pos, layers, kw):
    """The same ops as bf16 PyTorch calls over dequantised weights, layer by
    layer: rotary, the decode attention over the cache, gelu, the two dual
    matmuls, biases, adapters, residual, LayerNorm, the next in_proj."""
    import torch.nn.functional as F

    from magma_tpu_torch.ops.attention import decode_attention
    from magma_tpu_torch.ops.rotary import apply_rotary

    bf = torch.bfloat16
    h = kw["n_heads"]
    D = x.shape[1]
    hd = D // h
    sin, cos = sincos
    rd = 2 * sin.shape[-1]
    srcs = (kw.get("attn_src", "out"), kw.get("mlp_src", "out"))
    for l in layers:
        p = lib[l]
        q, k, v = (fused[:, i * D:(i + 1) * D].reshape(1, 1, h, hd) for i in range(3))
        q, k = apply_rotary(q, sin, cos, rd), apply_rotary(k, sin, cos, rd)
        scales = None if kvs is None else (kvs[0][l], kvs[1][l])
        ctx = decode_attention(q, kc[l], vc[l], pos, scale=kw["scale"], self_kv=(k, v),
                               kv_scales=scales).reshape(1, D)
        mh = F.gelu(fused[:, 3 * D:] + vecs["b_fc_in"][l].to(bf), approximate="tanh")
        a = ctx @ p["o"]
        if kw.get("o_bias") is not None:
            a = a + vecs["o_bias"][l].to(bf)
        m = mh @ p["f"] + vecs["b_fc_out"][l].to(bf)
        outs = []
        for br, ad, src in zip((a, m), p["ad"], srcs):
            if ad is not None:
                inp = u_in if src == "in" else br
                br = br + (torch.relu(inp @ ad["wd"] + ad["bd"]) @ ad["wu"] + ad["bu"])
            outs.append(br)
        x = x + outs[0] + outs[1]
        u_in = F.layer_norm(x.float(), (D,), vecs["ln_g"][l], vecs["ln_b"][l]).to(bf)
        if l + 1 < len(lib):
            fused = u_in @ lib[l + 1]["w_in"]
    return x


def _declayer_work(fz_list, dual, w_in, kc, kvs, pos, layers, in_layers, has_ob, D, F_, h, hd):
    """(bytes, operations) of the weights and cache that the layers read:
    each layer's dual, adapters and vectors, the next in_proj of each layer
    in ``in_layers``, and the cache rows below pos (with their scales).
    The caller adds the activations read and written."""
    n_bytes = ops = 0
    for l in layers:
        n_bytes += nbytes(*[t[l] for t in dual.values()]) + (F_ + (3 + has_ob) * D) * 4
        ops += 2 * (D + F_) * D + 4 * pos * h * hd
        for fz in fz_list:
            if fz is not None:
                n_bytes += nbytes(*[fz[k][l] for k in ("wd", "wu", "sd", "bd", "su", "bu")])
                ops += 4 * D * fz["wd"].shape[2]
        n_bytes += 2 * pos * h * hd * kc.element_size() + (2 * pos * h * 2 if kvs else 0)
        if l in in_layers:
            n_bytes += nbytes(*[t[l + 1] for t in w_in.values()])
            ops += 2 * D * (3 * D + F_)
    return n_bytes, ops


def phase_decode_layer_kernels(torch):
    """K7 and K8 against their plain versions at full width.  Returns their
    JSON entries by wrapper name (launches unset)."""
    import torch.nn.functional as F  # noqa: F401  (the chain's ops)

    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops import decode_layer as dl
    from magma_tpu_torch.ops import quant
    from magma_tpu_torch.ops.rotary import rotary_sincos

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    L, D, F_, DH, h, hd, MAX_LEN, POS = 28, 4096, 16384, 1024, 16, 256, 256, 180
    bf = torch.bfloat16
    entries = {}

    def report(wrapper, label, errs, ok, timed=None):
        print(f"[{label}] max|kernel-plain| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; within tolerance: {ok}")
        check(ok, f"{label}: kernel differs from its plain version: {errs}")
        entry = entries.setdefault(wrapper, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], *errs.values())
        if timed is not None:
            entry.update(timed)

    def compare(got, ref, names, rel, min_equal, label):
        """K7's rule (min_equal set): v_new exact, k_new within one bf16 ulp
        of each value, the rest within rel max|ref| and min_equal of the
        elements equal.  K8's (min_equal None): all within rel max|ref|."""
        errs, ok = {}, True
        for gt, rf, name in zip(got, ref, names):
            diff = (gt.float() - rf.float()).abs()
            errs[name] = diff.max().item()
            if name == "v_new" and min_equal is not None:
                ok = ok and torch.equal(gt, rf)
            elif name == "k_new" and min_equal is not None:
                ok = ok and bool((diff <= 2.0 ** -7 * rf.float().abs()).all())
            else:
                tol = rel * rf.float().abs().max().item()
                equal = (diff == 0).float().mean().item()
                ok = ok and errs[name] <= tol and (min_equal is None or equal >= min_equal)
                print(f"[{label}]   {name}: max|diff| {errs[name]:.3e} (tol {tol:.3e}), "
                      f"{equal:.4%} of elements equal")
        return errs, ok

    shape = (L, 1, MAX_LEN, h, hd)
    k_bf, v_bf = (torch.randn(shape, generator=g, device=dev).to(bf) for _ in range(2))
    (k8, ks), (v8, vs) = gptj._quantize_kv(k_bf), gptj._quantize_kv(v_bf)
    caches = {"bf16": (k_bf, v_bf, None), "int8": (k8, v8, (ks, vs))}
    ins = dict(fused=torch.randn((1, 3 * D + F_), generator=g, device=dev).to(bf),
               x=(torch.randn((1, D), generator=g, device=dev) * 0.3).to(bf),
               u=torch.randn((1, D), generator=g, device=dev).to(bf))
    for fmt in ("int4", "int8"):
        dual, w_in, ad1, ad2, vecs = _declayer_stacks(torch, g, fmt, L, D, F_, DH)
        lib = _dequant_chain_weights(torch, quant, dual, w_in, (ad2, ad1), D, L)
        lib_v1 = [dict(p, ad=[None, p["ad"][1]]) for p in lib]
        recipes = {"v1": (dict(fz_mlp=ad1, mlp_src="out"), lib_v1),
                   "scaled": (dict(fz_mlp=ad1, mlp_src="out", fz_attn=ad2, attn_src="in",
                                   o_bias=vecs["o_bias"]), lib)}
        ops_rate = INT8_OPS if fmt == "int4" else BF16_FLOPS
        for kv, (kc, vc, kvs) in caches.items():
            for recipe, (rkw, rlib) in recipes.items():
                kw = dict(rkw, n_heads=h, scale=hd ** -0.5)
                fz_list = (rkw.get("fz_attn"), rkw["fz_mlp"])
                pos_cases = [POS] + ([0] if kv == "bf16" and recipe == "v1" else [])
                for pos in pos_cases:
                    sincos = rotary_sincos(torch.tensor([pos], device=dev), 64)
                    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
                    cache_args = (kc, vc, kvs, pos_t)
                    tag = f"{fmt}, {kv} cache, {recipe}, pos {pos}"
                    vec_args = (vecs["b_fc_in"], vecs["b_fc_out"], vecs["ln_g"], vecs["ln_b"])
                    if pos == POS:  # K7 at a middle layer with w_in and at the last one
                        for layer in (13, L - 1):
                            with_in = layer < L - 1
                            args = (ins["fused"], ins["x"], sincos, *cache_args, dual, *vec_args,
                                    layer)
                            ckw = dict(kw, w_in=w_in if with_in else None, u_in=ins["u"])
                            got = dl.decode_layer_fused(*args, **ckw)
                            ref = dl.decode_layer_plain(*args, **ckw)
                            torch.cuda.synchronize()
                            names = (("y", "u", "fused") if with_in else ("y", "u")) + \
                                ("k_new", "v_new")
                            label = f"K7 layer {layer}, {tag}"
                            errs, ok = compare(got, ref, names, K7_REL_TOL, K7_MIN_EQUAL, label)
                            n_bytes, ops = _declayer_work(
                                fz_list, dual, w_in, kc, kvs, pos, [layer],
                                [layer] if with_in else [], "o_bias" in rkw, D, F_, h, hd)
                            # fused, x, u in; y, u, [fused], k_new, v_new out
                            n_bytes += (3 * D + F_) * 2 * (1 + with_in) + 2 * D * 2 + 4 * D * 2
                            tm = _timing(
                                torch, label, 1, lambda: dl.decode_layer_fused(*args, **ckw),
                                lambda: dl.decode_layer_plain(*args, **ckw),
                                lambda: _chain_step(torch, rlib, vecs, ins["fused"], ins["x"],
                                                    ins["u"], sincos, kc, vc, kvs, pos_t,
                                                    [layer], kw),
                                n_bytes, ops, "decode_layers_kernel", ops_per_s=ops_rate,
                                library_is="the same ops as a chain of bf16 PyTorch calls")
                            main = fmt == "int4" and kv == "bf16" and recipe == "v1" and with_in
                            report("decode_layer_kernel", label, errs, ok,
                                   dict(tm, library_ms=None, chain_ms=tm["library_ms"])
                                   if main else None)
                    # K8 over all layers
                    args = (ins["fused"], ins["x"], ins["u"], sincos, *cache_args, dual, w_in,
                            *vec_args)
                    got = dl.decode_all_layers_fused(*args, **kw)
                    ref = dl.decode_all_layers_plain(*args, **kw)
                    torch.cuda.synchronize()
                    label = f"K8, {tag}"
                    errs, ok = compare(got, ref, ("y", "k_new", "v_new"), K8_REL_TOL, None, label)
                    e0, ok0 = compare((got[1][0], got[2][0]), (ref[1][0], ref[2][0]),
                                      ("k_new", "v_new"), 0, 1.0, label + ", layer 0")
                    n_bytes, ops = _declayer_work(
                        fz_list, dual, w_in, kc, kvs, pos, range(L), range(L - 1),
                        "o_bias" in rkw, D, F_, h, hd)
                    # fused0, x0, u0 in; y and L rows of k_new and v_new out
                    n_bytes += (3 * D + F_) * 2 + 2 * D * 2 + D * 2 + 2 * L * D * 2
                    tm = _timing(torch, label, 1, lambda: dl.decode_all_layers_fused(*args, **kw),
                                 lambda: dl.decode_all_layers_plain(*args, **kw),
                                 lambda: _chain_step(torch, rlib, vecs, ins["fused"], ins["x"],
                                                     ins["u"], sincos, kc, vc, kvs, pos_t,
                                                     range(L), kw),
                                 n_bytes, ops, "decode_layers_kernel", ops_per_s=ops_rate,
                                 library_is="the same ops as a chain of bf16 PyTorch calls",
                                 plain_iters=2)
                    main = fmt == "int4" and kv == "bf16" and recipe == "v1" and pos == POS
                    report("decode_all_layers_kernel", label, {**errs, "k0": e0["k_new"]},
                           ok and ok0,
                           dict(tm, library_ms=None, chain_ms=tm["library_ms"]) if main else None)
                    if main or (fmt == "int8" and kv == "bf16" and recipe == "v1" and pos == POS):
                        _k7_chain_vs_k8(torch, dl, args, kw, L, label)
        del dual, w_in, ad1, ad2, vecs, lib, lib_v1, recipes
        gc.collect()
        torch.cuda.empty_cache()
    _grid_barrier_cost(torch, L)
    for wrapper, (name, replaces, source) in DECODE_KERNELS.items():
        entries[wrapper].update(name=name, route="cuda", replaces=replaces, source=source)
    return entries


def _grid_barrier_cost(torch, L):
    """What K8's grid barriers cost alone: cooperative launches of K8's grid
    that cross n barriers and do nothing else (``magma_grid_sync_probe``),
    timed by CUDA events; the slope over n is the cost of one barrier."""
    import ctypes

    from magma_tpu_torch.cuda_build import load_library

    probe = load_library().magma_grid_sync_probe
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    per_step = 9 * (L - 1) + 6  # K8's barriers in an L-layer step

    def run(n):
        err = probe(n, stream)
        check(err == 0, f"grid barrier probe failed: cudaError {err}")

    ms = {n: cuda_ms(lambda n=n: run(n), iters=20) for n in (0, per_step, 10 * per_step)}
    us = (ms[10 * per_step] - ms[0]) / (10 * per_step) * 1e3
    print(f"[K8 barriers] one grid barrier of K8's grid alone: {us:.3f} us (CUDA events, median "
          f"of 20; launches of 0, {per_step} and {10 * per_step} barriers: "
          + ", ".join(f"{v:.4f} ms" for v in ms.values())
          + f"); {per_step} a {L}-layer step: {per_step * us / 1e3:.4f} ms")


def _k7_chain_vs_k8(torch, dl, args, kw, L, label):
    """One decode step as 28 K7 launches against one K8 launch: the same
    device code, so the same bits; the difference in time is what 27 more
    launches cost (JAX's reason for K8, decode_layer.py:830-838)."""
    fused0, x0, u0, sincos, kc, vc, kvs, pos_t, dual, w_in, *vec_args = args

    def k7_chain():
        f, xx, uu = fused0, x0, u0
        rows = []
        for l in range(L):
            outs = dl.decode_layer_fused(f, xx, sincos, kc, vc, kvs, pos_t, dual, *vec_args, l,
                                         w_in=w_in if l < L - 1 else None, u_in=uu, **kw)
            if l < L - 1:
                xx, uu, f = outs[:3]
            else:
                xx, uu = outs[:2]
            rows.append(outs[-2])
        return xx, torch.stack(rows)

    def k8():
        return dl.decode_all_layers_fused(*args, **kw)

    y7, k7 = k7_chain()
    y8, k8_rows, _ = k8()
    torch.cuda.synchronize()
    same = torch.equal(y7, y8) and torch.equal(k7, k8_rows)
    ms7, ms8 = cuda_ms(k7_chain, iters=10), cuda_ms(k8, iters=10)
    print(f"[{label}] 28 K7 launches {ms7:.4f} ms vs one K8 launch {ms8:.4f} ms a step "
          f"(CUDA events, median of 10): {ms7 - ms8:.4f} ms for 27 more launches; "
          f"y and k_new bit-equal: {same}")
    check(same, f"{label}: the K7 chain differs from K8")


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


def _all_wrappers():
    """Every kernel wrapper by name, K1 included."""
    from magma_tpu_torch.ops import decode_layer, flash_attention, quant

    wrappers = {name: getattr(quant, name) for name in (*INT8_KERNELS, *INT4_KERNELS)}
    wrappers.update({name: getattr(decode_layer, name) for name in DECODE_KERNELS})
    wrappers["flash_attention_kernel"] = flash_attention.flash_attention_kernel
    for name in TRAIN_KERNELS:
        wrappers[name] = getattr(quant if name == "int8_matmul_dx_kernel" else flash_attention,
                                 name)
    return wrappers


def _want_launches(bits, L, steps):
    """Exact launches of one request of ``steps`` tokens (1 prefill + steps-1
    decode forwards) on the v1 recipe, by wrapper."""
    if bits == 8:
        # prefill: K2b and K4a once a layer (the adapter's 192 rows take the
        # dequantising matmul, no K5); a decode step: K2b for layer 0's
        # in_proj, then one K8 for all layers; K2a once a forward
        want = {"int8_matmul_stacked_kernel": L + steps - 1, "dual_matmul_kernel": L,
                "int8_matmul_kernel": steps}
    else:
        # the same with K3 and K4b; no K6
        want = {"int4_matmul_stacked_kernel": L + steps - 1, "int4_dual_kernel": L,
                "int8_matmul_kernel": steps}
    want["decode_all_layers_kernel"] = steps - 1
    want["flash_attention_kernel"] = L
    return {k: want.get(k, 0) for k in _all_wrappers()}


def phase_quantized(torch, model, bits):
    """The int8 (bits=8) or int4 (bits=4) caption path:
    quantize_for_serving(bits), three requests with exact launch counts of
    every kernel, and the greedy prefill logits against the bf16 path over
    the dequantised packs.  Returns (launches by wrapper, the greedy
    request's embeddings and tokens)."""
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
    launches, greedy = _requests_with_launches(torch, model, bits, tag)
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
    return launches, emb, tokens


def _requests_with_launches(torch, model, bits, tag):
    """The three requests, each with exact launches of every kernel, counts
    set to 0 just before.  Returns (launches by wrapper, (greedy request's
    embeddings, tokens))."""
    L = model.lm_config.n_layers
    wrappers = _all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0  # count this path only
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
    return {k: fn.launches for k, fn in wrappers.items()}, greedy


def phase_int4(torch):
    """Phase 6: a fresh model from the same seed (int4 starts from full
    precision), then the int4 caption path.  Returns (model, launches,
    greedy embeddings, greedy tokens)."""
    from magma_tpu_torch.models.magma import Magma

    t0 = time.perf_counter()
    model = Magma(CONFIG, seed=0, device=torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"[int4] Magma({CONFIG.name}) rebuilt from seed 0 in {time.perf_counter() - t0:.1f} s")
    return (model, *phase_quantized(torch, model, 4))


def _prefilled_cache(torch, cfg, lm, emb):
    """The prompt's prefill into a fresh cache of generate's length."""
    from magma_tpu_torch.models import gptj

    s = emb.shape[1]
    padded = torch.nn.functional.pad(emb, (0, 0, 0, (-s) % 64))
    max_len = -(-(s + MAX_STEPS) // 64) * 64
    cache = gptj.init_kv_cache(cfg, 1, max_len, device=emb.device)
    kv_len = torch.full((1,), s, dtype=torch.int32, device=emb.device)
    gptj.forward(cfg, lm, padded, cache=cache, cache_index=0, kv_len=kv_len, return_hidden=True)
    return cache


def _step_without_k8(torch, cfg, lm, x, cache, idx):
    """One b=1 decode step on the path a b <= 8 step takes: the boundary
    decode (int4: layer 0's K3, then K6 once a layer) or the per-layer
    chain (int8: K2b, K4a, K5 a layer).  Returns (hidden after the last
    layer, new keys, new values (L, 1, 1, h, hd))."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops.rotary import rotary_sincos

    blocks = lm["blocks"]
    sin, cos = rotary_sincos(idx.reshape(1, 1), cfg.rotary_dim)
    if gptj._boundary_ok(cfg, blocks, x):
        return gptj._run_decode_boundary(cfg, blocks, x, sin, cos, cache, idx)
    kn, vn = [], []
    for i, bp in enumerate(gptj._layer_views(blocks, cfg.n_layers)):
        x, (k, v) = gptj._block(cfg, bp, x, sin, cos, None, (cache, i), idx)
        kn.append(k)
        vn.append(v)
    return x, torch.stack(kn), torch.stack(vn)


def _step_k7(torch, cfg, lm, x, cache, idx):
    """One b=1 decode step as 28 K7 launches (``decode_layer_fused``), fed
    as ``gptj._run_decode_fused_layers`` feeds K8.  Returns (hidden, new
    keys, new values (L, 1, 1, h, hd))."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops.decode_layer import decode_layer_fused
    from magma_tpu_torch.ops.rotary import rotary_sincos

    blocks = lm["blocks"]
    attn_w, bv = blocks["attn"], blocks["bvecs"]
    L, D, h, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim
    kw = dict(n_heads=h, scale=hd ** -0.5, ln_eps=cfg.ln_eps, o_bias=bv.get("o_bias"),
              **gptj._fused_adapter_kwargs(cfg, blocks))
    sincos = rotary_sincos(idx.reshape(1), cfg.rotary_dim)
    kvs = (cache["k_scale"], cache["v_scale"]) if "k_scale" in cache else None
    xx = x.reshape(1, D)
    u = gptj._layer_norm(xx, {"scale": blocks["ln_1"]["scale"][0],
                              "bias": blocks["ln_1"]["bias"][0]}, cfg.ln_eps, cfg.compute_dtype)
    fused = gptj._mm(u, {**attn_w["in_proj"], "idx": 0}, cfg.compute_dtype)
    fc_in_b = blocks["mlp"]["fc_in"]["bias"].float()
    kn, vn = [], []
    for l in range(L):
        outs = decode_layer_fused(fused, xx, sincos, cache["k"], cache["v"], kvs, idx,
                                  attn_w["out_proj"], fc_in_b, bv["b_fc_out"], bv["ln_g"],
                                  bv["ln_b"], l, w_in=attn_w["in_proj"] if l < L - 1 else None,
                                  u_in=u, **kw)
        if l < L - 1:
            xx, u, fused = outs[:3]
        else:
            xx, u = outs[:2]
        kn.append(outs[-2])
        vn.append(outs[-1])
    return (xx.reshape(1, 1, D), torch.stack(kn).reshape(L, 1, 1, h, hd),
            torch.stack(vn).reshape(L, 1, 1, h, hd))


def _step_k8_plain(torch, cfg, lm, x, cache, idx):
    """One b=1 decode step fed as ``gptj._run_decode_fused_layers`` feeds K8,
    with K8's plain version (the JAX oracle's arithmetic) in its place."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops import decode_layer

    entry = decode_layer.decode_all_layers_fused
    decode_layer.decode_all_layers_fused = decode_layer.decode_all_layers_plain
    try:
        return gptj._run_decode_fused_layers(cfg, lm["blocks"], x, idx.reshape(1, 1), cache, idx)
    finally:
        decode_layer.decode_all_layers_fused = entry


def _new_entries(cache, idx):
    """The cache entries written at position idx, by leaf, as fp32, and the
    K and V entries as the values attention reads (codes times scales for
    an int8 cache), each (L, h, hd)."""
    i = int(idx)
    leaves = {k: (t[:, 0, i] if k in ("k", "v") else t[:, 0, :, i]).float()
              for k, t in cache.items()}
    values = {k: leaves[k] * leaves[f"{k}_scale"][..., None] if "k_scale" in cache
              else leaves[k] for k in ("k", "v")}
    return leaves, values


def _rel(a, b):
    """max|a - b| / max|b|, JAX's measure for this comparison."""
    return ((a - b).abs().max() / (b.abs().max() + 1e-6)).item()


def phase_decode_agreement(torch, model, emb, tokens, tag):
    """Phases 5b and 6b: one decode step on the greedy request's prefilled
    cache, bf16 and int8, through K8, through the b <= 8 path (K6 or K5 on
    their decode paths), through 28 K7 launches and through K8's plain
    version.  Returns the launches by wrapper, counted from 0 over the
    phase."""
    from magma_tpu_torch.models import gptj

    cfg0, lm = model.lm_config, model.params["lm"]
    L = cfg0.n_layers
    dev = emb.device
    wrappers = _all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0  # count this path only
    x = gptj.embed_tokens(cfg0, lm, torch.as_tensor(tokens[:, :1], device=dev))
    idx = torch.full((1,), emb.shape[1], dtype=torch.int32, device=dev)
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(cfg0, kv_cache_dtype=kv)
        cache = _prefilled_cache(torch, cfg, lm, emb)
        check(gptj._declayer_ok(cfg, lm["blocks"], x, cache), f"{tag}: the K8 gate refused")
        before = {k: fn.launches for k, fn in wrappers.items()}
        steps = {}
        for path, step in (("K8", lambda c: gptj._run_decode_fused_layers(cfg, lm["blocks"], x,
                                                                        idx.reshape(1, 1), c, idx)),
                           ("b <= 8", lambda c: _step_without_k8(torch, cfg, lm, x, c, idx)),
                           ("28 x K7", lambda c: _step_k7(torch, cfg, lm, x, c, idx)),
                           ("K8 plain", lambda c: _step_k8_plain(torch, cfg, lm, x, c, idx))):
            c = {k: t.clone() for k, t in cache.items()}
            hid, kn, vn = step(c)
            c = gptj._write_cache(c, kn, vn, idx)
            logits = gptj.lm_head(cfg, lm, gptj._layer_norm(hid, lm["ln_f"], cfg.ln_eps,
                                                            cfg.compute_dtype))[0, -1]
            steps[path] = (hid, logits, c)
        torch.cuda.synchronize()
        got = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        print(f"[{tag} agreement] {kv} cache: launches {got}")
        k_b8 = "boundary_kernel" if "q4" in lm["blocks"]["attn"]["in_proj"] else \
            "fused_adapter_kernel"
        check(got["decode_all_layers_kernel"] == 1 and got["decode_layer_kernel"] == L
              and got[k_b8] == L, f"{tag} agreement: launches {got}")
        _, lb, cb = steps["b <= 8"]
        leaves_b, values_b = _new_entries(cb, idx)
        measured = {}
        for path in ("K8", "K8 plain"):
            _, lg, c = steps[path]
            leaves, values = _new_entries(c, idx)
            measured[path] = dict(
                logits=_rel(lg, lb), argmax=int(lg.argmax()) == int(lb.argmax()),
                leaves={k: _rel(leaves[k], leaves_b[k]) for k in leaves_b},
                values={k: _rel(values[k], values_b[k]) for k in values_b},
                layers={k: [_rel(values[k][l], values_b[k][l]) for l in range(L)]
                        for k in values_b})
            m = measured[path]
            print(f"[{tag} agreement] {kv} cache, {path} vs the b <= 8 path ({k_b8}): logits rel "
                  f"{m['logits']:.3e}, argmax equal {m['argmax']}, new cache entries rel by "
                  f"leaf " + ", ".join(f"{k} {v:.3e}" for k, v in m["leaves"].items())
                  + ", as values " + ", ".join(f"{k} {v:.3e}" for k, v in m["values"].items()))
            print(f"[{tag} agreement] {kv} cache, {path}: k entries rel by layer "
                  + " ".join(f"{v:.1e}" for v in m["layers"]["k"]))
        # JAX's bounds on the logits and on every leaf of a bf16 cache and
        # the scales of an int8 one; the int8 codes are held as the values
        # they stand for (code x scale): each code is relative to its own
        # (position, head) row's largest value, so a leaf-wide measure on
        # the codes magnifies a row at a third of the layer's largest value
        # three times
        m = measured["K8"]
        held = {k: v for k, v in m["leaves"].items() if kv == "bf16" or k.endswith("_scale")}
        held.update({f"{k} values": v for k, v in m["values"].items()} if kv == "int8" else {})
        print(f"[{tag} agreement] {kv} cache, K8 vs the b <= 8 path: held to {PATH_REL_TOL}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in held.items()))
        check(m["logits"] < PATH_REL_TOL and m["argmax"],
              f"{tag} {kv}: K8 vs b <= 8 logits rel {m['logits']}")
        check(all(v < PATH_REL_TOL for v in held.values()),
              f"{tag} {kv}: new cache entries differ: {held}")
        c8 = steps["K8"][2]
        (h7, _, c7), (h8, _, _) = steps["28 x K7"], steps["K8"]
        same = torch.equal(h7, h8) and all(torch.equal(c7[k], c8[k]) for k in c8)
        print(f"[{tag} agreement] {kv} cache, 28 K7 launches vs one K8: hidden state and "
              f"cache bit-equal: {same}")
        check(same, f"{tag} {kv}: the K7 chain differs from K8")
        del cache, steps
    return {k: fn.launches for k, fn in wrappers.items()}


def phase_int4_kv8(torch, model, emb, tokens6):
    """Phase 7: the int4 model with an int8 cache answers the three
    requests with exact launches; its greedy prefill logits equal phase 6's
    bit for bit.  Returns the launches by wrapper."""
    from magma_tpu_torch.models import gptj

    cfg6 = model.lm_config
    cfg7 = dataclasses.replace(cfg6, kv_cache_dtype="int8")
    lm = model.params["lm"]
    max_len = -(-(emb.shape[1] + MAX_STEPS) // 64) * 64
    bytes6 = nbytes(*gptj.init_kv_cache(cfg6, 1, max_len, device=emb.device).values())
    bytes7 = nbytes(*gptj.init_kv_cache(cfg7, 1, max_len, device=emb.device).values())
    print(f"[int4+kv8] the KV cache of a request ({max_len} positions): {bytes7 / 1e6:.2f} MB "
          f"int8 with bf16 scales, against {bytes6 / 1e6:.2f} MB bf16")
    model.lm_config = cfg7
    launches, (emb7, tokens7) = _requests_with_launches(torch, model, 4, "int4+kv8")
    l6 = _prefill_last_logits(torch, cfg6, lm, emb7)
    l7 = _prefill_last_logits(torch, cfg7, lm, emb7)
    same = torch.equal(l6, l7)
    print(f"[int4+kv8] greedy prefill logits equal to the bf16 cache's bit for bit: {same}")
    check(same, "the int8 cache changed the prefill logits")
    _print_agreement("[int4+kv8] greedy tokens, int8 cache vs bf16 cache (phase 6)",
                     tokens6, tokens7)
    profile_decode_step(torch, model, emb7, "int4+kv8")
    model.lm_config = cfg6
    return launches


def phase_train_kernels(torch):
    """K9a, K9b and K10 against their plain versions at the training
    shapes.  Returns their JSON entries by wrapper name (launches unset)."""
    import torch.nn.functional as F

    from magma_tpu_torch.ops import quant
    from magma_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_dkv_kernel,
                                                     flash_attention_bwd_dq_kernel,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    entries = {w: {"max_abs_err": 0.0} for w in TRAIN_KERNELS}

    def bf16(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    # K9a/K9b: path A's layer shape, causal; then right-padded rows at hd 128
    for label, (b, s, h, hd, kv) in (("path A b=2 s=2048 h=16 hd=256", (2, 2048, 16, 256, None)),
                                     ("padded hd=128 kv_len=[1900, 733]",
                                      (2, 2048, 8, 128, [1900, 733]))):
        q, k, v, do = (bf16(b, s, h, hd) for _ in range(4))
        kvl = None if kv is None else torch.tensor(kv, dtype=torch.int32, device=dev)
        kw = dict(scale=hd ** -0.5, causal=True, kv_len=kvl, q_offset=0)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        lse = lse.contiguous()
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        ref = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        errs = {}
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            check(torch.isfinite(a.float()).all().item(), f"K9 {label}: non-finite {name}")
            errs[name] = ((a.float() - r).abs().max() / r.abs().max()).item()
        again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        print(f"[K9] {label}: max|kernel - plain| / max|plain|: "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" (tol {K9_REL_TOL}); "
              f"the same bits on a repeat: {same}")
        check(all(e <= K9_REL_TOL for e in errs.values()), f"K9 {label}: {errs}")
        check(same, f"K9 {label}: a repeat gave other bits")
        del again
        entries["flash_attention_bwd_dkv_kernel"]["max_abs_err"] = max(
            entries["flash_attention_bwd_dkv_kernel"]["max_abs_err"],
            max((a.float() - r).abs().max().item() for a, r in zip(got[1:], ref[1:])))
        entries["flash_attention_bwd_dq_kernel"]["max_abs_err"] = max(
            entries["flash_attention_bwd_dq_kernel"]["max_abs_err"],
            (got[0].float() - ref[0]).abs().max().item())
        if kv is not None:
            continue
        # timing at path A's shape: each kernel with its wrapper, the plain
        # backward (both gradients' function) and the library's backward of
        # scaled_dot_product_attention(is_causal=True), its forward outside
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        kargs = (q, k, v, do, lse, di, None)
        kkw = dict(scale=hd ** -0.5, causal=True, q_offset=0)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=hd ** -0.5)
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_o, (qt, kt, vt), dot, retain_graph=True)

        # this run's work per (batch, head): s (s + 1) / 2 attended pairs,
        # 2 hd flops a product; K9a's function is 4 products (S, dP, dV,
        # dK), K9b's 3 (S, dP, dQ); bytes: every input once, outputs once
        pairs = b * h * s * (s + 1) // 2
        in_bytes = nbytes(q, k, v, do, lse, di)
        plain = lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)  # noqa: E731
        entries["flash_attention_bwd_dkv_kernel"].update(_timing(
            torch, "K9a dK,dV", b * s, lambda: flash_attention_bwd_dkv_kernel(*kargs, **kkw),
            plain, library, in_bytes + 2 * nbytes(k), 4 * 2 * hd * pairs, "flash_bwd_dkv_kernel",
            library_is="backward of scaled_dot_product_attention(is_causal=True), all of dq, "
                       "dk, dv"))
        entries["flash_attention_bwd_dq_kernel"].update(_timing(
            torch, "K9b dQ", b * s, lambda: flash_attention_bwd_dq_kernel(*kargs, **kkw),
            plain, library, in_bytes + nbytes(q), 3 * 2 * hd * pairs, "flash_bwd_dq_kernel",
            library_is="backward of scaled_dot_product_attention(is_causal=True), all of dq, "
                       "dk, dv"))
        del lib_o, qt, kt, vt
        _time_k1_training_shape(torch, F, q, k, v, hd)
    del q, k, v, do, o, lse

    # K10: path B's M = b s = 2048 on every int8 product of a layer and the head
    D, F_, V = 4096, 16384, 50304
    for label, (M, k_, n_) in (("in_proj", (2048, D, 3 * D + F_)), ("o", (2048, D, D)),
                               ("fc_out", (2048, F_, D)), ("head", (2048, D, V)),
                               ("head chunk", (256, D, V))):
        wq = torch.randint(-127, 128, (k_, n_), generator=g, device=dev, dtype=torch.int8)
        sc = torch.rand((n_,), generator=g, device=dev) * 2e-4 + 1e-5
        grad = torch.randn((M, n_), generator=g, device=dev) * 1e-3
        dx = quant.int8_matmul_dx_kernel(grad, wq, sc)
        ref = quant.int8_matmul_dx_plain(grad, wq, sc)
        gs = (grad * sc).to(torch.bfloat16).float()
        tol = 2 * n_ * 2.0 ** -24 * (gs.abs() @ wq.float().abs().T)
        torch.cuda.synchronize()
        err = (dx - ref).abs()
        ok = bool((err <= tol).all()) and torch.equal(dx, quant.int8_matmul_dx_kernel(grad, wq, sc))
        del gs, tol
        w_lib = (wq.float() * sc).to(torch.bfloat16).T.contiguous()  # dequantised before timing
        g16 = grad.to(torch.bfloat16)
        tm = _timing(torch, f"K10 {label}", M, lambda: quant.int8_matmul_dx_kernel(grad, wq, sc),
                     lambda: quant.int8_matmul_dx_plain(grad, wq, sc),
                     lambda: torch.matmul(g16, w_lib),
                     nbytes(grad, wq, sc) + M * k_ * 4, 2 * M * n_ * k_, "int8_dx_wgmma_kernel",
                     library_is="bf16 torch.matmul of g against W s dequantised before timing",
                     plain_iters=5)
        print(f"[K10 {label}] M={M} K={k_} N={n_}: max|kernel-plain| {err.max().item():.3e}, "
              f"within the fp32 summation bound and the same on a repeat: {ok}")
        check(ok, f"K10 {label}: kernel differs from its plain version by {err.max().item()}")
        e = entries["int8_matmul_dx_kernel"]
        e["max_abs_err"] = max(e["max_abs_err"], err.max().item())
        if label == "in_proj":  # the JSON line carries the largest product's numbers
            e.update(tm)
        del wq, sc, grad, dx, ref, w_lib, g16
    for wrapper, (name, replaces, source) in TRAIN_KERNELS.items():
        entries[wrapper].update(name=name, route="cuda", replaces=replaces, source=source)
    return entries


def _time_k1_training_shape(torch, F, q, k, v, hd):
    """K1 at a training layer's shape (phases 8 and 9 run it twice a layer,
    forward and remat recompute): kernel alone, a call, plain, its bound and
    SDPA's causal forward (the library call) on the same inputs."""
    from magma_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain

    b, s, h, _ = q.shape
    kw = dict(scale=hd ** -0.5, causal=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_err = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=kw["scale"])
               .transpose(1, 2).float() - flash_attention_fwd(q, k, v, **kw)[0].float())
    # s (s + 1) / 2 attended pairs a head, a QK^T and a PV product of 2 hd
    # flops each; bytes: q, k, v read, O written, the fp32 lse
    pairs = b * h * s * (s + 1) // 2
    _timing(torch, "K1 training shape", b * s, lambda: flash_attention_fwd(q, k, v, **kw),
            lambda: flash_attention_plain(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=kw["scale"]),
            nbytes(q, k, v, q) + b * h * s * 4, 2 * 2 * hd * pairs, "flash_fwd_kernel",
            library_is="scaled_dot_product_attention(is_causal=True)", plain_iters=5)
    print(f"[K1 training shape] b={b} s={s} h={h} hd={hd} causal: max|SDPA - kernel| "
          f"{lib_err.abs().max().item():.3e}")


def _train_config(path):
    """Path A: configs/MAGMA_v1.yml as it stands, ga 2 x micro 2.  Path B:
    the QLoRA recipe (bench.py stage 6): train_lm_int8, encoder frozen, ga
    2 x micro 1.  Both at seq 2048 with warmup_num_steps 1."""
    from magma_tpu_torch.config import MultimodalConfig

    cfg = MultimodalConfig.from_yml(CONFIG)
    cfg.warmup_num_steps = 1
    cfg.gradient_accumulation_steps = 2
    if path == "A":
        cfg.batch_size = 4
    else:
        cfg.batch_size = 2
        cfg.train_lm_int8 = True
        cfg.freeze_img_encoder = True
        cfg.lr_decay_iters = None  # bench.py's recipe: WarmupLR at lr 8e-4
    return cfg


def _train_batch(torch, cfg, seq, seed):
    """A seeded global batch on the card: images as CLIP's preprocessing
    leaves them (about zero mean), captions of 1024 random tokens then EOS
    padding, as bench.py's recipe step."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b = cfg.batch_size
    images = torch.randn((b, 3, cfg.image_size, cfg.image_size), generator=g, device=dev)
    caps = torch.full((b, seq), 50256, dtype=torch.long, device=dev)
    caps[:, :seq // 2] = torch.randint(0, 50000, (b, seq // 2), generator=g, device=dev)
    return images, caps


def _checksums(torch, tensors):
    """An exact fingerprint of each tensor: the sum of its bits read as
    int32 (or bytes), accumulated in int64."""
    out = []
    for t in tensors:
        t = t.detach().contiguous()
        view = t.view(torch.int32) if t.numel() * t.element_size() % 4 == 0 else t.view(torch.uint8)
        out.append(int(view.sum(dtype=torch.int64)))
    return out


def _want_train_launches(path, L, n_chunks, ga):
    """Exact launches of one optimizer step of ga micro-steps (a forward and
    a backward each, remat on): K1 once a layer forward and once in its
    recompute, K9a and K9b once a layer; path B also K2b for in_proj, o and
    fc_out forward and recompute, K2a for each head chunk forward and
    recompute, K10 for each of those products once."""
    want = {"flash_attention_kernel": 2 * L, "flash_attention_bwd_dkv_kernel": L,
            "flash_attention_bwd_dq_kernel": L}
    if path == "B":
        want.update(int8_matmul_stacked_kernel=6 * L, int8_matmul_kernel=2 * n_chunks,
                    int8_matmul_dx_kernel=3 * L + n_chunks)
    return {k: ga * want.get(k, 0) for k in _all_wrappers()}


def _group_grads(torch, trainer, images, captions, gen_seed):
    """(loss, {group: flat fp32 gradient}) of one micro-batch of the trainer's
    params, train=True, dropout bits from a fixed seed."""
    from magma_tpu_torch.training.optim import label_params
    from magma_tpu_torch.utils import tree_items

    gen = torch.Generator(device=images.device).manual_seed(gen_seed)
    named = trainer.trainable
    loss, _ = trainer.model.loss_fn(trainer.params, trainer.state, images, captions, train=True,
                                    generator=gen)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    labels = dict(tree_items(label_params(trainer.params)))
    groups = {}
    for (path, _), gr in zip(named, grads):
        groups.setdefault(labels[path], []).append(gr.float().reshape(-1))
    return loss.item(), {k: torch.cat(v) for k, v in groups.items()}


class _PlainInt8:
    """Within the block, the int8 products' wrappers run their plain
    versions on the card: K2a, K2b and K10 swapped for the same functions in
    fp32 torch (the plain path of path B)."""

    def __enter__(self):
        from magma_tpu_torch.ops import quant

        self.quant = quant
        self.saved = {n: getattr(quant, n) for n in
                      ("int8_matmul_kernel", "int8_matmul_stacked_kernel", "int8_matmul_dx_kernel")}
        quant.int8_matmul_kernel = lambda x2, wq, s: quant._dq_product(x2, wq, s)
        quant.int8_matmul_stacked_kernel = (
            lambda x2, wq, s, i: quant.int8_matmul_stacked_plain(x2, wq, s, i))
        quant.int8_matmul_dx_kernel = quant.int8_matmul_dx_plain
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.quant, n, fn)


def _compare_with_plain_path(torch, trainer, path, images, captions):
    """One micro-batch's loss and gradients by parameter group, through the
    kernels and through the plain path."""
    model, cfg0 = trainer.model, trainer.model.lm_config
    micro = images.shape[0] // trainer.config.gradient_accumulation_steps
    img, cap = images[:micro], captions[:micro]
    loss_k, g_k = _group_grads(torch, trainer, img, cap, 7)
    model.lm_config = dataclasses.replace(cfg0, attention_impl="xla")
    try:
        if path == "B":
            with _PlainInt8():
                loss_p, g_p = _group_grads(torch, trainer, img, cap, 7)
        else:
            loss_p, g_p = _group_grads(torch, trainer, img, cap, 7)
    finally:
        model.lm_config = cfg0
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    rel = {k: ((g_k[k] - g_p[k]).norm() / g_p[k].norm()).item() for k in g_p}
    print(f"[path {path}] one micro-batch through the kernels vs the plain path: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel_loss:.3e}, tol {TRAIN_LOSS_TOL}); gradient "
          f"|g - g_plain| / |g_plain| by group: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rel.items()))
          + f" (tol {TRAIN_GRAD_TOL})")
    check(rel_loss <= TRAIN_LOSS_TOL, f"path {path}: loss differs from the plain path's")
    check(all(v <= TRAIN_GRAD_TOL for v in rel.values()),
          f"path {path}: gradients differ from the plain path's: {rel}")


def _profile_train_step(torch, trainer, batch, wall_ms, tag):
    """Device busy ms, kernel count and idle share (1 - busy / wall, wall the
    median unprofiled step) of one train step, from torch.profiler.  A
    trace now and then comes back with about half the step's kernels whose
    times sum to more than the traced step itself: such a trace is taken
    again once, then reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_step(*batch)
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
        kernels = _kernel_events(torch, prof)
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        if kernels and busy <= traced_ms:
            break
    else:
        print(f"[{tag}] one train step: device time not measured (no profiler trace whose "
              f"kernels fit in its step)")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    print(f"[{tag}] one train step: device busy {busy:.2f} ms in {len(kernels)} kernels, "
          f"wall {wall_ms:.2f} ms (median unprofiled step), idle share {1 - busy / wall_ms:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   {ms:.3f} ms  {name[:90]}")
    attention = {match: sum(ms for name, ms in by_name.items() if match in name)
                 for match in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    print(f"[{tag}]   attention kernels in the step: "
          + ", ".join(f"{match} {ms:.3f} ms" for match, ms in attention.items()))


def _time_optimizer(torch, trainer, batch, wall_ms, tag):
    """Wall ms of the optimizer's update within one train step, the card
    synchronised before and after it, against the median unprofiled step."""
    opt = trainer.optimizer
    spans = []

    def timed(grads):
        torch.cuda.synchronize()
        t = time.perf_counter()
        applied = type(opt).step(opt, grads)
        torch.cuda.synchronize()
        spans.append((time.perf_counter() - t) * 1e3)
        return applied

    opt.step = timed
    try:
        trainer.train_step(*batch)
    finally:
        del opt.step
    print(f"[{tag}] optimizer update: {spans[0]:.2f} ms wall over {len(opt.params)} tensors "
          f"(card synchronised before and after), {spans[0] / wall_ms:.3f} of the median step")


def phase_training(torch, path):
    """Phase 8 (path A) or 9 (path B): the Trainer at full width.  Returns
    the launches of its TRAIN_STEPS steps by wrapper."""
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.training.optim import label_params
    from magma_tpu_torch.training.train_loop import Trainer
    from magma_tpu_torch.utils import tree_items

    tag = f"path {path}"
    cfg = _train_config(path)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = Magma(cfg, seed=0, device=dev)
    trainer = Trainer(model, cfg)
    torch.cuda.synchronize()
    lm = model.lm_config
    L, seq, ga = lm.n_layers, model.seq_len, cfg.gradient_accumulation_steps
    n_chunks = -(-(seq - 1) // 256)
    micro = cfg.batch_size // ga
    frozen = [t for _, t in tree_items(trainer.params) if not t.requires_grad]
    n_trainable = sum(t.numel() for _, t in trainer.trainable)
    print(f"[{tag}] Magma({CONFIG.name}) + Trainer in {time.perf_counter() - t0:.1f} s: "
          f"{'int8 QLoRA layout' if cfg.train_lm_int8 else 'bf16 LM'}, "
          f"{nbytes(*frozen) / 1e9:.2f} GB frozen, {n_trainable / 1e6:.1f} M trainable, seq {seq}, "
          f"ga {ga} x micro {micro}, lr {cfg.lr}, image_enc_lr {cfg.image_enc_lr}, dropout "
          f"{cfg.image_embed_dropout_prob}, attention {lm.attention_impl}, remat {lm.remat}")
    check(lm.remat and lm.attention_impl == "flash" and seq == 2048, f"{tag}: not the recipe")
    frozen_sums = _checksums(torch, frozen)
    labels = dict(tree_items(label_params(trainer.params)))
    before = {}
    for p, t in trainer.trainable:
        before.setdefault(labels[p], []).append(t.detach().clone())

    wrappers = _all_wrappers()
    want = _want_train_launches(path, L, n_chunks, ga)
    totals = dict.fromkeys(wrappers, 0)
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        batch = _train_batch(torch, cfg, seq, 100 + step)
        for fn in wrappers.values():
            fn.launches = 0  # count this step only
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = trainer.train_step(*batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        got = {k: fn.launches for k, fn in wrappers.items()}
        for k in totals:
            totals[k] += got[k]
        losses.append(loss)
        print(f"[{tag}] step {step + 1}: loss {loss:.6f}, {times[-1]:.1f} ms, launches "
              + ", ".join(f"{k} {v}" for k, v in got.items() if v))
        check(np.isfinite(loss), f"{tag}: non-finite loss at step {step + 1}")
        check(got == want, f"{tag} step {step + 1}: launches {got}, expected {want}")
    step_ms = statistics.median(times[1:])
    print(f"[{tag}] step {step_ms:.1f} ms (CUDA events, median of steps 2-{TRAIN_STEPS}), "
          f"{cfg.batch_size * seq / step_ms * 1e3:.0f} tokens/s ({cfg.batch_size} x {seq} "
          f"tokens a step), peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    same = _checksums(torch, frozen) == frozen_sums
    print(f"[{tag}] frozen LM bit-unchanged ({len(frozen)} leaves, checksums): {same}")
    check(same, f"{tag}: a frozen leaf changed")
    moved = {}
    for p, t in trainer.trainable:
        moved.setdefault(labels[p], []).append(t.detach())
    moved = {k: any(not torch.equal(a, b) for a, b in zip(before[k], v)) for k, v in moved.items()}
    print(f"[{tag}] trainable groups moved: {moved}")
    check(all(moved.values()), f"{tag}: a trainable group did not move: {moved}")
    del before

    _compare_with_plain_path(torch, trainer, path, *_train_batch(torch, cfg, seq, 200))
    if path == "B":
        batch = _train_batch(torch, cfg, seq, 300)
        gate = [trainer.train_step(*batch) for _ in range(10)]
        print(f"[{tag}] overfit gate, 10 steps on one batch: losses "
              + " ".join(f"{x:.4f}" for x in gate)
              + f"; step 10 {gate[-1]:.4f} < step 1 {gate[0]:.4f} - {OVERFIT_MARGIN}: "
              f"{gate[-1] < gate[0] - OVERFIT_MARGIN}")
        check(gate[-1] < gate[0] - OVERFIT_MARGIN, f"{tag}: the overfit gate failed: {gate}")
    _profile_train_step(torch, trainer, _train_batch(torch, cfg, seq, 400), step_ms, tag)
    _time_optimizer(torch, trainer, _train_batch(torch, cfg, seq, 500), step_ms, tag)
    del trainer, model, frozen
    gc.collect()
    torch.cuda.empty_cache()
    return totals


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
    decode_entries = phase_decode_layer_kernels(torch)
    train_entries = phase_train_kernels(torch)
    model, emb, greedy_tokens, bf16_launches = phase_slice(torch)
    check(bf16_launches > 0, "the bf16 path launched no K1 kernel")
    phase_kernel_vs_plain_path(torch, model, emb, greedy_tokens)
    paths = {"int8": phase_quantized(torch, model, 8)}
    paths["int8 agreement"] = phase_decode_agreement(torch, model, *paths["int8"][1:], "int8")
    paths["int8"] = paths["int8"][0]
    del model, emb, greedy_tokens  # free the int8 model before the int4 one
    gc.collect()
    torch.cuda.empty_cache()
    model, launches4, emb4, tokens4 = phase_int4(torch)
    paths["int4"] = launches4
    paths["int4 agreement"] = phase_decode_agreement(torch, model, emb4, tokens4, "int4")
    paths["int4+kv8"] = phase_int4_kv8(torch, model, emb4, tokens4)
    del model, emb4, tokens4  # free the int4 model before training
    gc.collect()
    torch.cuda.empty_cache()
    paths["train A"] = phase_training(torch, "A")
    paths["train B"] = phase_training(torch, "B")

    launches = {k: sum(p[k] for p in paths.values()) for k in _all_wrappers()}
    launches["flash_attention_kernel"] += bf16_launches
    for wrapper, n in launches.items():
        check(n > 0, f"no path launched {wrapper}")
    k1["launches"] = launches["flash_attention_kernel"]
    entries = {**int8_entries, **int4_entries, **decode_entries, **train_entries}
    kernels = [k1] + [dict(entries[w], launches=launches[w])
                      for w in (*INT8_KERNELS, *INT4_KERNELS, *DECODE_KERNELS, *TRAIN_KERNELS)]
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
