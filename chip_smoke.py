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
   inputs at the caption prefill's shapes, which its mma.sync body takes,
   and at the training layers' (b 2 or 1, s 2048, 16 heads of 256; kv_len
   [2048, 1000], a fully masked row, q_offset 128 with s_q 1920, and path
   B's v as a view of the fused in_proj output), which its wgmma body
   takes: each case on the body the rule names and the same bits on a
   repeat; at the prefill's shape kernel, plain version and one
   ``scaled_dot_product_attention`` call with the same boolean mask timed
   (median of CUDA events).
2b. The int8 kernels against their plain versions on seeded bf16/int8
   inputs at the slice's shapes: K2b (in_proj) at M = 1, 5, 37, 192, 256,
   2048, on the QLoRA layout's o and fc_out at M = 2048 and on the int8
   adapter mode's products (v2's 4096 -> 512 -> 4096, v1's 4096 -> 1024 ->
   4096) at M = 1, 192, K4a (o_proj + fc_out) at M = 1, 192, K5 (the
   adapter) at M = 1, 8, 16 (the serving engine's pools), 64 (the same bits
   on a repeat) over v1's hidden 1024 and at M = 1, 8, 64 over v2's 512,
   K2a (the head) at M = 1 and at path B's 256-position loss chunk; each
   timed with its plain version and a bf16 ``torch.matmul`` over weights
   dequantised outside the timed call, and every M > 8 result the same
   bits on a repeat.
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
   dequantised outside the timed call (K6: the same ops as a chain); K6's
   per-phase breakdown at M = 1 and 8 (v1, with the next in_proj: its
   stamped build's %globaltimer stamps, as K8's in phase 2d), the stamped
   launch holding K6's bits.
2d. K7 and K8 (whole decode layers, ``ops/decode_layer.py``) against their
   plain versions at full width, on seeded int4 and int8 28-layer stacks
   built on the card, over a bf16 and an int8 cache of 256 positions filled
   to pos = 180, for the v1 adapter and for an attention adapter
   (scaled_parallel) beside the mlp one with o_bias: K7 at layer 13 with
   the next in_proj and at layer 27 without, K8 over all 28 layers, and K8
   at pos = 0 (the token alone).  Each case timed with its plain version,
   its bound and the same ops as a chain of bf16 PyTorch calls over
   weights dequantised before timing; then 28 K7 launches against one K8
   launch for the same step, the per-phase breakdown of K8 (int4 and int8,
   bf16 cache, v1, pos 180: its stamped build's %globaltimer stamps, each
   phase's slowest block against the barrier before it, summed over the 28
   layers), and the time of one grid barrier of K8's grid alone.
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
5c. Split generate (int8): ``Magma.generate`` on 8 prompts of eight images
   and the text (1,174 tokens padded to 1,216: b·s above 8192) takes
   ``generate_tokens_split`` (a spy on it says so), prefilling in chunks of
   512 through history attention, with exact launches; its first-step
   logits are held against the whole-prompt prefill's at the same shape
   (phase 4's bound: the chunks' attention is the einsum path, the whole
   prompt's K1), the greedy tokens of both paths compared and both paths'
   peak device memory printed.  Its two whole-prompt b = 8 prefills run
   K1's wgmma body (>= 132 blocks), the only serving prefills that do.
5d. The serving engine (int8, bf16 cache): ``MagmaServingEngine`` with
   pools ((8, 2048), (16, 512)), windows of 8 and chunks of 512 serves 20
   single-image captions and 3 eight-image prompts (3 chunks each), 32
   new tokens each, greedy, top_k = 1 and sampled rows mixed (embedded once,
   then submitted together): pipelined
   (the main path) with exact launches from the prefills, chunks, installs
   and windows it ran (K5 in both pools), every step's dispatch under
   ``set_sync_debug_mode("error")`` up to the collect, every request ended
   by EOS or its budget; output tokens/s, time to first token, ms a decode
   step by pool, resident cache positions and peak memory printed; then
   unpipelined, whose greedy and top_k = 1 tokens must equal the pipelined
   ones, with one 16-row and one 8-row step replayed through the kernels
   and through its kernels' plain versions (logits within 3e-2, argmax
   equal, as phase 5b) and one window of each pool profiled (idle share);
   the deterministic captions' first tokens equal ``Magma.generate``'s,
   and a (1, 256) pool (K8) gives ``Magma.generate``'s tokens for a
   request through ``submit_prompt`` and ``text_results``.  No 1-row
   prefill runs K1's wgmma body.
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
7b. The serving engine (int4, int8 cache), as 5d: K6 in the 8-slot pool,
   K3, K4b and K5 in the 16-slot one.
2e. The training kernels against their plain versions: K9a/K9b (the flash
   backward) at (b 2, s 2048, h 16, hd 256, causal) and at a padded
   kv_len case of hd 128, each gradient within 2e-2 of its largest
   magnitude and the same bits on a repeat; K1 (its wgmma body) timed at
   path A's and path B's training shapes beside SDPA's causal forward;
   K10 (the int8 input gradient) at
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
   (K1 2L, all on its wgmma body, K9a L, K9b L a micro-step), finite
   losses, the frozen LM
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
10. The other towers: configs/MAGMA_v1.yml with ``encoder_name`` "clip"
   (the ViT-B/32 at 224 px, 12 x 768, 12 heads) and then "nfresnet50"
   ((3, 4, 6, 3), the random crop at v1's 384 px, seeded before each
   request), GPT-J 6B at full width, ``quantize_for_serving(8)`` (the
   NF-ResNet model shares the ViT model's int8 LM and folds its own tower):
   each tower's pooled prefix in fp32 on the card against the same weights
   on the CPU, then phase 5's three requests with exact launches (the
   24-position prompt, 2 prefix and 22 text positions, pads to 64 rows, so
   K5 runs once a layer in the prefill),
   each request's prefill logits against every kernel's plain version, and
   vision+prefix ms.
11. The train CLI: 24 seeded JPEGs of mixed sizes and 6 VQA questions
   written under build/smoke_cli, then ``magma_tpu_torch.train.main`` in
   process on a yml that is v1 at full width and seq 2048 cut to 4 steps
   of batch 4 (ga 2), eval every 2 steps (eval loss, captions with their
   image grid, VQA accuracy), no checkpoint: exact launches of every
   train step (K1 2L, all on its wgmma body, K9a L, K9b L a micro-step),
   eval forward, caption prefill and VQA prefill (K1 L each), finite
   losses, the step's host-clock ms and loader wait, the decoder (native
   or PIL, with the native build's error); then one more step of the CLI's
   trainer profiled (device busy, idle share against the CLI's step wall).
   Then a second run on v2's yml shape: configs/MAGMA_v2.yml's adapters at
   full width and seq 2048, ``train_dataset_dir`` a list of two
   directories (24 and 12 JPEGs) with ``eval_dataset_dir: null`` (the
   seeded held-out split), a ``vqa_dir`` and a ``gqa_dir``, 4 steps of
   batch 4 at ga 4, eval every 2: the same launch checks and finite
   losses, VQA and GQA accuracy each logged twice.
12. The classifier: ``MagmaClassifier`` from v1 with a 2-class head at full
   width, two ``train_step_classification`` steps (ga 2 x 1) on batches of
   two images a sample and one ``eval_step_classification``, with exact
   launches (K1 all on its wgmma body), then one micro-batch's logits and
   loss through the kernels against the plain path.
13. Parallelism over ``torch.distributed`` (``magma_tpu_torch/parallel``),
   at full width, each path in worker processes (``torch.multiprocessing``,
   a free port on 127.0.0.1; a rank's failure ends the run): first the
   one-process references in this process, then which collectives two
   ranks on the one card carry (NCCL, then gloo on CUDA tensors, each
   checked), then (a) tp, phase 5's three requests through
   ``Magma.generate`` over the tensor-parallel int8 layout, each rank
   building only its shards layer by layer from the seed; (b) sp, greedy
   generate over the eight-image prompt with the cache's positions
   sharded; (c) dp, two path A steps (v1's bf16 tower, no dropout), each
   rank fed its share of the global batch; at two ranks on gloo where it
   carries their collectives; (d) a path A step with ring attention at
   world 1 on NCCL (``init_distributed``) where two ranks do not carry
   send/recv (so no collective of the ring runs there).  Exact launches on
   every rank; (a) and (b) hold their teacher-forced logits within phase
   5's int8 tolerance of one process's and every greedy choice equal where
   the logits do not tie; (c) the losses, the first step's global gradient
   (phase 9's tolerance) and the updated trainables (98% of each group's
   elements within 0.05 lr) against one process computing the ranks'
   arithmetic (``_loss_in_shares``), with the distance of that arithmetic
   from the whole batch's printed beside; (d) its loss and gradients
   against the flash path; the ranks' replicas equal.
14. MAGMA_v2 and the last modules: ``Magma`` from configs/MAGMA_v2.yml
   (GPT-J 6B with normal mlp and attention adapters, both at k=8: hidden
   512; RN50x16 at 384 px), bf16 weights from a seed on the card, the
   adapters moved off their near-zero init so that every bound below can
   see them: (a) phase 3's three requests, K1 once a layer a prefill; (b)
   ``save_checkpoint`` of the bf16 params and state under build/, then
   ``Magma.from_checkpoint`` of that directory: every tensor bit-equal
   (checksums on the card), the greedy tokens equal to (a)'s, bytes and
   seconds printed, the directory deleted; (c) ``quantize_for_serving(8)``
   and the three requests with exact launches (a decode step: layer 0's
   in_proj on K2b, one K8, whose attention adapter is fed from its
   branch's output, the head on K2a), the prefill logits against the bf16
   path over the dequantised packs, and phase 5b's decode-step agreement
   (K5 twice a layer in the chain), with its controls: K8 with an adapter
   zeroed or the attention adapter fed from "in" must fail it, and the
   prefill reference without an adapter must move past the logit bound;
   (d) a fresh model, the int8 adapter mode
   (``quantize_lm_params(fuse_out_proj=False)``, then
   ``_serving_cast_adapters(mode="int8")``) and the three requests with
   exact launches (7 K2b products a layer a forward, the adapters' four
   among them, the head on K2a; no K5, K6 or K8), its prefill logits
   against its dequantised bf16 path, a decode step profiled.
15. Training in the recipes that had only served on the card, each as
   phase 8 (``phase_training``: 3 steps at full width and seq 2048, exact
   launches, finite losses, the frozen LM's checksums, every group moved,
   the tower's at image_enc_lr 2e-6, one micro-batch's gradients per group
   against the plain path at phase 8's tolerances, step ms, tokens/s, peak
   memory, a profiled step), each model freed before the next: path C,
   configs/MAGMA_v2.yml as it stands (mlp and attention adapters at k=8,
   bf16 LM, RN50x16 trainable at 384 px), ga 4 x micro 1; path D, v1 with
   the ViT-B/32 (224 px, pooled prefix), trainable, ga 2 x micro 2; path
   E, v1 with the NF-ResNet50 (random crop at 384 px), trainable, over the
   int8 QLoRA LM (K2b, K2a, K10 as path B, the plain path swapping them
   too), ga 2 x micro 1.
Each of phases 10-15 prints its time; ``--only 10,11,15`` (any of 10-15)
runs just those after the build (a partial run, without the last two
lines).

No b = 1 serving prefill of phases 3-7 may run K1's wgmma body: on it
phase 6b's int8-cache agreement fails; phase 5c's b = 8 whole-prompt
prefills run it by the rule and are counted apart.  The last two
lines are one JSON object of the kernels' numbers (K1's entry also with
its wgmma body's numbers at both training shapes, train_a_* and
train_b_*) and one JSON object saying the run is ok and on which device.
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
CONFIG_V2 = ROOT / "configs" / "MAGMA_v2.yml"
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


def _k1_case(torch, rng, dev, hd, b, s_q, s_k, kv_len, strided_v):
    """Seeded bf16 q, k, v of 16 heads; v, if ``strided_v``, a view of a
    fused [q | k | v | fc_in] buffer as path B's in_proj output hands it."""
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, 16, hd), dtype=np.float32))
               .to(dev, torch.bfloat16) for s in (s_q, s_k, s_k))
    if strided_v:
        d = 16 * hd
        fused = torch.zeros((b, s_k, 7 * d), dtype=torch.bfloat16, device=dev)
        fused[..., 2 * d:3 * d] = v.reshape(b, s_k, d)
        v = fused[..., 2 * d:3 * d].reshape(b, s_k, 16, hd)
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return q, k, v, kvl


def phase_kernel(torch):
    """K1 vs its plain version, at the prefill's shapes (the mma.sync body)
    and at the training layers' (the wgmma body).  Returns its JSON entry
    (launches unset)."""
    import torch.nn.functional as F

    from magma_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_kernel,
                                                     flash_attention_plain)

    dev = torch.device("cuda")
    hd = 256
    # (name, b, s_q, s_k, kv_len, q_offset, strided v, wgmma body)
    cases = [
        ("slice prefill b=1 kv_len=[149]", 1, 256, 256, [149], 0, False, False),
        ("b=2 kv_len=[149, 0] (row 1 fully masked)", 2, 256, 256, [149, 0], 0, False, False),
        ("q_offset=128 s_q=128 s_k=256", 1, 128, 256, None, 128, False, False),
        ("path A b=2 s=2048 causal", 2, 2048, 2048, None, 0, False, True),
        ("path A kv_len=[2048, 1000]", 2, 2048, 2048, [2048, 1000], 0, False, True),
        ("path A kv_len=[2048, 0] (row 1 fully masked)", 2, 2048, 2048, [2048, 0], 0, False,
         True),
        ("b=2 q_offset=128 s_q=1920 s_k=2048", 2, 1920, 2048, None, 128, False, True),
        ("path B b=1 s=2048, v a view of the fused in_proj output", 1, 2048, 2048, None, 0,
         True, True),
    ]
    rng = np.random.default_rng(0)
    worst = 0.0
    timed = None
    for name, b, s_q, s_k, kv_len, q_offset, strided_v, wgmma in cases:
        q, k, v, kvl = _k1_case(torch, rng, dev, hd, b, s_q, s_k, kv_len, strided_v)
        kw = dict(scale=hd ** -0.5, causal=True, kv_len=kvl, q_offset=q_offset)
        before = flash_attention_kernel.wgmma_launches
        o, lse = flash_attention_fwd(q, k, v, **kw)
        took = flash_attention_kernel.wgmma_launches - before
        ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
        again = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        del again
        err = (o.float() - ref_o.float()).abs()
        o_err = err.max().item()
        o_ok = bool((err <= O_ATOL + O_RTOL * ref_o.float().abs()).all())
        valid = (torch.ones((b,), dtype=torch.bool, device=dev) if kvl is None else kvl > 0)
        lse_err = (lse - ref_lse)[valid].abs().max().item()
        print(f"[K1] {name}: {'wgmma' if took else 'mma.sync'} body, max|O-plain| "
              f"{o_err:.3e} (tol {O_ATOL} + 2^-7 |O|), max|lse-plain| {lse_err:.3e} "
              f"(tol {LSE_TOL}), the same bits on a repeat: {same}")
        check(took == int(wgmma), f"K1 {name}: ran the {'wgmma' if took else 'mma.sync'} body")
        check(torch.isfinite(o.float()).all().item(), f"K1 {name}: non-finite O")
        check(o_ok, f"K1 {name}: O error {o_err} beyond {O_ATOL} + {O_RTOL} |O|")
        check(lse_err <= LSE_TOL, f"K1 {name}: lse error {lse_err} > {LSE_TOL}")
        check(same, f"K1 {name}: a repeat gave other bits")
        if kvl is not None and not valid.all():
            masked_o = o[~valid].float().abs().max().item()
            print(f"[K1]   fully masked row: max|O| {masked_o}, lse equal to plain: "
                  f"{torch.equal(lse[~valid], ref_lse[~valid])}")
            check(masked_o == 0.0, "K1: a fully masked row must output 0")
            check(torch.equal(lse[~valid], ref_lse[~valid]), "K1: masked-row lse differs")
        worst = max(worst, o_err)
        if timed is None:
            timed = (q, k, v, kw, kv_len[0])
        del q, k, v, o, lse, ref_o, ref_lse
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
            "wgmma_source": "magma_tpu_torch/csrc/flash_attn_fwd_wgmma.cu",
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

    # K2b on the int8 adapter mode's products (the adapters' down and up of
    # v2, hidden 512, and of v1, hidden 1024), 28 layers (59 or 117 MB) cycled
    L = 28
    for label, (k_, n_) in (("v2 adapter down", (D, 512)), ("v2 adapter up", (512, D)),
                            ("v1 adapter down", (D, DH)), ("v1 adapter up", (DH, D))):
        wq, s = int8(L, k_, n_), scales(L, n_)
        w_lib = [deq(wq[i], s[i]) for i in range(L)]
        for m in (1, 192):
            x = bf16(m, k_)
            out = quant.int8_matmul_stacked(x, wq, s, 1)
            ref = quant.int8_matmul_stacked_plain(x, wq, s, 1)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            check(torch.equal(out, quant.int8_matmul_stacked(x, wq, s, 1)),
                  f"K2b {label} M={m}: another result on a repeat")
            it = itertools.cycle(range(L))
            timing(f"K2b {label}", m, lambda: quant.int8_matmul_stacked(x, wq, s, next(it)),
                   lambda: quant.int8_matmul_stacked_plain(x, wq, s, next(it)),
                   lambda: torch.matmul(x, w_lib[next(it)]),
                   nbytes(x, wq[0], s[0]) + m * n_ * 4, 2 * m * k_ * n_,
                   "gemv_kernel" if m <= 8 else "int8_wgmma_tile_kernel")
            report("int8_matmul_stacked_kernel", f"K2b {label}", m, err.max().item(),
                   bool((err <= _sum_tol(x, wq[1], s[1], k_)).all()))
        del wq, s, w_lib

    # K5: the v1 adapter (D=4096, DH=1024) and v2's (DH=512) of all 28
    # layers (235 or 117 MB) cycled
    for dh, rows in ((DH, (1, 8, 16, 64)), (512, (1, 8, 64))):
        fz = {"wd": int8(L, D, dh), "sd": scales(L, 1, dh), "bd": scales(L, 1, dh) * 100,
              "wu": int8(L, dh, D), "su": scales(L, 1, D), "bu": scales(L, 1, D) * 100}
        lib_d = [deq(fz["wd"][i], fz["sd"][i, 0]) for i in range(L)]
        lib_u = [deq(fz["wu"][i], fz["su"][i, 0]) for i in range(L)]
        lib_b = [(fz["bd"][i, 0].to(torch.bfloat16), fz["bu"][i, 0].to(torch.bfloat16))
                 for i in range(L)]
        # decode; the engine's 8- and 16-slot pools; the top of K5
        for m in rows:
            x = bf16(m, D)
            out = quant.fused_adapter_stacked(x, fz, 5)
            ref = quant.fused_adapter_stacked_plain(x, fz, 5)
            torch.cuda.synchronize()
            # h is rounded to bf16 in both: an h on a rounding boundary can
            # land one bf16 ulp (2^-8 relative) apart and move out by
            # 2^-8 |h| |Wu| su
            hh = torch.relu(quant.int8_matmul_plain(x, fz["wd"][5], fz["sd"][5, 0])
                            + fz["bd"][5, 0])
            up = (hh.abs() @ fz["wu"][5].float().abs()) * fz["su"][5, 0]
            err = (out - ref).abs()
            ok = bool((err <= 2.0 ** -8 * up + _sum_tol(hh, fz["wu"][5], fz["su"][5, 0], dh)
                       + 1e-6).all())
            it = itertools.cycle(range(L))

            def library():
                i = next(it)
                return torch.relu(x @ lib_d[i] + lib_b[i][0]) @ lib_u[i] + lib_b[i][1]

            label = "K5 adapter" if dh == DH else f"K5 adapter DH={dh}"
            tm = timing(label, m, lambda: quant.fused_adapter_stacked(x, fz, next(it)),
                        lambda: quant.fused_adapter_stacked_plain(x, fz, next(it)), library,
                        nbytes(x, fz["wd"][0], fz["wu"][0]) + 4 * (2 * dh + 2 * D) + m * D * 4,
                        2 * m * 2 * D * dh, "fused_adapter_kernel")
            check(torch.equal(out, quant.fused_adapter_stacked(x, fz, 5)),
                  f"{label} M={m}: another result on a repeat")
            # the JSON line carries the main path's case: the engine's 8-row
            # pool over v1's adapter
            report("fused_adapter_kernel", label, m, err.max().item(), ok,
                   tm if (m, dh) == (8, DH) else None)
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
                # the JSON line carries the main path's case: the engine's
                # 8-row pool, v1, w_in
                main = m == 8 and with_in and "v1" in name
                report("boundary_kernel", f"K6 boundary, {name}, w_in {with_in}", m,
                       max(errs), ok, tm if main else None)
                if with_in and "v1" in name:
                    _k6_phase_breakdown(torch, quant, args, ckw, m, got)
    for wrapper, (name, replaces, source) in INT4_KERNELS.items():
        entries[wrapper].update(name=name, route="cuda", replaces=replaces, source=source)
    return entries


def _k6_phase_breakdown(torch, quant, args, kw, m, got):
    """Where K6's time goes: its stamped build (``quant.boundary_stamped``;
    never on the main path) writes each block's %globaltimer at the start
    and the end of each phase.  Per phase the slowest block's end minus the
    first block's start, and the wait after it (a grid barrier, or the
    arrivals and the counters before owned sums); the median of 5 launches
    after a warm one.  The stamped launch must give K6's bits."""
    runs = []
    for i in range(6):
        *outs, stamps = quant.boundary_stamped(*args, **kw)
        torch.cuda.synchronize()
        if i == 0:
            check(all(torch.equal(a, b) for a, b in zip(outs, got)),
                  f"K6 M={m}: the stamped build differs from K6")
        else:
            runs.append(quant.phase_breakdown(stamps))
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print(f"[K6 boundary, v1, w_in] M={m} phase breakdown (ms, globaltimer stamps, median of "
          f"5; the phase: slowest block's end - first block's start; then the wait): "
          + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))


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
                   library, nbytes(*reads) + n_vec * D * 4 + n_out, ops, "boundary_stream_kernel",
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
                                n_bytes, ops, "decode_stream_kernel", ops_per_s=ops_rate,
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
                                 n_bytes, ops, "decode_stream_kernel", ops_per_s=ops_rate,
                                 library_is="the same ops as a chain of bf16 PyTorch calls",
                                 plain_iters=2)
                    main = fmt == "int4" and kv == "bf16" and recipe == "v1" and pos == POS
                    report("decode_all_layers_kernel", label, {**errs, "k0": e0["k_new"]},
                           ok and ok0,
                           dict(tm, library_ms=None, chain_ms=tm["library_ms"]) if main else None)
                    if main or (fmt == "int8" and kv == "bf16" and recipe == "v1" and pos == POS):
                        _k7_chain_vs_k8(torch, dl, args, kw, L, label)
                        _k8_phase_breakdown(torch, dl, args, kw, label, got)
        del dual, w_in, ad1, ad2, vecs, lib, lib_v1, recipes
        gc.collect()
        torch.cuda.empty_cache()
    _grid_barrier_cost(torch, L)
    for wrapper, (name, replaces, source) in DECODE_KERNELS.items():
        entries[wrapper].update(name=name, route="cuda", replaces=replaces, source=source)
    return entries


def _grid_barrier_cost(torch, L):
    """What K8's grid barriers cost alone: cooperative launches of K8's grid
    that cross n barriers of K8's kind and do nothing else
    (``magma_grid_sync_probe``), timed by CUDA events; the slope over n is
    the cost of one barrier."""
    import ctypes

    from magma_tpu_torch.cuda_build import load_library
    from magma_tpu_torch.ops import decode_layer as dl

    probe = load_library().magma_grid_sync_probe
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    bar = torch.zeros(1, dtype=torch.int32, device="cuda")
    per_step = dl.stream_barriers(L, adapters=True)  # K8's barriers in a v1 L-layer step

    def run(n):
        err = probe(n, bar.data_ptr(), stream)
        check(err == 0, f"grid barrier probe failed: cudaError {err}")

    ms = {n: cuda_ms(lambda n=n: run(n), iters=20) for n in (0, per_step, 10 * per_step)}
    us = (ms[10 * per_step] - ms[0]) / (10 * per_step) * 1e3
    print(f"[K8 barriers] one grid barrier of K8's grid alone: {us:.3f} us (CUDA events, median "
          f"of 20; launches of 0, {per_step} and {10 * per_step} barriers: "
          + ", ".join(f"{v:.4f} ms" for v in ms.values())
          + f"); {per_step} a {L}-layer step: {per_step * us / 1e3:.4f} ms")


def _k8_phase_breakdown(torch, dl, args, kw, label, got):
    """Where K8's time goes: its stamped build (``magma_decode_layers`` with
    a stamps buffer; never on the main path) writes each block's
    %globaltimer at the start and the end of every phase of every layer.
    Per phase, summed over the layers: the slowest block's end minus the
    barrier's release (the first block's start), and the barrier after it;
    the median of 5 launches after a warm one.  The stamped launch must give
    K8's bits."""
    runs = []
    for i in range(6):
        *outs, stamps = dl.decode_all_layers_stamped(*args, **kw)
        torch.cuda.synchronize()
        if i == 0:
            check(all(torch.equal(a, b) for a, b in zip(outs, got)),
                  f"{label}: the stamped build differs from K8")
        else:
            runs.append(dl.phase_breakdown(stamps))
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print(f"[{label}] phase breakdown (ms over {args[4].shape[0]} layers, globaltimer stamps, "
          f"median of 5; the phase: slowest block's end - barrier release; then the barrier): "
          + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))


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


def _image(seed=1):
    from PIL import Image

    pixels = np.random.default_rng(seed).integers(0, 256, (480, 640, 3), dtype=np.uint8)
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


def _prefill_last_logits(torch, cfg, lm_params, emb, mesh=None):
    """fp32 logits at the last true position of a padded prefill (over
    ``mesh``: this rank's shards, the logits gathered)."""
    from magma_tpu_torch.models import gptj

    pad = (-emb.shape[1]) % 64
    padded = torch.nn.functional.pad(emb, (0, 0, 0, pad))
    s = emb.shape[1]
    kv_len = torch.full((1,), s, dtype=torch.int32, device=emb.device)
    cache = gptj.init_kv_cache(cfg, 1, padded.shape[1] + 64, device=emb.device, mesh=mesh)
    hidden, _ = gptj.forward(cfg, lm_params, padded, cache=cache, cache_index=0,
                             kv_len=kv_len, return_hidden=True, mesh=mesh)
    return gptj.lm_head(cfg, lm_params, hidden[:, s - 1:s], mesh)[0, 0]


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
    fp32; embeddings keep ``wte``.  The packs are the serving layout's
    (fused in_proj and out_proj, fused adapters) or the int8 adapter
    mode's (o and fc_out apart, each adapter's kernels a pack)."""
    from magma_tpu_torch.ops.quant import dequantize_int4

    D = cfg.d_model
    blocks = lm["blocks"]

    def deq(w, s):  # (L, K, N) int8, (L, N) -> bf16, one layer at a time
        return torch.stack([(w[i].float() * s[i]).to(torch.bfloat16) for i in range(w.shape[0])])

    def deq4(q4, s4):  # (L, K/2, N) packed, (L, K/256, N) -> bf16 (L, K, N)
        return torch.stack([dequantize_int4(q4[i], s4[i]).to(torch.bfloat16)
                            for i in range(q4.shape[0])])

    ip, op = blocks["attn"]["in_proj"], blocks["attn"].get("out_proj")
    if op is None:
        w_in = deq(ip["q"], ip["s"])
        w_o = deq(blocks["attn"]["o"]["q"], blocks["attn"]["o"]["s"])
        w_f = deq(blocks["mlp"]["fc_out"]["kernel"]["q"], blocks["mlp"]["fc_out"]["kernel"]["s"])
    elif "q4" in ip:
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
        if key in blocks and "fused" in blocks[key]:
            fz = blocks[key]["fused"]
            out["blocks"][key] = {
                "down": {"kernel": deq(fz["wd"], fz["sd"][:, 0]), "bias": fz["bd"][:, 0]},
                "up": {"kernel": deq(fz["wu"], fz["su"][:, 0]), "bias": fz["bu"][:, 0]}}
        elif key in blocks:  # the int8 adapter mode: packs, bf16 biases, LN and scale
            ad = dict(blocks[key])
            for proj in ("down", "up"):
                w = ad[proj]["kernel"]
                ad[proj] = {"kernel": deq(w["q"], w["s"]) if isinstance(w, dict) else w,
                            "bias": ad[proj]["bias"]}
            out["blocks"][key] = ad
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


def _want_launches(bits, L, steps, rows, adapters=1):
    """Exact launches of one request of ``steps`` tokens (1 prefill of
    ``rows`` padded positions + steps-1 decode forwards) over fused
    adapters (``adapters`` a layer: 1 in v1, 2 in v2), by wrapper."""
    from magma_tpu_torch.ops.quant import FUSED_ADAPTER_MAX_ROWS

    if bits == 8:
        # prefill: K2b and K4a once a layer; a decode step: K2b for layer
        # 0's in_proj, then one K8 for all layers; K2a once a forward
        want = {"int8_matmul_stacked_kernel": L + steps - 1, "dual_matmul_kernel": L,
                "int8_matmul_kernel": steps}
    else:
        # the same with K3 and K4b; no K6
        want = {"int4_matmul_stacked_kernel": L + steps - 1, "int4_dual_kernel": L,
                "int8_matmul_kernel": steps}
    # the prefill's adapter: K5 up to 64 rows, else the dequantising matmul
    want["fused_adapter_kernel"] = adapters * L if rows <= FUSED_ADAPTER_MAX_ROWS else 0
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


def _requests_with_launches(torch, model, bits, tag, want_fn=None):
    """The three requests, each with exact launches of every kernel, counts
    set to 0 just before (``want_fn(steps, rows)`` the expected launches,
    default ``_want_launches``).  Returns (launches by wrapper, (greedy
    request's embeddings, tokens))."""
    L = model.lm_config.n_layers
    want_fn = want_fn or functools.partial(_want_launches, bits, L)
    wrappers = _all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0  # count this path only
    greedy = None
    for i, (name, kw) in enumerate(_requests()):
        before = {k: fn.launches for k, fn in wrappers.items()}
        emb, tokens, steps = _run_request(torch, model, i, name, kw, tag)
        got = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        want = want_fn(steps, emb.shape[1] + (-emb.shape[1]) % 64)
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


def _n_adapters(cfg):
    return sum(spec is not None for spec in (cfg.mlp_adapter, cfg.attn_adapter))


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
        # K6 once a layer; K5 once a layer for each adapter
        n_b8 = L if k_b8 == "boundary_kernel" else L * _n_adapters(cfg0)
        check(got["decode_all_layers_kernel"] == 1 and got["decode_layer_kernel"] == L
              and got[k_b8] == n_b8, f"{tag} agreement: launches {got}")
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


# ---------------------------------------------------------------------------
# Serving: split generate (5c) and the continuous-batching engine (5d, 7b)
# ---------------------------------------------------------------------------

# the engine's settings as docs/SERVING.md documents them
ENGINE_KW = dict(cache_classes=((8, 2048), (16, 512)), decode_window=8, prefill_chunk=512)
# per-request sampling of the trace, by request index mod 4: the first two
# decode deterministically (greedy, top_k = 1), the others sample
TRACE_SAMPLING = [{}, dict(temperature=0.8, top_k=1), dict(temperature=0.7, top_p=0.9),
                  dict(temperature=0.7, top_k=5)]
N_CAPTIONS, N_LONG, LONG_IMAGES = 20, 3, 8


class _PlainServing:
    """Within the block, the wrappers of a batched decode step's kernels run
    their plain versions on the card: K2a, K2b, K4a, K5, K3, K4b and K6
    swapped for the same functions in torch."""

    def __enter__(self):
        from magma_tpu_torch.ops import quant

        self.quant = quant
        self.saved = {n: getattr(quant, n) for n in (
            "int8_matmul_kernel", "int8_matmul_stacked_kernel", "dual_matmul_kernel",
            "fused_adapter_kernel", "int4_matmul_stacked_kernel", "int4_dual_kernel",
            "boundary_kernel")}
        quant.int8_matmul_kernel = lambda x2, wq, s: quant._dq_product(x2, wq, s)
        quant.int8_matmul_stacked_kernel = quant.int8_matmul_stacked_plain
        quant.dual_matmul_kernel = (
            lambda c2, h2, wq, s, i: quant.dual_matmul_stacked_plain(c2, h2, {"q": wq, "s": s}, i))
        quant.fused_adapter_kernel = quant.fused_adapter_stacked_plain
        quant.int4_matmul_stacked_kernel = quant.int4_matmul_stacked_plain
        quant.int4_dual_kernel = (lambda c2, h2, q4, s4, i: quant.dual_matmul_stacked_plain(
            c2, h2, {"q4": q4, "s4": s4}, i))
        quant.boundary_kernel = quant.boundary_fused_stacked_plain
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.quant, n, fn)


class _EngineProbe:
    """Within the block, the engine's dispatch functions are counted: full
    prefills (with their padded lengths), chunks, installs and decode
    windows (pool rows, steps, CUDA events around each, whether a chunk
    rode it).  ``on_window(B, args, n_steps)`` runs before a window."""

    def __init__(self, torch, on_window=None):
        self.torch, self.on_window = torch, on_window
        self.prefills, self.chunks, self.installs, self.windows = [], 0, 0, []

    def __enter__(self):
        from magma_tpu_torch.serving import engine as teng

        torch, self.teng = self.torch, teng
        self.saved = {n: getattr(teng, n) for n in ("_prefill_full", "_chunk_body",
                                                    "_install_slot", "_decode",
                                                    "_decode_with_chunk")}

        def prefill(cfg, params, embeds, *a, **k):
            self.prefills.append(embeds.shape[1])
            return self.saved["_prefill_full"](cfg, params, embeds, *a, **k)

        def chunk(*a, **k):
            self.chunks += 1
            return self.saved["_chunk_body"](*a, **k)

        def install(*a, **k):
            self.installs += 1
            return self.saved["_install_slot"](*a, **k)

        def window(name, piggy):
            def fn(*a, n_steps, eos_token, **k):
                B = a[3].shape[0]
                if self.on_window is not None:
                    self.on_window(B, a[:8], n_steps)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = self.saved[name](*a, n_steps=n_steps, eos_token=eos_token, **k)
                end.record()
                self.windows.append((B, n_steps, start, end, piggy))
                return out
            return fn

        teng._prefill_full, teng._chunk_body, teng._install_slot = prefill, chunk, install
        teng._decode = window("_decode", False)
        teng._decode_with_chunk = window("_decode_with_chunk", True)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.teng, n, fn)

    def want_launches(self, bits, L):
        """Exact launches of what ran, by wrapper, on the v1 recipe."""
        inproj = "int8_matmul_stacked_kernel" if bits == 8 else "int4_matmul_stacked_kernel"
        dual = "dual_matmul_kernel" if bits == 8 else "int4_dual_kernel"
        want = {}

        def add(k, n):
            want[k] = want.get(k, 0) + n

        for s in self.prefills:  # a 1-row prefill: K1 a layer, K5 up to 64 rows
            add(inproj, L)
            add(dual, L)
            add("flash_attention_kernel", L)
            add("fused_adapter_kernel", L if s <= 64 else 0)
        add(inproj, L * self.chunks)  # a chunk: history attention, 512 rows
        add(dual, L * self.chunks)
        add("int8_matmul_kernel", self.installs)  # the first token's head
        for B, n, *_ in self.windows:
            if B == 1:  # layer 0's in_proj, then all layers in one K8
                add(inproj, n)
                add("decode_all_layers_kernel", n)
            elif bits == 4 and B <= 8:  # layer 0's in_proj, then K6 a layer
                add(inproj, n)
                add("boundary_kernel", L * n)
            else:
                add(inproj, L * n)
                add(dual, L * n)
                add("fused_adapter_kernel", L * n)
            add("int8_matmul_kernel", n)
        return {k: want.get(k, 0) for k in _all_wrappers()}

    def ms_per_step(self):
        """{(pool rows, a chunk rode): (median ms a decode step, windows)}
        from the CUDA events around each window's dispatch."""
        per = {}
        for B, n, start, end, piggy in self.windows:
            per.setdefault((B, piggy), []).append(start.elapsed_time(end) / n)
        return {k: (statistics.median(v), len(v)) for k, v in sorted(per.items())}


def phase_split_generate(torch, model):
    """Phase 5c: ``Magma.generate`` on 8 eight-image prompts (b·s above
    8192) takes the split path; its first-step logits against the
    monolithic path's at the same shape, both paths' tokens and peak
    memory.  Returns (the split path's launches by wrapper, K1's wgmma-body
    launches of the monolithic b = 8 prefill)."""
    from magma_tpu_torch.models import gptj, magma as magma_mod
    from magma_tpu_torch.ops import sampling
    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel

    cfg, lm, dev = model.lm_config, model.params["lm"], model.device
    L, b, C = cfg.n_layers, 8, 512
    t_phase = time.perf_counter()
    # row r: the eight images rotated by r, then the text
    imgs = [model.preprocess_inputs([_image(200 + j)]) for j in range(LONG_IMAGES)]
    text = model.preprocess_inputs([PROMPT])
    emb = torch.cat([torch.cat(imgs[r:] + imgs[:r] + [text], dim=1) for r in range(b)])
    s = emb.shape[1]
    s_pad = -(-s // 64) * 64
    check(b * s_pad > magma_mod.SPLIT_ABOVE, f"{b} x {s_pad} does not reach the split path")
    wrappers = _all_wrappers()
    calls, split = [], magma_mod.generate_tokens_split

    def spy(*a, **kw):
        calls.append((kw["window"], kw["prefill_chunk"]))
        return split(*a, **kw)

    def peak_run(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, resident, torch.cuda.max_memory_allocated()

    for fn in wrappers.values():
        fn.launches = 0  # count this path only
    timing = {}
    magma_mod.generate_tokens_split = spy
    try:
        tokens, resident, peak_split = peak_run(lambda: model.generate(
            emb, max_steps=MAX_STEPS, temperature=0.0, decode=False, timing=timing))
    finally:
        magma_mod.generate_tokens_split = split
    got = {k: fn.launches for k, fn in wrappers.items()}
    steps, n_chunks = timing["steps"], -(-s_pad // C)
    want = {k: 0 for k in wrappers}
    want.update({"int8_matmul_stacked_kernel": L * (n_chunks + steps),
                 "dual_matmul_kernel": L * (n_chunks + steps),
                 "fused_adapter_kernel": L * steps, "int8_matmul_kernel": 1 + steps})
    print(f"[split] Magma.generate on {b} prompts of {LONG_IMAGES} images + text ({s} tokens, "
          f"padded to {s_pad}; b·s = {b * s_pad} > {magma_mod.SPLIT_ABOVE}): split path calls "
          f"{calls} (window, prefill_chunk; a spy on models/magma.generate_tokens_split), "
          f"{n_chunks} chunks of {C}, {steps} steps, prefill {timing['prefill_ms']:.1f} ms, "
          f"decode {timing['decode_ms'] / steps:.2f} ms/step (b = {b})")
    print(f"[split]   launches {got}")
    check(calls == [(8, C)], f"split generate not taken: {calls}")
    check(got == want, f"split launches {got}, expected {want}")
    check(((tokens >= 0) & (tokens < cfg.vocab_size)).all(), "split: token out of vocab")

    padded = torch.nn.functional.pad(emb, (0, 0, 0, s_pad - s))
    w0 = flash_attention_kernel.wgmma_launches
    (mono, _), _, peak_mono = peak_run(lambda: sampling.generate_tokens(
        cfg, lm, padded, None, max_steps=MAX_STEPS, temperature=0.0,
        eos_token=model.eos_token, prompt_len=s))
    print(f"[split] peak device memory: split {peak_split / 1e9:.2f} GB, monolithic "
          f"{peak_mono / 1e9:.2f} GB ({resident / 1e9:.2f} GB resident before each: the model "
          f"and what earlier phases keep); above it {(peak_split - resident) / 1e9:.2f} vs "
          f"{(peak_mono - resident) / 1e9:.2f} GB")
    same = int((mono.cpu() == torch.as_tensor(tokens)).sum())
    print(f"[split] greedy tokens, split vs monolithic: equal at {same}/{b * MAX_STEPS}")

    # the first step's logits: the chunked prefill (history attention) vs
    # the whole-prompt one (K1), on the same inputs
    pl = torch.full((b,), s, dtype=torch.int32, device=dev)
    total = -(-max(s_pad + MAX_STEPS, n_chunks * C) // 64) * 64
    cache = gptj.init_kv_cache(cfg, b, total, device=dev)
    last_h = torch.zeros((b, 1, cfg.d_model), dtype=cfg.compute_dtype, device=dev)
    for ci in range(n_chunks):
        chunk = torch.nn.functional.pad(padded[:, ci * C:(ci + 1) * C],
                                        (0, 0, 0, max(0, (ci + 1) * C - s_pad)))
        cache, last_h = sampling._split_prefill_chunk(cfg, lm, chunk, cache, last_h, ci * C, pl,
                                                      chunk=C)
    got_l = gptj.lm_head(cfg, lm, last_h)[:, 0]
    del cache
    _, ref_l = sampling._split_prefill(cfg, lm, padded, pl, max_steps=MAX_STEPS)
    diff = (got_l - ref_l)[:, :cfg.vocab_size].abs().max().item()
    agree = int((got_l.argmax(-1) == ref_l.argmax(-1)).sum())
    print(f"[split] first-step logits (fp32), chunked prefill vs the whole prompt's: max|diff| "
          f"{diff:.4e} (tol {LOGIT_TOL}: the chunks' attention is the einsum path against K1, "
          f"phase 4's comparison; logit std {ref_l.std().item():.3f}), argmax equal in "
          f"{agree}/{b} rows")
    check(torch.isfinite(got_l).all().item(), "split: non-finite first-step logits")
    check(diff <= LOGIT_TOL, f"split first-step logits differ by {diff} > {LOGIT_TOL}")
    # the whole-prompt prefills at b = 8 (generate_tokens' and the logits')
    # run K1's wgmma body: 16 heads x 10 blocks of 128 rows x 8 >= 132
    wgmma = flash_attention_kernel.wgmma_launches - w0
    print(f"[split] K1 launches on the wgmma body: {wgmma} (the two whole-prompt b = {b} "
          f"prefills; the split path runs no K1)")
    check(wgmma == 2 * L, f"the whole-prompt b = {b} prefills ran {wgmma} K1 wgmma launches")
    print(f"[split] phase time {time.perf_counter() - t_phase:.1f} s (host clock)")
    return got, wgmma


def _trace(model):
    """The trace's prompts, embedded once: N_CAPTIONS single-image captions,
    then N_LONG eight-image prompts, each with its TRACE_SAMPLING index.
    Returns [(embeddings, sampling index, kind)]."""
    reqs = []
    for i in range(N_CAPTIONS):
        reqs.append((model.preprocess_inputs([_image(10 + i), PROMPT]),
                     i % len(TRACE_SAMPLING), "caption"))
    for i in range(N_LONG):
        imgs = [_image(300 + 10 * i + k) for k in range(LONG_IMAGES)]
        reqs.append((model.preprocess_inputs(imgs + [PROMPT]), i, "8 images"))
    return reqs


def _submit(engine, trace):
    """Submit the trace in order through ``MagmaServingEngine.submit``.
    Returns [(request id, sampling index, kind)]."""
    return [(engine.submit(emb, MAX_STEPS, **TRACE_SAMPLING[j]), j, kind)
            for emb, j, kind in trace]


def _drive(torch, engine, check_syncs):
    """Run the engine dry; with ``check_syncs`` every step runs under
    ``set_sync_debug_mode("error")`` up to the collect of the previous
    window (the one device-to-host copy a window).  Returns (wall s,
    {request id: s to its first token})."""
    first, collects = {}, []
    orig = engine._collect_window
    if check_syncs:
        def collect(gi, prev, emitted):
            torch.cuda.set_sync_debug_mode(0)
            collects.append(1)
            orig(gi, prev, emitted)

        engine._collect_window = collect
    t0 = time.perf_counter()
    try:
        while engine.has_work:
            if check_syncs:
                torch.cuda.set_sync_debug_mode("error")
            try:
                emitted = engine.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            now = time.perf_counter() - t0
            for rid in emitted:
                first.setdefault(rid, now)
    finally:
        engine._collect_window = orig
    check(not check_syncs or collects, "no window was collected")
    return time.perf_counter() - t0, first


def _replay(torch, eng_mod, args, sample_fn, n_steps, generator=None):
    """A window replayed on a pool's state: it writes only positions the
    real window writes again before any read.  Returns the logits seen."""
    cfg, params, cache, last, lens, active = args[:6]
    seen = []

    def sampler(gen, logits):
        seen.append(logits.float())
        return sample_fn(gen, logits)

    with torch.no_grad():
        eng_mod._window_body(cfg, params, cache, last, lens, active, generator, sampler,
                             n_steps=n_steps, eos_token=-1)
    return seen


def phase_engine(torch, model, bits, tag, smi):
    """Phases 5d and 7b: ``MagmaServingEngine`` over two pools serves the
    trace pipelined (the main path: exact launches, no host wait in a
    dispatch) and unpipelined (the same deterministic tokens; one full
    window of each pool replayed through the kernels and the plain path,
    and profiled); the deterministic requests' first tokens against
    ``Magma.generate``'s; a 1-slot engine's tokens against
    ``Magma.generate``'s.  Returns the main path's launches by wrapper."""
    from torch.profiler import ProfilerActivity, profile

    from magma_tpu_torch.serving import MagmaServingEngine
    from magma_tpu_torch.serving import engine as eng_mod

    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel

    cfg = model.lm_config
    L = cfg.n_layers
    wrappers = _all_wrappers()
    wgmma0 = flash_attention_kernel.wgmma_launches
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: pipelined windows
    for fn in wrappers.values():
        fn.launches = 0  # count this path only
    t_phase = time.perf_counter()
    trace = _trace(model)
    torch.cuda.reset_peak_memory_stats()
    eng = MagmaServingEngine(model, seed=0, **ENGINE_KW)
    reqs = _submit(eng, trace)
    with _EngineProbe(torch) as probe:
        wall, first = _drive(torch, eng, check_syncs=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    got = {k: fn.launches for k, fn in wrappers.items()}
    want = probe.want_launches(bits, L)
    res = eng.finished
    n_tok = sum(len(r.tokens) for r in res.values())
    ttft = sorted(first[r] * 1e3 for r, _, _ in reqs)
    pools = {B: sum(1 for w in probe.windows if w[0] == B) for B, _ in ENGINE_KW["cache_classes"]}
    print(f"[{tag}] {len(reqs)} requests ({N_CAPTIONS} captions of one image, {N_LONG} of "
          f"{LONG_IMAGES} images; {MAX_STEPS} new tokens each; sampling by index "
          f"{TRACE_SAMPLING}), pools {ENGINE_KW['cache_classes']}, window "
          f"{ENGINE_KW['decode_window']}, chunk {ENGINE_KW['prefill_chunk']}, prompts embedded "
          f"before the first submit, pipelined: "
          f"{len(probe.prefills)} full prefills, {probe.chunks} chunks, {probe.installs} "
          f"installs, windows by pool rows {pools}")
    print(f"[{tag}]   launches {got}")
    check(got == want, f"{tag}: launches {got}, expected {want}")
    check(got["fused_adapter_kernel"] > 0, f"{tag}: K5 never launched")
    if bits == 4:
        check(got["boundary_kernel"] > 0, f"{tag}: K6 never launched")
    check(set(res) == {r for r, _, _ in reqs}, f"{tag}: not every request finished")
    for rid, j, kind in reqs:
        r = res[rid]
        check(r.finish_reason in ("eos", "length") and 1 <= len(r.tokens) <= MAX_STEPS
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{tag}: request {rid} ({kind}) ended {r.finish_reason} with {len(r.tokens)} tokens")
    steps_ms = probe.ms_per_step()
    print(f"[{tag}] on {smi}: {n_tok} tokens in {wall:.3f} s (host clock from the first "
          f"step): {n_tok / wall:.1f} output tokens/s; time to first token median "
          f"{statistics.median(ttft):.1f} ms, p90 {ttft[int(0.9 * (len(ttft) - 1))]:.1f} ms; "
          f"ms per decode step by pool rows (CUDA events around each window, median): "
          + ", ".join(f"{B} rows{' with a chunk' if piggy else ''} {ms:.2f} ({n} windows)"
                      for (B, piggy), (ms, n) in steps_ms.items())
          + f"; resident cache positions {eng.resident_cache_positions}; peak device memory "
          f"{peak / 1e9:.2f} GB")
    print(f"[{tag}] no host wait in any step's admission, prefills, chunks, installs and "
          f"window dispatches (set_sync_debug_mode('error') up to each collect)")
    texts = eng.text_results()
    print(f"[{tag}] text of request 0: {texts[reqs[0][0]]!r}")
    deterministic = {rid: res[rid].tokens for rid, j, _ in reqs if j in (0, 1)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the same trace unpipelined; the first window of each pool with at
    # least half its rows live replayed through the kernels and the plain
    # path (all rows: the kernels see every row), and profiled
    replayed = {}

    def on_window(B, args, n_steps):
        if B in replayed or 2 * int(args[5].sum()) < B:
            return
        greedy = eng_mod._static_sampler(cfg, 0.0, 0, 0.0, "reference")
        k_l = _replay(torch, eng_mod, args, greedy, 1)[0]
        with _PlainServing():
            p_l = _replay(torch, eng_mod, args, greedy, 1)[0]
        rel = _rel(k_l[:, :cfg.vocab_size], p_l[:, :cfg.vocab_size])
        agree = int((k_l.argmax(-1) == p_l.argmax(-1)).sum())
        top2 = p_l[:, :cfg.vocab_size].topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        gen = torch.Generator(device=model.device)
        walls = []
        for _ in range(3):
            gen.set_state(args[6].get_state())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _replay(torch, eng_mod, args, args[7], n_steps, gen)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        gen.set_state(args[6].get_state())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the kernels alone
            _replay(torch, eng_mod, args, args[7], n_steps, gen)
            torch.cuda.synchronize()
        kernels = _kernel_events(torch, prof)
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        wall_ms = statistics.median(walls)
        replayed[B] = (rel, agree)
        print(f"[{tag}] a {B}-row decode step, kernels vs the plain path (their wrappers' "
              f"plain versions on the card): logits rel {rel:.3e} (tol {PATH_REL_TOL}),"
              f" argmax equal in {agree}/{B} rows (the plain path's least top-2 margin "
              f"{margin:.3e})")
        print(f"[{tag}] a {B}-row window of {n_steps} steps replayed: wall {wall_ms:.2f} ms "
              f"(host clock, median of 3), {wall_ms / n_steps:.2f} ms a step; device busy "
              f"{busy:.2f} ms in {len(kernels)} kernels, idle share "
              + (f"{1 - busy / wall_ms:.3f}" if kernels else "not measured (no kernels seen)"))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
            print(f"[{tag}]   {ms:.3f} ms  {name[:90]}")

    eng = MagmaServingEngine(model, seed=0, pipeline_windows=False, **ENGINE_KW)
    reqs2 = _submit(eng, trace)
    with _EngineProbe(torch, on_window):
        _drive(torch, eng, check_syncs=False)
    res2 = {rid: eng.finished[rid].tokens for rid, j, _ in reqs2 if j in (0, 1)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    same = list(deterministic.values()) == list(res2.values())
    print(f"[{tag}] the {len(res2)} greedy and top_k = 1 requests, pipelined vs unpipelined: "
          f"tokens identical: {same}")
    check(same, f"{tag}: pipelined and unpipelined tokens differ")
    for B, _ in ENGINE_KW["cache_classes"]:
        check(B in replayed, f"{tag}: no {B}-row window was replayed")
        rel, agree = replayed[B]
        check(rel < PATH_REL_TOL and agree == B,
              f"{tag}: a {B}-row step differs from the plain path: rel {rel}, argmax {agree}/{B}")

    # the deterministic captions' first tokens against Magma.generate's
    # (the same 1-row prefill; the eight-image prompts prefill in chunks)
    captions = [(rid, emb) for (rid, j, kind), (emb, _, _) in zip(reqs, trace)
                if kind == "caption" and j in (0, 1)]
    for rid, emb in captions:
        ref = model.generate(emb, max_steps=1, temperature=0.0, decode=False)[0, 0]
        check(int(ref) == deterministic[rid][0], f"{tag}: request {rid}'s first token "
              f"{deterministic[rid][0]} != Magma.generate's {int(ref)}")
    print(f"[{tag}] first tokens of the {len(captions)} deterministic captions equal to "
          f"Magma.generate's")

    # one slot of generate's cache length: K8, as Magma.generate; the
    # request through submit_prompt, the entry that embeds it
    emb = trace[0][0]
    n_cache = -(-(emb.shape[1] + MAX_STEPS) // 64) * 64
    one = MagmaServingEngine(model, cache_classes=((1, n_cache),), decode_window=8)
    rid = one.submit_prompt([_image(10), PROMPT], MAX_STEPS)
    with _EngineProbe(torch) as probe1:
        one.run()
    ref = model.generate(emb, max_steps=MAX_STEPS, temperature=0.0, decode=False)[0].tolist()
    eos = model.eos_token
    ref = ref[:ref.index(eos) + 1] if eos in ref else ref
    got1 = one.finished[rid].tokens
    print(f"[{tag}] a (1, {n_cache}) pool: {len(got1)} tokens, windows by rows "
          f"{sorted({w[0] for w in probe1.windows})}, identical to Magma.generate's: "
          f"{got1 == ref}; text {one.text_results()[rid]!r}")
    check(got1 == ref, f"{tag}: the 1-slot engine's tokens differ from Magma.generate's")
    del one
    wgmma = flash_attention_kernel.wgmma_launches - wgmma0
    print(f"[{tag}] K1 launches on the wgmma body: {wgmma} (every 1-row prefill of 192 "
          f"positions keeps the mma.sync body; chunks run no K1)")
    check(wgmma == 0, f"{tag}: a 1-row serving prefill ran K1's wgmma body")
    print(f"[{tag}] phase time {time.perf_counter() - t_phase:.1f} s (host clock)")
    return got


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
        entries["k1_training"] = _time_k1_training_shape(torch, F, q, k, v, hd)
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
    forward and remat recompute), path A's batch of 2 and path B's of 1, both
    on the wgmma body: kernel alone, a call, plain, its bound and SDPA's
    causal forward (the library call) on the same inputs.  Returns the
    numbers for K1's JSON entry, keyed train_a_* and train_b_*."""
    from magma_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_kernel,
                                                     flash_attention_plain)

    out = {}
    for tag, (qq, kk, vv) in (("a", (q, k, v)), ("b", (q[:1], k[:1], v[:1]))):
        b, s, h, _ = qq.shape
        kw = dict(scale=hd ** -0.5, causal=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (qq, kk, vv))
        before = flash_attention_kernel.wgmma_launches
        lib_err = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=kw["scale"])
                   .transpose(1, 2).float() - flash_attention_fwd(qq, kk, vv, **kw)[0].float())
        check(flash_attention_kernel.wgmma_launches == before + 1,
              f"K1 at path {tag.upper()}'s training shape did not run the wgmma body")
        # s (s + 1) / 2 attended pairs a head, a QK^T and a PV product of 2 hd
        # flops each; bytes: q, k, v read, O written, the fp32 lse
        pairs = b * h * s * (s + 1) // 2
        tm = _timing(torch, f"K1 training shape, path {tag.upper()}", b * s,
                     lambda: flash_attention_fwd(qq, kk, vv, **kw),
                     lambda: flash_attention_plain(qq, kk, vv, **kw),
                     lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                            scale=kw["scale"]),
                     nbytes(qq, kk, vv, qq) + b * h * s * 4, 2 * 2 * hd * pairs,
                     "flash_fwd_wgmma", library_is="scaled_dot_product_attention(is_causal=True)",
                     plain_iters=5)
        check(tm["kernel_alone_ms"] is not None and tm["kernel_alone_ms"] > 0,
              f"K1 path {tag.upper()}: the profiler saw no flash_fwd_wgmma kernel")
        print(f"[K1 training shape, path {tag.upper()}] b={b} s={s} h={h} hd={hd} causal: "
              f"max|SDPA - kernel| {lib_err.abs().max().item():.3e}")
        out.update({f"train_{tag}_{key}": val for key, val in tm.items()})
    return out


def _train_config(path):
    """Path A: configs/MAGMA_v1.yml as it stands, ga 2 x micro 2.  Path B:
    the QLoRA recipe (bench.py stage 6): train_lm_int8, encoder frozen, ga
    2 x micro 1.  Phase 15's paths, the recipes that had only served on the
    card: C, configs/MAGMA_v2.yml as it stands (normal mlp and attention
    adapters at k=8), its ga 4 x micro 1; D, v1 with the ViT-B/32
    (``encoder_name: "clip"``, phase 10's tower), ga 2 x micro 2; E, v1 with
    the NF-ResNet50 over the int8 QLoRA LM, the tower trainable, ga 2 x
    micro 1.  All at seq 2048 with warmup_num_steps 1."""
    from magma_tpu_torch.config import MultimodalConfig

    cfg = MultimodalConfig.from_yml(CONFIG_V2 if path == "C" else CONFIG)
    cfg.warmup_num_steps = 1
    if path != "C":
        cfg.gradient_accumulation_steps = 2
    cfg.batch_size = 2 if path in ("B", "E") else 4
    cfg.encoder_name = {"D": "clip", "E": "nfresnet50"}.get(path, cfg.encoder_name)
    if path in ("B", "E"):
        cfg.train_lm_int8 = True
    if path == "B":
        cfg.freeze_img_encoder = True
        cfg.lr_decay_iters = None  # bench.py's recipe: WarmupLR at lr 8e-4
    return cfg


def _image_resolution(cfg):
    """The side of the images the model's transforms give (``data/
    transforms.get_transforms``): a CLIP tower's ``input_resolution`` (224
    for the ViT-B/32), else ``image_size`` (the NF-ResNet's random crop)."""
    from magma_tpu_torch.models.image_prefix import get_encoder

    if "clip" not in cfg.encoder_name:
        return cfg.image_size
    return get_encoder(cfg.encoder_name, cfg.encoder_overrides)[1].input_resolution


def _train_batch(torch, cfg, seq, seed):
    """A seeded global batch on the card: images at the model's transform
    resolution as CLIP's preprocessing leaves them (about zero mean),
    captions of 1024 random tokens then EOS padding, as bench.py's recipe
    step."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b, res = cfg.batch_size, _image_resolution(cfg)
    images = torch.randn((b, 3, res, res), generator=g, device=dev)
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
    recompute, K9a and K9b once a layer (the adapters and towers are torch
    products); paths B and E (the int8 QLoRA LM) also K2b for in_proj, o
    and fc_out forward and recompute, K2a for each head chunk forward and
    recompute, K10 for each of those products once."""
    want = {"flash_attention_kernel": 2 * L, "flash_attention_bwd_dkv_kernel": L,
            "flash_attention_bwd_dq_kernel": L}
    if path in ("B", "E"):
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
        if path in ("B", "E"):
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
    """Phase 8 (path A), 9 (path B) or 15 (paths C, D, E): the Trainer at
    full width (``_train_config``).  Returns the launches of its
    TRAIN_STEPS steps by wrapper."""
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
    adapters = [(name, spec.downsample_factor) for name, spec in
                (("mlp", lm.mlp_adapter), ("attention", lm.attn_adapter)) if spec is not None]
    res = _image_resolution(cfg)
    print(f"[{tag}] Magma({(CONFIG_V2 if path == 'C' else CONFIG).name}, encoder "
          f"{cfg.encoder_name} at {res} px, "
          f"{'frozen' if cfg.freeze_img_encoder else 'trainable'}, prefix "
          f"{model.image_prefix_seq_len} tokens) + Trainer in {time.perf_counter() - t0:.1f} s: "
          f"{'int8 QLoRA layout' if cfg.train_lm_int8 else 'bf16 LM'}, adapters (name, k) "
          f"{adapters}, {nbytes(*frozen) / 1e9:.2f} GB frozen, {n_trainable / 1e6:.1f} M "
          f"trainable, seq {seq}, ga {ga} x micro {micro}, lr {cfg.lr}, image_enc_lr "
          f"{cfg.image_enc_lr}, dropout {cfg.image_embed_dropout_prob}, attention "
          f"{lm.attention_impl}, remat {lm.remat}")
    check(lm.remat and lm.attention_impl == "flash" and seq == 2048 and L == 28
          and lm.d_model == 4096, f"{tag}: not the recipe")
    check(adapters == ([("mlp", 8), ("attention", 8)] if path == "C" else [("mlp", 4)])
          and res == (224 if path == "D" else 384), f"{tag}: not the recipe: {adapters}, {res} px")
    frozen_sums = _checksums(torch, frozen)
    labels = dict(tree_items(label_params(trainer.params)))
    before = {}
    for p, t in trainer.trainable:
        before.setdefault(labels[p], []).append(t.detach().clone())
    check(("img_enc_decay" in before) == (not cfg.freeze_img_encoder),
          f"{tag}: the tower's groups {sorted(before)}")

    wrappers = _all_wrappers()
    want = _want_train_launches(path, L, n_chunks, ga)
    totals = dict.fromkeys(wrappers, 0)
    totals["k1_wgmma"] = 0
    k1 = wrappers["flash_attention_kernel"]
    times, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        batch = [_rank_share(torch, trainer, t) for t in _train_batch(torch, cfg, seq, 100 + step)]
        for fn in wrappers.values():
            fn.launches = 0  # count this step only
        k1.wgmma_launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = trainer.train_step(*batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        got = {k: fn.launches for k, fn in wrappers.items()}
        for k in wrappers:
            totals[k] += got[k]
        totals["k1_wgmma"] += k1.wgmma_launches
        losses.append(loss)
        print(f"[{tag}] step {step + 1}: loss {loss:.6f}, {times[-1]:.1f} ms, launches "
              + ", ".join(f"{k} {v}" for k, v in got.items() if v)
              + f" (K1 on the wgmma body {k1.wgmma_launches})")
        check(np.isfinite(loss), f"{tag}: non-finite loss at step {step + 1}")
        check(got == want, f"{tag} step {step + 1}: launches {got}, expected {want}")
        check(k1.wgmma_launches == got["flash_attention_kernel"],
              f"{tag} step {step + 1}: {k1.wgmma_launches} of {got['flash_attention_kernel']} "
              f"K1 launches on the wgmma body")
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


def phase_more_training(torch):
    """Phase 15: training in the recipes that had only served on the card,
    each through ``phase_training`` at full width, each model freed before
    the next: path C (MAGMA_v2 as it stands), D (the ViT-B/32), E (the
    NF-ResNet50 over the int8 QLoRA LM).  Returns their launches by
    wrapper."""
    totals = {}
    for path in "CDE":
        for k, v in phase_training(torch, path).items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ---------------------------------------------------------------------------
# Phases 10-12: the other image towers, the train CLI, the classifier
# ---------------------------------------------------------------------------

TOWERS = ("clip", "nfresnet50")
# a tower's pooled prefix in fp32 on the card (TF32 off) against the same
# weights in fp32 on the CPU: the same operations summed in another order
# (cuDNN's convolutions, cuBLAS's products), ~1e-6 relative each, compounded
# over the ViT's 12 blocks or the NF-ResNet's 17; each element within 1e-3
# of the CPU prefix's largest magnitude
TOWER_REL_TOL = 1e-3


def _tower_config(name):
    """configs/MAGMA_v1.yml with ``encoder_name`` set: GPT-J 6B at full width
    and the tower at its published widths (ViT-B/32 at 224 px; NF-ResNet50
    (3, 4, 6, 3), whose requests take the random crop at v1's image_size)."""
    from magma_tpu_torch.config import MultimodalConfig

    cfg = MultimodalConfig.from_yml(CONFIG)
    cfg.encoder_name = name
    return cfg


def _tower_vs_cpu(torch, model, tag):
    """The tower's pooled prefix (encoder, projection, dropout off, LN) in
    fp32 on the card against the same weights in fp32 on the CPU, on two
    seeded images.  Returns max|diff| / max|cpu|."""
    from magma_tpu_torch.models import image_prefix as ip_mod
    from magma_tpu_torch.utils import tree_map

    pc = model.prefix_config
    ov = dict(pc.encoder_overrides or ())
    ov["compute_dtype"] = torch.float32
    cfg32 = dataclasses.replace(pc, compute_dtype=torch.float32,
                                encoder_overrides=tuple(sorted(ov.items())))
    res = _image_resolution(model.config)
    images = torch.randn((2, 3, res, res), generator=torch.Generator().manual_seed(11))
    params = tree_map(lambda t: t.float(), model.params["image_prefix"])
    state = model.state["image_prefix"]
    card, _ = ip_mod.apply(params, state, images.cuda(), cfg32)
    cpu, _ = ip_mod.apply(tree_map(lambda t: t.cpu(), params), tree_map(lambda t: t.cpu(), state),
                          images, cfg32)
    rel = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    print(f"[{tag}] pooled prefix {tuple(card.shape)} in fp32, card vs CPU on the same weights: "
          f"max|diff| / max|cpu| {rel:.3e} (tol {TOWER_REL_TOL})")
    check(bool(torch.isfinite(card).all()), f"{tag}: non-finite prefix on the card")
    check(rel <= TOWER_REL_TOL, f"{tag}: the card's prefix differs from the CPU's by {rel}")
    return rel


def _tower_requests(torch, model, tag):
    """The three requests of phase 5, each with exact launches and its
    prefill logits held against the same model with every kernel swapped for
    its plain version.  The NF-ResNet's random crop is seeded before each.
    Returns the requests' launches by wrapper, without the checks' prefills."""
    import random

    lm = model.lm_config
    L = lm.n_layers
    wrappers = _all_wrappers()
    totals = dict.fromkeys(wrappers, 0)
    vision_ms = []
    for i, (name, kw) in enumerate(_requests()):
        random.seed(1000 + i)
        before = {k: fn.launches for k, fn in wrappers.items()}
        emb, tokens, steps = _run_request(torch, model, i, name, kw, tag)
        got = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        want = _want_launches(8, L, steps, emb.shape[1] + (-emb.shape[1]) % 64)
        print(f"[{tag}]   launches {got}")
        check(got == want, f"{tag} request {i}: launches {got}, expected {want}")
        for k in totals:
            totals[k] += got[k]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model.preprocess_inputs([_image(), PROMPT])
        end.record()
        end.synchronize()
        vision_ms.append(start.elapsed_time(end))
        cfg0 = model.lm_config
        got_logits = _prefill_last_logits(torch, cfg0, model.params["lm"], emb)
        with _PlainServing():
            ref = _prefill_last_logits(torch, dataclasses.replace(cfg0, attention_impl="xla"),
                                       model.params["lm"], emb)
        diff = (got_logits - ref)[: lm.vocab_size].abs().max().item()
        print(f"[{tag}]   prefill logits (fp32), kernels vs every kernel's plain version: "
              f"max|diff| {diff:.4e} (tol {LOGIT_TOL}; logit std {ref.std().item():.3f}), "
              f"argmax equal: {int(got_logits.argmax()) == int(ref.argmax())}")
        check(bool(torch.isfinite(got_logits).all()), f"{tag}: non-finite prefill logits")
        check(diff <= LOGIT_TOL, f"{tag} request {i}: prefill logits differ by {diff}")
    print(f"[{tag}] vision+prefix (preprocess_inputs of the 480x640 image and the prompt, CUDA "
          f"events, warm): {statistics.median(vision_ms):.2f} ms (median of 3)")
    return totals


def phase_towers(torch):
    """Phase 10: caption requests through the ViT-B/32 and the NF-ResNet50
    on the int8 serving path.  The second model shares the first's int8 LM
    (the same seed would draw the same LM) and draws its own tower.
    Returns the launches by wrapper."""
    from magma_tpu_torch.models import image_prefix as ip_mod
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel

    dev = torch.device("cuda")
    totals = dict.fromkeys(_all_wrappers(), 0)
    lm_params = None
    flash_attention_kernel.wgmma_launches = 0
    for name in TOWERS:
        t0 = time.perf_counter()
        cfg = _tower_config(name)
        if lm_params is None:
            model = Magma(cfg, seed=0, device=dev)
            model.quantize_for_serving(8)
            lm_params = model.params["lm"]
        else:
            model = Magma(cfg, device=dev, init_weights=False)
            g = torch.Generator(device=dev).manual_seed(0)
            ip_params, ip_stats = ip_mod.init_params(g, model.prefix_config, dev)
            model.params = {"lm": lm_params, "image_prefix": ip_params}
            model.state = {"image_prefix": ip_stats}
            model._fold_vision()  # quantize_for_serving's tower step; the LM is int8 already
        torch.cuda.synchronize()
        _, enc_cfg, pooled = model.prefix_config.encoder
        tag = f"tower {name}"
        print(f"[{tag}] Magma(v1, encoder_name={name!r}) + quantize_for_serving(8) in "
              f"{time.perf_counter() - t0:.1f} s: {enc_cfg}, pooled {pooled}, prefix "
              f"{model.image_prefix_seq_len} tokens, transform "
              f"{getattr(model.transforms, '__qualname__', type(model.transforms).__name__)}"
              + ("" if name == TOWERS[0] else "; it shares the ViT model's int8 LM instead of "
                 "drawing another 6B"))
        _tower_vs_cpu(torch, model, tag)
        launches = _tower_requests(torch, model, tag)
        for k in totals:
            totals[k] += launches[k]
        del model
    check(flash_attention_kernel.wgmma_launches == 0, "a tower prefill ran K1's wgmma body")
    del lm_params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


CLI_DIR = ROOT / "build" / "smoke_cli"


def _write_cli_data(root):
    """Seeded JPEGs at mixed sizes with two captions each (ImgCptDatasets:
    24 under train, 12 under train2), and 6 VQA and 6 GQA questions over 6
    more images each."""
    import json
    import shutil

    from PIL import Image

    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(0)
    sizes = [(480, 640), (640, 480), (384, 384), (300, 500)]
    for sub, n, qa in (("train", 24, False), ("train2", 12, False), ("vqa", 6, True),
                       ("gqa", 6, True)):
        for d in ("images/0", "image_data/0"):
            (root / sub / d).mkdir(parents=True)
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                root / sub / "images" / "0" / f"{i}.jpg", quality=90)
            rec = {"image_path": f"images/0/{i}.jpg",
                   "captions": [f"a painting of a scene number {i}", f"picture {i}"]}
            if qa:
                rec["metadata"] = {"question": f"what is shown in picture {i}?",
                                   "answers": ["painting", "painting", "scene"]}
            (root / sub / "image_data" / "0" / f"{i}.json").write_text(json.dumps(rec))


class _CallProbe:
    """Within the block, each call of the named methods of ``owner`` (a class
    or module) records the launches of every kernel it made (and K1's on the
    wgmma body) and its host-clock ms."""

    def __init__(self, owner, names):
        self.owner, self.names, self.calls = owner, names, []

    def __enter__(self):
        from magma_tpu_torch.ops.flash_attention import flash_attention_kernel

        wrappers = _all_wrappers()
        self.saved = {n: getattr(self.owner, n) for n in self.names}

        def probe(name, fn):
            @functools.wraps(fn)
            def wrapped(*a, **k):
                before = {w: f.launches for w, f in wrappers.items()}
                wg = flash_attention_kernel.wgmma_launches
                t0 = time.perf_counter()
                out = fn(*a, **k)
                ms = (time.perf_counter() - t0) * 1e3
                got = {w: f.launches - before[w] for w, f in wrappers.items()}
                got["k1_wgmma"] = flash_attention_kernel.wgmma_launches - wg
                self.calls.append((name, got, ms))
                return out
            return wrapped

        for n, fn in self.saved.items():
            setattr(self.owner, n, probe(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.owner, n, fn)


def _cli_yml(root, seq, run):
    """Run "v1": configs/MAGMA_v1.yml at full width and seq 2048, cut to a
    run of 4 steps of batch 4 (ga 2), eval every 2 over 1 batch, the eval
    set held out of the training directory, VQA over 6 questions, no
    checkpoint (a 6B checkpoint is ~12 GB plus the optimizer's state: the
    CPU test holds save and resume).  Run "v2": configs/MAGMA_v2.yml's
    shape, the same cut at its ga 4: two training directories, the eval set
    held out of both, VQA and GQA over 6 questions each."""
    import yaml

    from magma_tpu_torch.config import load_config

    v2 = run == "v2"
    raw = load_config(CONFIG_V2 if v2 else CONFIG)
    raw.update(batch_size=4, gradient_accumulation_steps=4 if v2 else 2, train_steps=4,
               log_every=1, eval_every=2, eval_steps=1, save=None, load=None, seq_len=seq,
               train_dataset_dir=([str(root / "train"), str(root / "train2")] if v2
                                  else str(root / "train")),
               eval_dataset_dir=None, eval_dataset_pct=0.25, vqa_dir=str(root / "vqa"),
               gqa_dir=str(root / "gqa") if v2 else None, num_workers=4, warmup_num_steps=1)
    path = root / f"cli_{run}.yml"
    path.write_text(yaml.safe_dump(raw))
    return path


def phase_cli(torch):
    """Phase 11: ``magma_tpu_torch.train.main`` in-process at full width from
    JPEGs on disk, on v1's yml and on v2's shape.  Returns the launches of
    both runs by wrapper (and K1's wgmma ones)."""
    import json

    from magma_tpu_torch import evaluation, native, train
    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel
    from magma_tpu_torch.training.train_loop import Trainer

    L, seq = 28, 2048
    _write_cli_data(CLI_DIR)
    decoder = "native" if native.available() else "PIL"
    print(f"[cli] decoder {decoder}" + ("" if decoder == "native" else
                                        f" (native build error: {native.build_error()})"))
    wrappers = _all_wrappers()
    totals = dict.fromkeys(wrappers, 0)
    totals["k1_wgmma"] = 0
    for run in ("v1", "v2"):
        tag, log_dir = f"cli {run}", CLI_DIR / f"log_{run}"
        yml = _cli_yml(CLI_DIR, seq, run)
        for fn in wrappers.values():
            fn.launches = 0  # count this run only
        flash_attention_kernel.wgmma_launches = 0
        t0 = time.perf_counter()
        with _CallProbe(Trainer, ("train_step", "eval_step", "inference_step")) as tp, \
                _CallProbe(evaluation, ("eval_vqa",)) as vp:
            trainer = train.main(["--config", str(yml), "--log-dir", str(log_dir)])
        wall = time.perf_counter() - t0
        for k, fn in wrappers.items():
            totals[k] += fn.launches
        totals["k1_wgmma"] += flash_attention_kernel.wgmma_launches
        check(trainer.global_step == 4, f"{tag}: {trainer.global_step} steps, expected 4")
        lm, cfg = trainer.model.lm_config, trainer.config
        adapters = [spec.downsample_factor for spec in (lm.mlp_adapter, lm.attn_adapter) if spec]
        check(lm.n_layers == L and lm.d_model == 4096 and trainer.model.seq_len == seq
              and adapters == ([8, 8] if run == "v2" else [4]), f"{tag}: not the recipe")
        ga = cfg.gradient_accumulation_steps
        print(f"[{tag}] adapters k {adapters}, ga {ga}, train_dataset_dir "
              f"{cfg.train_dataset_dir}, eval_dataset_dir {cfg.eval_dataset_dir}, vqa_dir "
              f"{cfg.vqa_dir}, gqa_dir {cfg.gqa_dir}")
        for name, got, ms in tp.calls + vp.calls:
            print(f"[{tag}] {name}: {ms:.1f} ms (host clock), launches "
                  + ", ".join(f"{k} {v}" for k, v in got.items() if v))
            if name == "train_step":
                want = {"flash_attention_kernel": 2 * L * ga,
                        "flash_attention_bwd_dkv_kernel": L * ga,
                        "flash_attention_bwd_dq_kernel": L * ga}
                want = {k: want.get(k, 0) for k in wrappers}
                check({k: got[k] for k in wrappers} == want,
                      f"{tag} train_step launches {got}, expected {want}")
                check(got["k1_wgmma"] == 2 * L * ga,
                      f"{tag}: a training K1 missed the wgmma body: {got}")
            else:  # each eval forward, caption prefill and VQA or GQA prefill: K1 once a layer
                n_fwd = cfg.eval_steps if name == "eval_step" else 1
                check(got["flash_attention_kernel"] == L * n_fwd,
                      f"{tag} {name}: {got['flash_attention_kernel']} K1 launches")
        metrics = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]

        def logged(key):
            return [m[key] for m in metrics if key in m]

        losses, step_s, waits = (logged("train/loss"), logged("train/step_time"),
                                 logged("train/loader_wait"))
        evals, captions = logged("eval/loss"), logged("inference/captions")
        accs = {qa: logged(f"eval/{qa}_accuracy") for qa in ("vqa", "gqa")}
        print(f"[{tag}] {len(losses)} train losses {losses}, eval losses {evals}, accuracies "
              f"{accs}, captions {captions[:1]}")
        check(len(losses) == 4 and all(np.isfinite(losses)), f"{tag}: train losses {losses}")
        check(len(evals) == 2 and all(np.isfinite(evals)), f"{tag}: eval losses {evals}")
        check(len(captions) == 2 and all("Caption 0" in c for c in captions),
              f"{tag}: no captions")
        for qa, want_n in (("vqa", 2), ("gqa", 2 if run == "v2" else 0)):
            check(len(accs[qa]) == want_n and all(0.0 <= a <= 1.0 for a in accs[qa]),
                  f"{tag}: {qa} accuracies {accs[qa]}")
        check(len(vp.calls) == 2 * len([a for a in accs.values() if a]),
              f"{tag}: {len(vp.calls)} eval_vqa calls")
        train_ms = [ms for name, _, ms in tp.calls if name == "train_step"]
        step_ms = statistics.median(step_s[1:]) * 1e3
        print(f"[{tag}] step {step_ms:.1f} ms a step (host clock, the loss read every step, "
              f"median of steps 2-4), {cfg.batch_size * seq / step_ms * 1e3:.0f} tokens/s, "
              f"loader wait {statistics.median(waits[1:]) * 1e3:.2f} ms a step (median of "
              f"steps 2-4; step 1 {waits[0] * 1e3:.1f} ms), train_step call "
              f"{statistics.median(train_ms):.1f} ms (median dispatch, sync=False), whole run "
              f"{wall:.1f} s, decoder {decoder}")
        if run == "v1":
            # one more step of the CLI's trainer, profiled, against the CLI's
            # step wall (its launches are not the main path's: counted before it)
            _profile_train_step(torch, trainer, _train_batch(torch, cfg, seq, 900), step_ms,
                                tag)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return totals


# phase 12, one micro-batch through the kernels against the plain path.
# The head's input, the ln_f state at the sample's last token (d_model
# values), is what K1 reaches: held as |f - f_plain|_2 / |f_plain|_2.  The
# LM's last-position logits are projections of the same kind of state; the
# two paths' differ by 0.074-0.095 at most over 50k logits at std 1.28
# (phases 4 and 10 on the H100), ~0.016-0.021 a logit (a max of 50k
# normal draws is ~4.6 of them), 1.3-1.6% of the std; so the state is
# expected ~1.5e-2 apart relative, and held at about 3 times that
CLS_FEAT_TOL = 5e-2
# its two logits through a seeded head of N(0, 1/d_model) weights, std ~1:
# each ~0.016 apart by the same estimate, the larger of two within ~3 times
# that (read 6.3e-3 on the H100)
CLS_LOGIT_TOL = 5e-2
# the cross-entropy moves by at most |p - onehot|_1 max|dlogit| <= 2
# max|dlogit|: the bound that CLS_LOGIT_TOL implies, so the logits and the
# state are the guard; the loss is held to show it comes from those logits
CLS_LOSS_TOL = 2 * CLS_LOGIT_TOL


def _nlvr2_batch(torch, cfg, seq, seed):
    """A seeded NLVR2-style batch on the card: two images a sample, captions
    of 64 random tokens then EOS padding, labels in {0, 1}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b, r = cfg.batch_size, cfg.image_size
    images = [torch.randn((b, 3, r, r), generator=g, device=dev) for _ in range(2)]
    caps = torch.full((b, seq), 50256, dtype=torch.long, device=dev)
    caps[:, :64] = torch.randint(0, 50000, (b, 64), generator=g, device=dev)
    labels = torch.randint(0, 2, (b,), generator=g, device=dev)
    return images, caps, labels


def phase_classifier(torch):
    """Phase 12: ``MagmaClassifier`` from configs/MAGMA_v1.yml with a 2-class
    head at full width: two ``train_step_classification`` steps (ga 2 x
    micro 1) on NLVR2-style batches, one ``eval_step_classification``, and
    one micro-batch's loss and logits through the kernels against the plain
    path.  Returns the launches by wrapper."""
    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.models.classifier import MagmaClassifier
    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel
    from magma_tpu_torch.training.train_loop import Trainer

    cfg = MultimodalConfig.from_yml(CONFIG)
    cfg.class_dict = {"num_classes": 2}
    cfg.batch_size, cfg.gradient_accumulation_steps, cfg.warmup_num_steps = 2, 2, 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = MagmaClassifier(cfg, seed=0, device=dev)
    trainer = Trainer(model, cfg)
    torch.cuda.synchronize()
    lm = model.lm_config
    L, seq, ga = lm.n_layers, model.seq_len, cfg.gradient_accumulation_steps
    print(f"[classifier] MagmaClassifier(v1, 2 classes, {model.interface_type}) + Trainer in "
          f"{time.perf_counter() - t0:.1f} s: {L} layers, d_model {lm.d_model}, seq {seq}, "
          f"ga {ga} x micro {cfg.batch_size // ga}, two images a sample "
          f"({2 * model.image_prefix_seq_len} prefix tokens)")
    wrappers = _all_wrappers()
    totals = dict.fromkeys(wrappers, 0)
    totals["k1_wgmma"] = 0
    want_step = {"flash_attention_kernel": 2 * L * ga, "flash_attention_bwd_dkv_kernel": L * ga,
                 "flash_attention_bwd_dq_kernel": L * ga}
    for step in range(3):
        images, caps, labels = _nlvr2_batch(torch, cfg, seq, 600 + step)
        for fn in wrappers.values():
            fn.launches = 0
        flash_attention_kernel.wgmma_launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if step < 2:
            loss, acc = trainer.train_step_classification(images, caps, labels)
            want = {k: want_step.get(k, 0) for k in wrappers}
            what = f"train step {step + 1}"
        else:
            loss, acc = trainer.eval_step_classification(images, caps, labels)
            want = {k: L if k == "flash_attention_kernel" else 0 for k in wrappers}
            what = "eval step"
        end.record()
        end.synchronize()
        got = {k: fn.launches for k, fn in wrappers.items()}
        print(f"[classifier] {what}: loss {loss:.6f}, accuracy {acc:.2f}, "
              f"{start.elapsed_time(end):.1f} ms, launches "
              + ", ".join(f"{k} {v}" for k, v in got.items() if v)
              + f" (K1 on the wgmma body {flash_attention_kernel.wgmma_launches})")
        check(np.isfinite(loss), f"classifier {what}: non-finite loss")
        check(got == want, f"classifier {what}: launches {got}, expected {want}")
        check(flash_attention_kernel.wgmma_launches == got["flash_attention_kernel"],
              f"classifier {what}: a K1 launch missed the wgmma body")
        for k in wrappers:
            totals[k] += got[k]
        totals["k1_wgmma"] += flash_attention_kernel.wgmma_launches

    # one micro-batch, train=False, through the kernels and the plain path,
    # over a head drawn from a seed (the trained head is near zero, its
    # logits too small to compare), then over the identity, whose "logits"
    # are the head's input
    images, caps, labels = _nlvr2_batch(torch, cfg, seq, 700)
    g = torch.Generator(device=dev).manual_seed(5)
    heads = {"class": {"kernel": torch.randn((lm.d_model, 2), generator=g, device=dev)
                       * lm.d_model ** -0.5, "bias": torch.zeros(2, device=dev)},
             "state": {"kernel": torch.eye(lm.d_model, device=dev),
                       "bias": torch.zeros(lm.d_model, device=dev)}}
    out = {}
    with torch.no_grad():
        for path, lm_cfg in (("kernel", lm), ("plain", dataclasses.replace(lm, attention_impl="xla"))):
            model.lm_config = lm_cfg
            for head, w in heads.items():
                loss, (_, logits) = model.classification_loss_fn(
                    dict(trainer.params, class_head=w), trainer.state, [i[:1] for i in images],
                    caps[:1], labels[:1], train=False)
                out[path, head] = (loss.item(), logits.float())
    model.lm_config = lm
    (lk, gk), (lp, gp) = out["kernel", "class"], out["plain", "class"]
    fk, fp = out["kernel", "state"][1], out["plain", "state"][1]
    diff = (gk - gp).abs().max().item()
    dloss = abs(lk - lp)
    dfeat = ((fk - fp).norm() / fp.norm()).item()
    print(f"[classifier] one micro-batch, kernels vs plain path: the head's input "
          f"({fk.shape[-1]} values, std {fp.std().item():.3f}) |diff|_2 / |plain|_2 {dfeat:.4e} "
          f"(tol {CLS_FEAT_TOL}); logits {gk.tolist()} vs {gp.tolist()} (max|diff| {diff:.4e}, "
          f"tol {CLS_LOGIT_TOL}); loss {lk:.6f} vs {lp:.6f} (|diff| {dloss:.4e}, tol {CLS_LOSS_TOL})")
    check(bool(torch.isfinite(fk).all()), "classifier: non-finite hidden state")
    check(dfeat <= CLS_FEAT_TOL, f"classifier: the head's input differs from the plain path's by {dfeat}")
    check(diff <= CLS_LOGIT_TOL, f"classifier: logits differ from the plain path's by {diff}")
    check(dloss <= CLS_LOSS_TOL, f"classifier: loss differs from the plain path's by {dloss}")
    del trainer, model, heads
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# Phase 13: parallelism over torch.distributed, on the one card
# ---------------------------------------------------------------------------

# a spawn's ranks are killed after this many seconds (the probes' sooner)
PAR_DEADLINE_S, PAR_PROBE_S = 600, 60
PAR_OPS = ("all_reduce_sum", "all_reduce_max", "broadcast", "all_gather", "send_recv")
# the collectives each path calls: it runs at two ranks where gloo carries
# them on CUDA tensors, else at world 1 on NCCL, through the same code
PAR_NEEDS = {"tp": {"all_reduce_sum", "broadcast", "all_gather"},
             "sp": {"all_reduce_sum", "all_reduce_max", "broadcast"},
             "dp": {"all_reduce_sum"},
             "ring": {"send_recv"}}
# tp 2 against one process over the same int8 layout: the row-parallel
# partial sums add in fp32 in another order before their one bf16 rounding,
# and K2b's K/2 tiles accumulate in another order: far inside phase 5's
# int8 tolerance, which is held
PAR_LOGIT_TOL = INT8_LOGIT_TOL
PAR_TRAIN_STEPS = 2
# dp against one process doing the ranks' arithmetic (``_loss_in_shares``):
# the losses, the first step's gradient at phase 9's TRAIN_GRAD_TOL, and
# the updated trainables in the CPU test's form: in each group this many of
# the elements within PAR_UPDATE_LR of the learning rate of one process's
PAR_UPDATE_LR, PAR_UPDATE_SHARE = 0.05, 0.98


def _seeded(torch, seed, key, shape, dev):
    """N(0, 0.02) bf16 of ``shape`` from a generator of its own, seeded by
    (seed, key): any rank draws any piece of the tree without drawing the
    rest."""
    import zlib

    g = torch.Generator(device=dev).manual_seed(zlib.crc32(f"{seed}/{key}".encode()))
    return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02)


def _tp_model(torch, mesh, seed=0):
    """MAGMA v1 at full width in the tensor-parallel int8 serving layout
    (``quantize_lm_params(fuse_in_proj=False)``'s), built one layer at a
    time: each projection of each layer drawn from its own seeded generator
    (``_seeded``), quantized whole, and only this rank's shard kept, so no
    rank holds the bf16 tree.  ``mesh`` None: the whole tree (the one-process
    reference, the same weights).  The vision tower BN-folded, as serving
    takes it."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.models import image_prefix as ip_mod
    from magma_tpu_torch.models.adapters import init_adapter
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.ops.quant import quantize_int8
    from magma_tpu_torch.parallel import sharding

    dev = torch.device("cuda")
    model = Magma(CONFIG, device=dev, init_weights=False)
    cfg = model.lm_config
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    tp = 1 if mesh is None else mesh.size("tp")

    def shard(path, t):
        if mesh is None:
            return t
        return sharding.shard_tensor(t, sharding.lm_param_spec(f"lm/{path}", t.dim()), mesh)

    shapes = {"attn/q": (D, D), "attn/k": (D, D), "attn/v": (D, D), "attn/o": (D, D),
              "mlp/fc_in/kernel": (D, F_), "mlp/fc_out/kernel": (F_, D)}
    parts = {}
    for layer in range(L):
        for path, shape in shapes.items():
            pack = quantize_int8(_seeded(torch, seed, f"{path}/{layer}", shape, dev), compiled=True)
            for k, t in pack.items():
                parts.setdefault((path, k), []).append(shard(f"blocks/{path}/{k}", t[None]))
            del pack
    blocks = {"attn": {}, "mlp": {"fc_in": {}, "fc_out": {}}}
    for (path, k), ts in parts.items():
        node = blocks
        for key in path.split("/")[:-1]:
            node = node[key]
        node.setdefault(path.split("/")[-1], {})[k] = torch.cat(ts)
    del parts
    wte = _seeded(torch, seed, "wte", (cfg.padded_vocab_size, D), dev)
    wte[V:] = 0
    head = quantize_int8(wte.float().T, compiled=True)
    top = {"wte": wte, "lm_head_q": head}
    if mesh is not None:
        top = sharding.shard_lm_params(mesh, top)
    del wte, head
    zeros = lambda *s: torch.zeros(s, device=dev, dtype=cfg.param_dtype)  # noqa: E731
    ones = lambda *s: torch.ones(s, device=dev, dtype=cfg.param_dtype)  # noqa: E731
    blocks["ln_1"] = {"scale": ones(L, D), "bias": zeros(L, D)}
    blocks["attn"]["o_bias"] = zeros(L, D)
    blocks["mlp"]["fc_in"]["bias"] = zeros(L, F_ // tp)
    blocks["mlp"]["fc_out"]["bias"] = zeros(L, D)
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks["adapter_mlp"] = init_adapter(g, cfg.mlp_adapter, D, L, cfg.adapter_param_dtype, dev)
    lm = {**top, "blocks": blocks, "ln_f": {"scale": ones(D), "bias": zeros(D)}}
    ip_params, ip_stats = ip_mod.init_params(g, model.prefix_config, dev)
    model.params = {"lm": gptj._serving_cast_adapters(lm, mode="bf16"),
                    "image_prefix": ip_params}
    model.state = {"image_prefix": ip_stats}
    model._fold_vision()
    return model


def _par_want(L, steps):
    """Exact launches of one request of ``steps`` tokens over the
    tensor-parallel int8 layout on every rank: K1 once a layer in the
    prefill, K2b for each of the six projections a layer in every forward,
    K2a once a forward (the padded head shard); no fused decode."""
    want = {"flash_attention_kernel": L, "int8_matmul_stacked_kernel": 6 * L * steps,
            "int8_matmul_kernel": steps}
    return {k: want.get(k, 0) for k in _all_wrappers()}


def _long_prompt(torch, model):
    """Phase 5c's eight-image prompt (1,216 positions), one row."""
    imgs = [model.preprocess_inputs([_image(200 + j)]) for j in range(LONG_IMAGES)]
    return torch.cat(imgs + [model.preprocess_inputs([PROMPT])], dim=1)


def _forced_logits(torch, cfg, lm, emb, tokens, mesh=None):
    """fp32 logits of a cached prefill over ``emb`` (at its last position),
    then of one decode step for each of ``tokens`` but the last, fed those
    tokens (teacher-forced): (len(tokens), padded vocab) on the CPU.  Over
    ``mesh``: this rank's shards and cache."""
    from magma_tpu_torch.models import gptj

    s, n = emb.shape[1], len(tokens)
    cache = gptj.init_kv_cache(cfg, 1, -(-(s + n) // 64) * 64, device=emb.device, mesh=mesh)
    hidden, cache = gptj.forward(cfg, lm, emb, cache=cache, cache_index=0, return_hidden=True,
                                 mesh=mesh)
    out = [gptj.lm_head(cfg, lm, hidden[:, -1:], mesh)[0, 0]]
    toks = torch.as_tensor(np.asarray(tokens), device=emb.device).reshape(1, -1)
    for i in range(n - 1):
        emb_t = gptj.embed_tokens(cfg, lm, toks[:, i:i + 1], mesh)
        logits, cache = gptj.forward(cfg, lm, emb_t, cache=cache, cache_index=s + i, mesh=mesh)
        out.append(logits[0, -1])
    return torch.stack(out).cpu()


def _greedy_agreement(torch, tag, got, ref, vocab, tol):
    """Teacher-forced logits of a parallel path against one process's on
    the same tokens: the largest distance (within ``tol``), and the greedy
    choice equal wherever one process's top two logits lie further apart
    than twice the two paths' distance there (a closer pair is a tie the
    rounding of a sum decides).  Returns the largest distance."""
    got, ref = got[:, :vocab], ref[:, :vocab]
    d = (got - ref).abs().amax(-1)
    top2 = ref.topk(2, -1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * d
    same = got.argmax(-1) == ref.argmax(-1)
    first = int((~decided).nonzero()[0]) if (~decided).any() else None
    print(f"[{tag}] teacher-forced logits over {len(d)} positions against one process: max|diff| "
          f"{d.max().item():.4e} (prefill {d[0].item():.4e}; tol {tol}), greedy choice equal "
          f"at {int(same.sum())} of {len(d)}, decided at {int(decided.sum())} (first near-tie: "
          f"position {first}), every decided one equal: {bool(same[decided].all())}")
    check(d.max().item() <= tol, f"{tag}: logits {d.max().item()} from one process's")
    check(bool(same[decided].all()), f"{tag}: a greedy choice differs where the logits do not tie")
    return d.max().item()


def _print_prefix(tag, got, ref):
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    n = len(got) if (got == ref).all() else int(np.argmax(got != ref))
    print(f"[{tag}] free-running greedy tokens equal one process's for {n} of {len(ref)}")


def _par_reference_serving(torch, work):
    """One process over the same tensor-parallel int8 layout: the greedy
    request's and the eight-image prompt's greedy tokens, and their
    teacher-forced logits."""
    from magma_tpu_torch.ops.sampling import generate_tokens

    t0 = time.perf_counter()
    model = _tp_model(torch, None)
    cfg, lm = model.lm_config, model.params["lm"]
    emb = model.preprocess_inputs([_image(), PROMPT])
    timing = {}
    tokens = model.generate(emb, max_steps=MAX_STEPS, temperature=0.0, decode=False,
                            timing=timing)
    long = _long_prompt(torch, model)
    long_t = {}
    long_tokens, _ = generate_tokens(cfg, lm, long, max_steps=MAX_STEPS, temperature=0.0,
                                     top_k=0, top_p=0.0, eos_token=model.eos_token,
                                     timing=long_t)
    steps = timing["steps"]
    print(f"[parallel] one-process reference (tensor-parallel int8 layout, built layer by "
          f"layer from the seed in {time.perf_counter() - t0:.1f} s): greedy {steps} tokens, "
          f"decode {timing['decode_ms'] / max(steps - 1, 1):.2f} ms/token; eight-image prompt "
          f"{tuple(long.shape)}: decode {long_t['decode_ms'] / MAX_STEPS:.2f} ms/step")
    torch.save({"tokens": tokens, "forced": _forced_logits(torch, cfg, lm, emb, tokens[0]),
                "long_tokens": long_tokens.cpu(),
                "long_forced": _forced_logits(torch, cfg, lm, long, long_tokens[0].cpu())},
               work / "ref_serving.pt")
    del model


def _par_train_config():
    """Path A (v1: the bf16 RN50x16 trainable, batch statistics) without
    ImagePrefix dropout: a rank draws its mask over its share, one process
    over the batch, so the bits cannot agree."""
    cfg = _train_config("A")
    cfg.image_embed_dropout_prob = 0.0
    return cfg


def _par_reference_training(torch, work, shares):
    """One process taking path A's global batches as ``shares`` ranks of dp
    compute them (``_loss_in_shares``): losses, the first step's gradient
    and each parameter group's update after PAR_TRAIN_STEPS steps.  First,
    one micro-batch's gradient the usual way and the ranks' way, whose
    distance is the batch shapes' alone (``scripts/torch_dp_witness.py``:
    the randomly initialised tower amplifies a change of a rounding's size
    in its input or statistics to one of order 1 in bf16)."""
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.training.train_loop import Trainer

    cfg = _par_train_config()
    model = Magma(cfg, seed=0, device=torch.device("cuda"))
    trainer = Trainer(model, cfg)
    images, captions = _train_batch(torch, cfg, model.seq_len, 100)
    micro = cfg.batch_size // cfg.gradient_accumulation_steps
    _, g_one = _group_grads(torch, trainer, images[:micro], captions[:micro], 7)
    model.loss_fn = functools.partial(_loss_in_shares, torch, model, shares)
    _, g_ranks = _group_grads(torch, trainer, images[:micro], captions[:micro], 7)
    shapes = {k: ((g_ranks[k] - g).norm() / g.norm()).item() for k, g in g_one.items()}
    grads = _record_first_grads(torch, trainer)
    before = _par_groups(torch, trainer.trainable, trainer)
    losses = [trainer.train_step(*_train_batch(torch, cfg, model.seq_len, 100 + i))
              for i in range(PAR_TRAIN_STEPS)]
    after = _par_groups(torch, trainer.trainable, trainer)
    print(f"[parallel] one-process reference, path A in {shares} shares: losses {losses}; one "
          f"micro-batch's gradient in shares vs whole |g - g1| / |g1| by group "
          f"{ {k: f'{v:.2e}' for k, v in shapes.items()} } (the batch shapes alone, not held)")
    torch.save({"losses": losses, "grads": {k: v.bfloat16().cpu() for k, v in grads.items()},
                "delta": {k: (after[k] - v).bfloat16().cpu() for k, v in before.items()}},
               work / "ref_training.pt")
    del trainer, model, before, after, grads, g_one, g_ranks


def _prefix_in_shares(torch, model, params, state, images, shares, *, train=True,
                      generator=None):
    """``image_prefix.apply`` as ``shares`` ranks of dp compute it between
    them, in one process: each equal contiguous share of the batch
    (``sharding.shard_batch``) runs the rank's own code in a thread of its
    own, the tower's dp BatchNorm included; where the ranks' all_reduce
    joins them (``mesh.sum_both``) the threads meet, and each takes the sum
    of the shares' terms through a node whose gradient each share receives
    whole, as the all_reduce of the ranks' gradients gives it (two terms
    add to the same bits in either order).  Returns (embeddings, new
    state)."""
    import threading

    from magma_tpu_torch.models import image_prefix as ip_mod
    from magma_tpu_torch.parallel import mesh as mesh_mod

    class ShareSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *parts):
            return functools.reduce(torch.add, parts)

        @staticmethod
        def backward(ctx, g):
            return (g,) * shares

    class Shares:  # what the tower asks of its mesh
        def size(self, axes):
            return shares

    barrier, slots, local = threading.Barrier(shares), [None] * shares, threading.local()

    def sum_both(x, mesh, axes):
        slots[local.i] = x
        barrier.wait()
        parts = list(slots)
        barrier.wait()  # every share has read the slots before they are reused
        return ShareSum.apply(*parts)

    out, errors = [None] * shares, []

    def run(i, img):
        local.i = i
        try:
            out[i] = ip_mod.apply(params["image_prefix"], state["image_prefix"], img,
                                  model.prefix_config, train=train, generator=generator,
                                  mesh=Shares())
        except BaseException as e:  # noqa: BLE001  (raised below, after the join)
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i, img))
               for i, img in enumerate(images.chunk(shares))]
    saved, mesh_mod.sum_both = mesh_mod.sum_both, sum_both
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        mesh_mod.sum_both = saved
    if errors:
        raise errors[0]
    return torch.cat([o[0] for o in out]), {"image_prefix": out[0][1]}


def _lm_loss(torch, model, params, state, e, captions, shares=1):
    """The LM's loss on the image prefix's output ``e``, one call a share of
    the batch (as ranks of dp holding a share each run it), the shares' mean
    losses weighted by their part of the valid positions (so the sum is the
    batch's mean)."""
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.training.labels import IGNORE, build_labels

    def loss(e, captions):  # the class's loss_fn: an instance may have patched its own
        return Magma.loss_fn(model, params, state, None, captions, input_embeddings=e)[0]

    if shares == 1:
        return loss(e, captions)
    valid = (build_labels(e.shape[1], captions, model.eos_token)[:, 1:] != IGNORE).sum(1)
    part = [v.sum() / valid.sum() for v in valid.chunk(shares)]
    return sum(loss(q, c) * w for q, c, w in zip(e.chunk(shares), captions.chunk(shares), part))


def _loss_in_shares(torch, model, shares, params, state, images, captions, *, train=True,
                    generator=None):
    """``Magma.loss_fn`` (no dropout) as ``shares`` ranks of dp compute it
    between them, in one process: ``_prefix_in_shares``, then the LM a share
    a call (``_lm_loss``)."""
    emb, new_state = _prefix_in_shares(torch, model, params, state, images, shares, train=train,
                                       generator=generator)
    return _lm_loss(torch, model, params, state, emb, captions, shares), (new_state, None)


def _par_groups(torch, named, trainer):
    """Flat fp32 tensors by parameter group of ``named`` ((path, tensor) in
    the trainer's order)."""
    from magma_tpu_torch.training.optim import label_params
    from magma_tpu_torch.utils import tree_items

    labels = dict(tree_items(label_params(trainer.params)))
    groups = {}
    for path, t in named:
        groups.setdefault(labels[path], []).append(t.detach().float().reshape(-1))
    return {k: torch.cat(v) for k, v in groups.items()}


def _record_first_grads(torch, trainer):
    """The gradients the trainer's first step hands AdamW (at dp > 1 the
    global mean over the ranks), by group: filled in by that step."""
    store, step = {}, trainer.optimizer.step

    def spy(grads):
        if not store:
            store.update(_par_groups(torch, [(p, g) for (p, _), g in
                                             zip(trainer.trainable, grads)], trainer))
        return step(grads)

    trainer.optimizer.step = spy
    return store


def _par_launches(wrappers):
    return {k: fn.launches for k, fn in wrappers.items()}


def _par_tp(torch, world, work):
    """(a) Phase 5's three requests through ``Magma.generate`` over a tp =
    world mesh, each rank holding its shards: exact launches; then the
    greedy request's teacher-forced logits against one process's."""
    from magma_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, world)
    t0 = time.perf_counter()
    model = _tp_model(torch, mesh)
    model.mesh = mesh
    cfg, L = model.lm_config, model.lm_config.n_layers
    tag = f"parallel tp {world} rank {mesh.rank}"
    print(f"[{tag}] shards built in {time.perf_counter() - t0:.1f} s: q "
          f"{tuple(model.params['lm']['blocks']['attn']['q']['q'].shape)}, head "
          f"{tuple(model.params['lm']['lm_head_q']['q'].shape)}, "
          f"{nbytes(*_leaves(model.params['lm'])) / 1e9:.2f} GB of LM a rank")
    wrappers = _all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0  # count this path only
    greedy = None
    for i, (name, kw) in enumerate(_requests()):
        before = _par_launches(wrappers)
        emb, tokens, steps = _run_request(torch, model, i, name, kw, tag)
        got = {k: v - before[k] for k, v in _par_launches(wrappers).items()}
        check(got == _par_want(L, steps), f"{tag} request {i}: launches {got}, expected "
              f"{_par_want(L, steps)}")
        greedy = greedy or (emb, tokens)
    launches = _par_launches(wrappers)  # the checks below are not the path's
    ref = torch.load(work / "ref_serving.pt", weights_only=False)
    _print_prefix(tag, greedy[1], ref["tokens"])
    forced = _forced_logits(torch, cfg, model.params["lm"], greedy[0], ref["tokens"][0], mesh)
    diff = _greedy_agreement(torch, tag, forced, ref["forced"], cfg.vocab_size, PAR_LOGIT_TOL)
    del model
    return {"launches": launches, "logit_diff": diff}


def _par_sp(torch, world, work):
    """(b) Greedy generate over the eight-image prompt with the cache's
    positions sharded over sp = world (``attention_impl="ring"``): exact
    launches; then its teacher-forced decode logits against the unsharded
    cache's in one process."""
    from magma_tpu_torch.ops.sampling import generate_tokens
    from magma_tpu_torch.parallel.mesh import mesh_from_layout

    mesh = mesh_from_layout(np.arange(world).reshape(1, 1, world), ("dp", "tp", "sp"))
    model = _tp_model(torch, None)
    cfg = dataclasses.replace(model.lm_config, attention_impl="ring")
    L = cfg.n_layers
    long = _long_prompt(torch, model)
    tag = f"parallel sp {world} rank {mesh.rank}"
    wrappers = _all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0  # count this path only
    timing = {}
    tokens, steps = generate_tokens(cfg, model.params["lm"], long, max_steps=MAX_STEPS,
                                    temperature=0.0, top_k=0, top_p=0.0,
                                    eos_token=model.eos_token, timing=timing, mesh=mesh)
    got = _par_launches(wrappers)
    print(f"[{tag}] {tuple(long.shape)} prompt, cache positions a rank "
          f"{-(-(long.shape[1] + MAX_STEPS) // 64) * 64 // world}: {steps} steps, prefill "
          f"{timing['prefill_ms']:.1f} ms, decode {timing['decode_ms'] / steps:.2f} ms/step; "
          f"launches {got}")
    check(got == _par_want(L, steps), f"{tag}: launches {got}, expected {_par_want(L, steps)}")
    ref = torch.load(work / "ref_serving.pt", weights_only=False)
    _print_prefix(tag, tokens.cpu(), ref["long_tokens"])
    forced = _forced_logits(torch, cfg, model.params["lm"], long, ref["long_tokens"][0], mesh)
    diff = _greedy_agreement(torch, tag, forced, ref["long_forced"], cfg.vocab_size,
                             PAR_LOGIT_TOL)
    del model
    return {"launches": got, "decode_ms": timing["decode_ms"] / steps, "logit_diff": diff}


def _rank_share(torch, trainer, t):
    """This rank's "dp" share of each micro-batch of a global batch (B,
    ...), flat (B / dp, ...): what the multi-process loader hands a rank."""
    from magma_tpu_torch.parallel.sharding import shard_batch

    ga = trainer.config.gradient_accumulation_steps
    t = shard_batch(t.reshape(ga, -1, *t.shape[1:]), trainer.mesh, 1)
    return t.reshape(-1, *t.shape[2:])


def _par_dp(torch, world, work):
    """(c) Path A at dp = world, each rank given its share of the global
    batch: exact launches; the losses, the first step's gradient (the
    global mean the ranks sum) and the updated parameters against one
    process computing the ranks' arithmetic; the replicas equal."""
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.parallel.mesh import make_mesh
    from magma_tpu_torch.training.train_loop import Trainer

    mesh = make_mesh(world, 1)
    cfg = _par_train_config()
    model = Magma(cfg, seed=0, device=torch.device("cuda"))
    trainer = Trainer(model, cfg, mesh=mesh)
    L, seq, ga = model.lm_config.n_layers, model.seq_len, cfg.gradient_accumulation_steps
    tag = f"parallel dp {world} rank {mesh.rank}"
    want = _want_train_launches("A", L, -(-(seq - 1) // 256), ga)
    grads = _record_first_grads(torch, trainer)
    before = _par_groups(torch, trainer.trainable, trainer)
    wrappers = _all_wrappers()
    totals = dict.fromkeys(wrappers, 0)
    losses, times = [], []
    for step in range(PAR_TRAIN_STEPS):
        batch = [_rank_share(torch, trainer, t) for t in _train_batch(torch, cfg, seq, 100 + step)]
        for fn in wrappers.values():
            fn.launches = 0  # count this step only
        t0 = time.perf_counter()
        losses.append(trainer.train_step(*batch))
        times.append((time.perf_counter() - t0) * 1e3)
        got = _par_launches(wrappers)
        check(got == want, f"{tag} step {step + 1}: launches {got}, expected {want}")
        for k in wrappers:
            totals[k] += got[k]
    ref = torch.load(work / "ref_training.pt", weights_only=False)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    # both rounded to bf16, as the reference keeps them
    g_rel = {k: ((grads[k].bfloat16().cpu().float() - g.float()).norm() / g.float().norm()).item()
             for k, g in ref["grads"].items()}
    after = _par_groups(torch, trainer.trainable, trainer)
    # each group's share of elements whose update is within PAR_UPDATE_LR of
    # its learning rate of one process's, and the largest distance in lr
    err = {k: ((after[k] - before[k]).cpu() - d.float()).abs()
           / (cfg.image_enc_lr if k.startswith("img_enc") else cfg.lr)
           for k, d in ref["delta"].items()}
    near = {k: (e <= PAR_UPDATE_LR).float().mean().item() for k, e in err.items()}
    print(f"[{tag}] losses {losses} (one process in {world} shares {ref['losses']}, max rel "
          f"{loss_rel:.2e}, tol {TRAIN_LOSS_TOL}); step 1's gradient vs one process "
          f"|g - g1| / |g1| by group {({k: f'{v:.2e}' for k, v in g_rel.items()})} (tol "
          f"{TRAIN_GRAD_TOL}); updated params within {PAR_UPDATE_LR} lr of one process's, "
          f"share by group {({k: f'{v:.5f}' for k, v in near.items()})} (at least "
          f"{PAR_UPDATE_SHARE}; the largest distance "
          f"{({k: f'{e.max().item():.3f}' for k, e in err.items()})} lr); step wall "
          f"{[f'{t:.1f}' for t in times]} ms (host clock, {world} ranks on one card)")
    check(loss_rel <= TRAIN_LOSS_TOL, f"{tag}: losses {losses} vs {ref['losses']}")
    check(all(v <= TRAIN_GRAD_TOL for v in g_rel.values()), f"{tag}: gradients differ: {g_rel}")
    check(all(v >= PAR_UPDATE_SHARE for v in near.values()), f"{tag}: updates: {near}")
    sums = _checksums(torch, [t for _, t in trainer.trainable])
    del trainer, model, before, after, grads
    return {"launches": totals, "checksums": sums, "step_ms": times}


def _par_ring(torch, world, work):
    """(d) One path A step with ``attention_impl="ring"`` over sp = world:
    exact launches (K1 through the ring's steps, K9a and K9b in its
    backward), then one micro-batch's loss and gradients against the flash
    path on the same parameters."""
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.parallel.mesh import mesh_from_layout
    from magma_tpu_torch.training.train_loop import Trainer

    mesh = mesh_from_layout(np.arange(world).reshape(1, 1, world), ("dp", "tp", "sp"))
    cfg = _train_config("A")
    cfg.attention_impl = "ring"
    model = Magma(cfg, seed=0, device=torch.device("cuda"))
    trainer = Trainer(model, cfg, mesh=mesh)
    L, seq, ga = model.lm_config.n_layers, model.seq_len, cfg.gradient_accumulation_steps
    tag = f"parallel ring sp {world} rank {mesh.rank}"
    check(model.lm_config.attention_impl == "ring" and model.mesh is mesh, f"{tag}: no ring")
    # the ring's steps: n forward, n - 1 of them past blocks; at sp n each rank
    # launches K1 for its live blocks (all but the future ones)
    live = mesh.axis_index("sp") + 1
    want = {"flash_attention_kernel": 2 * L * live, "flash_attention_bwd_dkv_kernel": L * live,
            "flash_attention_bwd_dq_kernel": L * live}
    want = {k: ga * want.get(k, 0) for k in _all_wrappers()}
    wrappers = _all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0  # count this path only
    loss = trainer.train_step(*_train_batch(torch, cfg, seq, 100))
    got = _par_launches(wrappers)
    print(f"[{tag}] step loss {loss:.6f}, launches {got}")
    check(np.isfinite(loss) and got == want, f"{tag}: launches {got}, expected {want}")
    images, captions = _train_batch(torch, cfg, seq, 200)
    micro = (images[:cfg.batch_size // ga], captions[:cfg.batch_size // ga])
    ring_loss, ring_g = _group_grads(torch, trainer, *micro, 7)
    model.lm_config = dataclasses.replace(model.lm_config, attention_impl="flash")
    model.mesh = None
    flash_loss, flash_g = _group_grads(torch, trainer, *micro, 7)
    rel = {k: ((ring_g[k] - flash_g[k]).norm() / flash_g[k].norm()).item() for k in flash_g}
    bits = all(torch.equal(ring_g[k], flash_g[k]) for k in flash_g)
    loss_rel = abs(ring_loss - flash_loss) / abs(flash_loss)
    print(f"[{tag}] one micro-batch, ring vs flash path: loss {ring_loss:.6f} vs "
          f"{flash_loss:.6f} (rel {loss_rel:.2e}), gradients |g - g_flash| / |g_flash| "
          f"{ {k: f'{v:.2e}' for k, v in rel.items()} }, bit-identical: {bits}")
    if world == 1:
        print(f"[{tag}] at world 1 the ring makes no send/recv, no dK/dV hop and no lse merge, "
              f"so this agreement holds by construction: the merge on the card is held by "
              f"tests/test_torch_cuda.py test_ring_step_merge_matches_flash, the rotation by "
              f"the CPU tests at sp 2 and 4")
    check(loss_rel <= TRAIN_LOSS_TOL and all(v <= TRAIN_GRAD_TOL for v in rel.values()),
          f"{tag}: ring and flash paths disagree")
    del trainer, model, ring_g, flash_g
    return {"launches": got}


PAR_PATHS = {"tp": _par_tp, "sp": _par_sp, "dp": _par_dp, "ring": _par_ring}


def _par_probe(torch, world, work):
    """Each collective of PAR_OPS on CUDA tensors of the one card, with its
    result checked: "ok" or the error's first line."""
    import torch.distributed as dist

    rank, dev = dist.get_rank(), torch.device("cuda")
    peer = (rank + 1) % world

    def all_reduce(op, want):
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t, op=op)
        return bool((t == want).all())

    def broadcast():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.broadcast(t, src=0)
        return bool((t == 1).all())

    def all_gather():
        out = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(out, torch.full((4,), float(rank), device=dev))
        return bool((out == torch.arange(world, device=dev).repeat_interleave(4)).all())

    def send_recv():
        t, r = torch.full((4,), float(rank), device=dev), torch.empty(4, device=dev)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                           dist.P2POp(dist.irecv, r, (rank - 1) % world)]):
            req.wait()
        return bool((r == (rank - 1) % world).all())

    tests = {"all_reduce_sum": lambda: all_reduce(dist.ReduceOp.SUM, world * (world + 1) / 2),
             "all_reduce_max": lambda: all_reduce(dist.ReduceOp.MAX, world),
             "broadcast": broadcast, "all_gather": all_gather, "send_recv": send_recv}
    out = {}
    for name in PAR_OPS:
        try:
            ok = tests[name]()
            torch.cuda.synchronize()
            out[name] = "ok" if ok else "wrong result"
        except Exception as e:  # recorded: the probe's finding, not a failure
            out[name] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:160]}"
        # kept as it goes: a collective the backend lacks may end the process
        torch.save(out, work / f"probe_{dist.get_backend()}.{rank}.pt")
    return out


def _par_worker(rank, world, port, backend, names, work):
    """One rank: initialise torch.distributed (two ranks on the one card
    share device 0; world 1 goes through ``utils.init_distributed``), run
    the named paths, save each result for the parent."""
    import os

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    if world == 1 and backend == "nccl":
        from magma_tpu_torch.utils import init_distributed

        check(init_distributed("cuda") == (0, 0, 1), "init_distributed at world 1")
    else:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
    check(dist.get_backend() == backend, f"backend {dist.get_backend()} != {backend}")
    for name in names:
        fn = _par_probe if name == "probe" else PAR_PATHS[name]
        out = fn(torch, world, work)
        torch.save(out, work / f"{name}.{rank}.pt")
        gc.collect()
        torch.cuda.empty_cache()
    if backend == "nccl" and world > 1:
        os._exit(0)  # the probe's failed NCCL world: no teardown to wait on
    dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _par_spawn(torch, world, backend, names, work, deadline):
    """Run ``names`` in ``world`` spawned ranks; returns (per-rank results of
    each name, None) or (None, why it ended).  Every rank is stopped by the
    deadline; a rank's failure ends the others."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(_par_worker, args=(world, _free_port(), backend, names, str(work)),
                             nprocs=world, join=False, start_method="spawn")
    error = None
    try:
        while not ctx.join(timeout=2):
            if time.perf_counter() - t0 > deadline:
                error = f"not done after {deadline} s"
                break
    except Exception as e:  # a rank raised or exited non-zero: the others are ended
        error = f"{type(e).__name__}: {str(e).strip()[-1500:]}"
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
        p.join()
    if error is not None:
        return None, error
    return {n: [torch.load(work / f"{n}.{r}.pt", weights_only=False) for r in range(world)] for n in names}, None


def phase_parallel(torch):
    """Phase 13: the parallel paths at full width on the one card.  The
    one-process references first, then which collectives a world of two
    ranks on the card carries (NCCL, then gloo on CUDA tensors), then each
    path at the widest world that carries it: (a) tp, (b) sp, (c) dp at
    two ranks where gloo carries their collectives, (d) the ring (send and
    recv) at world 1 on NCCL otherwise.  Returns the launches of all
    ranks, by wrapper."""
    import tempfile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        _par_reference_serving(torch, work)
        gc.collect()
        torch.cuda.empty_cache()

        carried = {}
        for backend in ("nccl", "gloo"):
            t0 = time.perf_counter()
            res, why = _par_spawn(torch, 2, backend, ["probe"], work, PAR_PROBE_S)
            if res:
                ranks = res["probe"]
            else:  # what each rank recorded before its world ended
                files = [work / f"probe_{backend}.{r}.pt" for r in range(2)]
                ranks = [torch.load(f, weights_only=False) if f.exists() else {}
                         for f in files]
                ranks = [{op: r.get(op, f"the world ended during it: {why[:300]}")
                          for op in PAR_OPS} for r in ranks]
            print(f"[parallel] two ranks on one card, {backend} on CUDA tensors "
                  f"({time.perf_counter() - t0:.1f} s):")
            for op in PAR_OPS:
                print(f"[parallel]   {op}: " + " | ".join(sorted({r[op] for r in ranks})))
            # carried: the collective ran and gave the right result on every rank
            carried[backend] = {op for op in PAR_OPS if all(r[op] == "ok" for r in ranks)}
        backend2 = "nccl" if carried["nccl"] >= set(PAR_OPS) else "gloo"
        at2 = [p for p in PAR_PATHS if PAR_NEEDS[p] <= carried[backend2]]
        at1 = [p for p in PAR_PATHS if p not in at2]
        for p in PAR_PATHS:
            why = (f"{backend2} carries {sorted(PAR_NEEDS[p])} at two ranks" if p in at2 else
                   f"two ranks on one card carry no {sorted(PAR_NEEDS[p] - carried[backend2])}"
                   f"; world 1 on nccl, the same code")
            print(f"[parallel] path {p}: world {2 if p in at2 else 1} "
                  f"({backend2 if p in at2 else 'nccl'}): {why}")
        _par_reference_training(torch, work, 2 if "dp" in at2 else 1)
        gc.collect()
        torch.cuda.empty_cache()
        results = {}
        for world, backend, names in ((2, backend2, at2), (1, "nccl", at1)):
            if not names:
                continue
            t0 = time.perf_counter()
            res, why = _par_spawn(torch, world, backend, names, work, PAR_DEADLINE_S)
            check(res is not None, f"parallel paths {names} at world {world}: {why}")
            print(f"[parallel] {names} at world {world} on {backend}: "
                  f"{time.perf_counter() - t0:.1f} s with the ranks' start ({smi})")
            results.update(res)
    if "dp" in results:
        sums = [r["checksums"] for r in results["dp"]]
        print(f"[parallel] dp replicas' trainables bit-equal across ranks: "
              f"{all(s == sums[0] for s in sums)}")
        check(all(s == sums[0] for s in sums), "dp replicas differ")
    launches = dict.fromkeys(_all_wrappers(), 0)
    for name, ranks in results.items():
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] += v
    print("[parallel] launches over all ranks and paths: "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    return launches


# ---------------------------------------------------------------------------
# Phase 14: MAGMA_v2 (attention adapters at k=8) and the last modules
# ---------------------------------------------------------------------------

V2_CKPT_DIR = ROOT / "build" / "smoke_v2_ckpt"
# not 0: ``Magma.from_checkpoint`` builds its template from seed 0, so a
# restore that copied nothing would leave other weights
V2_SEED = 1
# the seeded draws added to every adapter leaf (the CUDA tests' adapter
# std): at their N(0, 1e-3) init each adapter's output is ~1e-3 of its
# branch's, under every bound of this phase, so a kernel that skipped an
# adapter stage or fed it from the wrong source would pass; with the draws
# each is a few times its branch's
V2_ADAPTER_STD = 0.05


def _v2_model(torch, dev):
    """MAGMA_v2 from ``V2_SEED`` on the card, every adapter leaf moved off
    its init by seeded N(0, ``V2_ADAPTER_STD``) draws."""
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.utils import tree_items

    model = Magma(CONFIG_V2, seed=V2_SEED, device=dev)
    g = torch.Generator(device=dev).manual_seed(V2_SEED)
    blocks = model.params["lm"]["blocks"]
    with torch.no_grad():
        for key in ("adapter_mlp", "adapter_attn"):
            for _, t in tree_items(blocks[key]):
                t.copy_(t.float() + torch.randn(t.shape, generator=g, device=dev) * V2_ADAPTER_STD)
    return model


def _v2_int8_adapter_want(L, packs, steps, rows):
    """Exact launches of one request over the int8 adapter mode's layout
    (``quantize_lm_params(fuse_out_proj=False)`` + ``_serving_cast_adapters
    (mode="int8")``): every forward, the prefill and each decode step
    alike, runs the per-layer chain, ``packs`` K2b products a layer, and
    the head on K2a; the prompt's K1 once a layer; nothing else."""
    del rows  # every forward takes the same products
    want = {"int8_matmul_stacked_kernel": steps * L * packs, "int8_matmul_kernel": steps,
            "flash_attention_kernel": L}
    return {k: want.get(k, 0) for k in _all_wrappers()}


def _layer_packs(blocks):
    """The stacked int8 {"q", "s"} packs of the blocks, by path: each is one
    K2b launch a layer a forward."""
    found = []

    def walk(tree, path):
        if isinstance(tree, dict) and {"q", "s"} <= tree.keys():
            found.append("/".join(path))
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))

    walk(blocks, ())
    return found


def _prefill_logits_vs_dequantised(torch, tag, model, emb):
    """The greedy prompt's last-position prefill logits through the kernels
    against the bf16 path over the dequantised packs (phase 5's bound).
    Then the control: that reference without each adapter in turn must be
    farther from it than the bound and the measured difference together,
    so a path that skipped the adapter could not have passed."""
    lm = model.lm_config
    ref_lm = _dequantised_lm(torch, model.params["lm"], lm)
    got = _prefill_last_logits(torch, lm, model.params["lm"], emb)
    ref = _prefill_last_logits(torch, lm, ref_lm, emb)
    V = lm.vocab_size
    diff = (got - ref)[:V].abs().max().item()
    print(f"[{tag}] last-position prefill logits (fp32) vs the bf16 path over the dequantised "
          f"packs: max|diff| {diff:.4e} (tol {INT8_LOGIT_TOL}; logit std {ref.std().item():.3f}), "
          f"argmax equal: {int(got.argmax()) == int(ref.argmax())}")
    check(torch.isfinite(got).all().item(), f"{tag}: non-finite prefill logits")
    check(diff <= INT8_LOGIT_TOL, f"{tag}: prefill logits differ by {diff} > {INT8_LOGIT_TOL}")
    for name in ("attn_adapter", "mlp_adapter"):
        off = _prefill_last_logits(torch, dataclasses.replace(lm, **{name: None}), ref_lm, emb)
        moved = (off - ref)[:V].abs().max().item()
        print(f"[{tag}] control: the reference without its {name} moves by max|diff| "
              f"{moved:.4e} (must exceed tol + the measured difference, "
              f"{INT8_LOGIT_TOL + diff:.4e})")
        check(moved > INT8_LOGIT_TOL + diff,
              f"{tag}: the prefill check cannot see the {name} ({moved})")


def _v2_checkpoint(torch, model, emb, tokens):
    """(b): ``save_checkpoint`` of the bf16 params and state into build/,
    ``Magma.from_checkpoint`` of that directory on the card: every tensor
    bit-equal (checksums on the card) and the greedy request's tokens equal
    to (a)'s; bytes written and seconds to save and to restore printed; the
    directory deleted."""
    import shutil

    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.training.checkpoint import save_checkpoint
    from magma_tpu_torch.utils import tree_items

    shutil.rmtree(V2_CKPT_DIR, ignore_errors=True)
    V2_CKPT_DIR.parent.mkdir(parents=True, exist_ok=True)
    print(f"[v2 ckpt] {shutil.disk_usage(V2_CKPT_DIR.parent).free / 1e9:.1f} GB free under "
          f"{V2_CKPT_DIR.parent}")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_dir = Path(save_checkpoint(str(V2_CKPT_DIR), 0, model.params, model.state))
        save_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        t0 = time.perf_counter()
        restored = Magma.from_checkpoint(CONFIG_V2, V2_CKPT_DIR, device=torch.device("cuda"))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        print(f"[v2 ckpt] saved {n_bytes / 1e9:.3f} GB in {save_s:.2f} s, restored from the save "
              f"root in {restore_s:.2f} s (host clock, the file warm in the page cache)")
        for name in ("params", "state"):
            want = dict(tree_items(getattr(model, name)))
            got = dict(tree_items(getattr(restored, name)))
            check(got.keys() == want.keys(), f"v2 ckpt: the restored {name} differ in keys")
            same = _checksums(torch, got.values()) == _checksums(torch, want.values()) and all(
                got[k].dtype == t.dtype and got[k].device == t.device for k, t in want.items())
            print(f"[v2 ckpt] {name}: {len(got)} tensors, checksums, dtypes and devices equal: "
                  f"{same}")
            check(same, f"v2 ckpt: the restored {name} are not bit-equal")
        again = restored.generate(emb, max_steps=MAX_STEPS, temperature=0.0, decode=False)
        same = bool((again == tokens).all())
        print(f"[v2 ckpt] greedy tokens after the restore equal (a)'s: {same}")
        check(same, "v2 ckpt: the restored model's greedy tokens differ")
        del restored
    finally:
        shutil.rmtree(V2_CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def _v2_decode_controls(torch, model, emb, tokens, tag):
    """The control of (c)'s agreement: one decode step on the greedy
    request's prefilled bf16 cache through K8 with its adapter arguments
    wired wrong (the attention adapter's output zeroed, the attention
    adapter fed from "in", the mlp adapter's output zeroed) must fail the
    agreement with the b <= 8 path that phase 5b holds K8 to.  These K8
    launches are not the main path's and are not counted."""
    from magma_tpu_torch.models import gptj

    cfg, lm = model.lm_config, model.params["lm"]
    blocks = lm["blocks"]
    dev = emb.device
    x = gptj.embed_tokens(cfg, lm, torch.as_tensor(tokens[:, :1], device=dev))
    idx = torch.full((1,), emb.shape[1], dtype=torch.int32, device=dev)
    cache = _prefilled_cache(torch, cfg, lm, emb)

    def logits(step):
        hid, _, _ = step({k: t.clone() for k, t in cache.items()})
        return gptj.lm_head(cfg, lm, gptj._layer_norm(hid, lm["ln_f"], cfg.ln_eps,
                                                      cfg.compute_dtype))[0, -1]

    def zeroed(key):
        fz = blocks[key]["fused"]
        out = {**fz, "su": torch.zeros_like(fz["su"]), "bu": torch.zeros_like(fz["bu"])}
        return {**blocks, key: {**blocks[key], "fused": out}}

    def from_in(c, b):
        entry = gptj._fused_adapter_kwargs
        gptj._fused_adapter_kwargs = lambda *a: dict(entry(*a), attn_src="in")
        try:
            return gptj._run_decode_fused_layers(cfg, b, x, idx.reshape(1, 1), c, idx)
        finally:
            gptj._fused_adapter_kwargs = entry

    ref = logits(lambda c: _step_without_k8(torch, cfg, lm, x, c, idx))
    for what, step in (
            ("the attention adapter's output zeroed",
             lambda c: gptj._run_decode_fused_layers(cfg, zeroed("adapter_attn"), x,
                                                     idx.reshape(1, 1), c, idx)),
            ('the attention adapter fed from "in"', lambda c: from_in(c, blocks)),
            ("the mlp adapter's output zeroed",
             lambda c: gptj._run_decode_fused_layers(cfg, zeroed("adapter_mlp"), x,
                                                     idx.reshape(1, 1), c, idx))):
        rel = _rel(logits(step), ref)
        print(f"[{tag} control] K8 with {what} vs the b <= 8 path: logits rel {rel:.3e} "
              f"(must exceed {PATH_REL_TOL})")
        check(rel > PATH_REL_TOL, f"{tag}: the agreement cannot see K8 run with {what}")
    del cache


def phase_v2(torch):
    """Phase 14: MAGMA_v2 at full width, (a) bf16, (b) the checkpoint round
    trip, (c) int8 serving over fused adapters with the decode-step
    agreement, (d) the int8 adapter mode.  Returns the launches by wrapper
    over the phase."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel

    dev = torch.device("cuda")
    wrappers = _all_wrappers()
    total = dict.fromkeys(wrappers, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    wgmma0 = flash_attention_kernel.wgmma_launches
    t0 = time.perf_counter()
    model = _v2_model(torch, dev)
    torch.cuda.synchronize()
    lm = model.lm_config
    L = lm.n_layers
    hidden = {tag: lm.d_model // spec.downsample_factor
              for tag, spec in (("mlp", lm.mlp_adapter), ("attention", lm.attn_adapter))}
    print(f"[v2] Magma({CONFIG_V2.name}) in {time.perf_counter() - t0:.1f} s: {L} layers, d_model "
          f"{lm.d_model}, adapters {lm.mlp_adapter} (hidden {hidden['mlp']}) and "
          f"{lm.attn_adapter} (hidden {hidden['attention']}), LM weights "
          f"{nbytes(*_leaves(model.params['lm'])) / 1e9:.2f} GB ({lm.param_dtype}), tower "
          f"{model.config.encoder_name} at {model.config.image_size} px")
    check(lm.attn_adapter is not None and lm.attn_adapter.adapter_type == "normal"
          and hidden == {"mlp": 512, "attention": 512}, "v2: expected two normal adapters at 512")

    # (a) bf16: K1 once a layer a prefill, nothing else
    launches, (emb, tokens) = _requests_with_launches(
        torch, model, None, "v2 bf16",
        lambda steps, rows: {k: L if k == "flash_attention_kernel" else 0 for k in wrappers})
    add(launches)

    # (b) the checkpoint round trip (the restored model's greedy request is
    # not counted: (c) sets the counts to 0 first)
    _v2_checkpoint(torch, model, emb, tokens)

    # (c) int8 serving: fused adapters, K8 a decode step
    t0 = time.perf_counter()
    model.quantize_for_serving(8)
    torch.cuda.synchronize()
    blocks = model.params["lm"]["blocks"]
    check(all("fused" in blocks[k] for k in ("adapter_mlp", "adapter_attn")),
          "v2 int8: an adapter was not fused")
    print(f"[v2 int8] quantize_for_serving(8) in {time.perf_counter() - t0:.1f} s: LM "
          f"{nbytes(*_leaves(model.params['lm'])) / 1e9:.2f} GB")
    launches, (emb8, tokens8) = _requests_with_launches(
        torch, model, 8, "v2 int8", functools.partial(_want_launches, 8, L, adapters=2))
    add(launches)
    _prefill_logits_vs_dequantised(torch, "v2 int8", model, emb8)
    add(phase_decode_agreement(torch, model, emb8, tokens8, "v2 int8"))
    _v2_decode_controls(torch, model, emb8, tokens8, "v2 int8")
    profile_decode_step(torch, model, emb8, "v2 int8")
    del model, blocks
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the int8 adapter mode on a fresh model from the same seed
    t0 = time.perf_counter()
    model = _v2_model(torch, dev)
    model.params["lm"] = gptj._serving_cast_adapters(
        gptj.quantize_lm_params(model.params["lm"], fuse_out_proj=False), mode="int8")
    torch.cuda.synchronize()
    packs = _layer_packs(model.params["lm"]["blocks"])
    print(f"[v2 int8 adapters] rebuilt from seed {V2_SEED} (adapters moved as in (a)), "
          f"quantize_lm_params(fuse_out_proj=False) and the int8 adapter cast in "
          f"{time.perf_counter() - t0:.1f} s: LM "
          f"{nbytes(*_leaves(model.params['lm'])) / 1e9:.2f} GB; K2b a layer a forward: "
          f"{len(packs)} ({', '.join(packs)}), the head on K2a")
    check(len(packs) == 3 + 2 * 2, f"v2 int8 adapters: {len(packs)} packs a layer, expected 7")
    launches, (emb_d, _) = _requests_with_launches(
        torch, model, 8, "v2 int8 adapters",
        functools.partial(_v2_int8_adapter_want, L, len(packs)))
    add(launches)
    _prefill_logits_vs_dequantised(torch, "v2 int8 adapters", model, emb_d)
    profile_decode_step(torch, model, emb_d, "v2 int8 adapters")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    check(flash_attention_kernel.wgmma_launches == wgmma0,
          "v2: a b = 1 serving prefill ran K1's wgmma body")
    return total


def _timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{label}] phase time {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    if not (ROOT / "magma_tpu_torch").is_dir():
        return fail("run from a checkout of the repository: magma_tpu_torch/ is missing")
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default=None,
                        help="run only these of phases 10-15 after the build (a "
                             "partial run: it prints neither the kernels' line nor the ok line)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: this script measures the port on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))

    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    later = {"10": ("towers", phase_towers), "11": ("cli", phase_cli),
             "12": ("classifier", phase_classifier), "13": ("parallel", phase_parallel),
             "14": ("v2", phase_v2), "15": ("train CDE", phase_more_training)}
    if args.only is not None:
        for phase in args.only.split(","):
            _timed(later[phase][0], later[phase][1], torch)
        print(f"partial run (phases {args.only}) done in {time.perf_counter() - t_start:.1f} s "
              f"on {smi}")
        return 0
    k1 = phase_kernel(torch)
    int8_entries = phase_int8_kernels(torch)
    int4_entries = phase_int4_kernels(torch)
    decode_entries = phase_decode_layer_kernels(torch)
    train_entries = phase_train_kernels(torch)
    k1.update(train_entries.pop("k1_training"))
    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel

    flash_attention_kernel.wgmma_launches = 0  # the serving paths keep the mma.sync body
    model, emb, greedy_tokens, bf16_launches = phase_slice(torch)
    check(bf16_launches > 0, "the bf16 path launched no K1 kernel")
    phase_kernel_vs_plain_path(torch, model, emb, greedy_tokens)
    paths = {"int8": phase_quantized(torch, model, 8)}
    paths["int8 agreement"] = phase_decode_agreement(torch, model, *paths["int8"][1:], "int8")
    paths["int8"] = paths["int8"][0]
    paths["int8 split"], split_wgmma = phase_split_generate(torch, model)
    paths["int8 engine"] = phase_engine(torch, model, 8, "int8 engine", smi)
    del model, emb, greedy_tokens  # free the int8 model before the int4 one
    gc.collect()
    torch.cuda.empty_cache()
    model, launches4, emb4, tokens4 = phase_int4(torch)
    paths["int4"] = launches4
    paths["int4 agreement"] = phase_decode_agreement(torch, model, emb4, tokens4, "int4")
    paths["int4+kv8"] = phase_int4_kv8(torch, model, emb4, tokens4)
    cfg6 = model.lm_config
    model.lm_config = dataclasses.replace(cfg6, kv_cache_dtype="int8")
    paths["int4+kv8 engine"] = phase_engine(torch, model, 4, "int4+kv8 engine", smi)
    model.lm_config = cfg6
    print(f"[serving] K1 launches of the wgmma body over phases 3-7: "
          f"{flash_attention_kernel.wgmma_launches}, {split_wgmma} of them phase 5c's b = 8 "
          f"whole-prompt prefills (every b = 1 prefill keeps the mma.sync body)")
    check(flash_attention_kernel.wgmma_launches == split_wgmma,
          "a b = 1 serving prefill ran K1's wgmma body")
    del model, emb4, tokens4  # free the int4 model before training
    gc.collect()
    torch.cuda.empty_cache()
    paths["train A"] = phase_training(torch, "A")
    paths["train B"] = phase_training(torch, "B")
    for label, fn in later.values():
        paths[label] = _timed(label, fn, torch)

    launches = {k: sum(p[k] for p in paths.values()) for k in _all_wrappers()}
    launches["flash_attention_kernel"] += bf16_launches
    for wrapper, n in launches.items():
        check(n > 0, f"no path launched {wrapper}")
    k1["launches"] = launches["flash_attention_kernel"]
    k1["wgmma_launches"] = sum(paths[p]["k1_wgmma"] for p in ("train A", "train B", "cli",
                                                             "classifier", "train CDE"))
    entries = {**int8_entries, **int4_entries, **decode_entries, **train_entries}
    kernels = [k1] + [dict(entries[w], launches=launches[w])
                      for w in (*INT8_KERNELS, *INT4_KERNELS, *DECODE_KERNELS, *TRAIN_KERNELS)]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"done in {time.perf_counter() - t_start:.1f} s on {smi}")
    # K1's entry also carries its wgmma body's numbers at both training shapes
    k1_extra = [key for key in k1 if key.startswith("train_")] + ["wgmma_source", "wgmma_launches"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys + (tuple(k1_extra) if e is k1 else ())}
                                  for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
