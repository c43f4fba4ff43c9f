#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``magma_tpu_torch``) through its caption
path once on one NVIDIA GPU, and check what comes out.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases (any failed check or exception ends the run with a non-zero exit):

0. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and convolutions.
1. Build: the CUDA kernels from ``magma_tpu_torch/csrc`` (nvcc, sm_90a),
   with ptxas's resource report.
2. Each kernel against its plain PyTorch version on the same bf16 inputs at
   the caption prefill's shapes, and both timed (median of CUDA events).
3. The caption path at full width: ``Magma`` from configs/MAGMA_v1.yml
   (GPT-J 6B + mlp adapters + CLIP RN50x16 at 384 px) with bf16 weights
   drawn from a seed on the GPU, answering three requests of one image and
   "Describe the painting:" (one greedy, two sampled).  Kernel launch
   counts are reset just before and read just after.
4. The greedy request's prefill logits through the kernel against the
   plain attention path, and the greedy tokens of both.

The last two lines are one JSON object of the kernels' numbers and one
JSON object saying the run is ok and on which device.
"""

import dataclasses
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
    """K1 vs its plain version.  Returns (max O error, kernel ms, plain ms)."""
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
            timed = (q, k, v, kw)
    q, k, v, kw = timed
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw))
    print(f"[K1] slice prefill shape (b*h=16, s=256, hd=256): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (median of 50, CUDA events)")
    return worst, ms, plain_ms


def phase_slice(torch):
    """Three caption requests at full width.  Returns (model, greedy request
    embeddings, greedy tokens, K1 launches)."""
    from PIL import Image

    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.ops.flash_attention import flash_attention_kernel

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = Magma(CONFIG, seed=0, device=dev)
    torch.cuda.synchronize()
    lm = model.lm_config
    n_lm = sum(t.numel() * t.element_size() for t in _leaves(model.params["lm"]))
    print(f"[slice] Magma({CONFIG.name}) on {torch.cuda.get_device_name(0)} in "
          f"{time.perf_counter() - t0:.1f} s: {lm.n_layers} layers, d_model {lm.d_model}, "
          f"{lm.n_heads} heads x {lm.head_dim}, d_ff {lm.d_ff}, rotary {lm.rotary_dim}, "
          f"vocab {lm.vocab_size} -> {lm.padded_vocab_size}, mlp adapter "
          f"{lm.mlp_adapter}, LM weights {n_lm / 1e9:.2f} GB "
          f"({lm.param_dtype}), attention {lm.attention_impl}")
    print(f"[slice] tokenizer {type(model.tokenizer).__name__}: {PROMPT!r} -> "
          f"{model.tokenizer.encode(PROMPT).shape[1]} tokens")

    pixels = np.random.default_rng(1).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    image = Image.fromarray(pixels)
    requests = [
        ("greedy", dict(temperature=0.0)),
        ("top_p=0.9 T=0.7", dict(temperature=0.7, top_k=0, top_p=0.9)),
        ("top_k=5 T=0.7", dict(temperature=0.7, top_k=5)),
    ]
    flash_attention_kernel.launches = 0  # count the main path only
    greedy = None
    for i, (name, kw) in enumerate(requests):
        before = flash_attention_kernel.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        emb = model.preprocess_inputs([image, PROMPT])
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
        launches = flash_attention_kernel.launches - before
        steps = timing["steps"]
        per_tok = timing["decode_ms"] / max(steps - 1, 1)
        print(f"[slice] request {i} ({name}): embeddings {tuple(emb.shape)}, "
              f"K1 launches {launches}, {steps} tokens {tokens[0, :steps].tolist()} "
              f"-> {text!r}")
        print(f"[slice]   vision+prefix {vision_ms:.2f} ms, prefill {timing['prefill_ms']:.2f} ms, "
              f"decode {per_tok:.2f} ms/token ({timing['decode_ms']:.1f} ms over "
              f"{steps - 1} forwards and {steps} samplings)")
        check(launches == lm.n_layers, f"request {i}: {launches} K1 launches, "
              f"expected {lm.n_layers} (one per layer's prefill)")
        check(((tokens >= 0) & (tokens < lm.vocab_size)).all(), "token out of vocab")
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


def phase_kernel_vs_plain_path(torch, model, emb, greedy_tokens):
    """Prefill logits and greedy tokens, kernel path vs plain einsum path."""
    from magma_tpu_torch.models import gptj

    pad = (-emb.shape[1]) % 64
    padded = torch.nn.functional.pad(emb, (0, 0, 0, pad))
    s = emb.shape[1]
    kv_len = torch.full((1,), s, dtype=torch.int32, device=emb.device)
    plain_cfg = dataclasses.replace(model.lm_config, attention_impl="xla")
    logits = {}
    for name, cfg in (("kernel", model.lm_config), ("plain", plain_cfg)):
        cache = gptj.init_kv_cache(cfg, 1, padded.shape[1] + 64, device=emb.device)
        hidden, _ = gptj.forward(cfg, model.params["lm"], padded, cache=cache,
                                 cache_index=0, kv_len=kv_len, return_hidden=True)
        logits[name] = gptj.lm_head(cfg, model.params["lm"], hidden[:, s - 1:s])[0, 0]
    diff = (logits["kernel"] - logits["plain"])[: model.lm_config.vocab_size].abs().max().item()
    std = logits["plain"].std().item()
    print(f"[e2e] last-position prefill logits (fp32), kernel vs plain path: "
          f"max|diff| {diff:.4e} (tol {LOGIT_TOL}; logit std {std:.3f})")
    check(torch.isfinite(logits["kernel"]).all().item(), "non-finite prefill logits")
    check(diff <= LOGIT_TOL, f"prefill logits differ by {diff} > {LOGIT_TOL}")

    model.lm_config = plain_cfg  # the last phase: the model is not used after it
    plain_tokens = model.generate(emb, max_steps=MAX_STEPS, temperature=0.0, decode=False)
    same = int((plain_tokens[0] == greedy_tokens[0]).sum())
    first_diff = next((i for i, (a, b) in enumerate(zip(plain_tokens[0], greedy_tokens[0]))
                       if a != b), None)
    print(f"[e2e] greedy tokens equal at {same}/{MAX_STEPS} positions "
          f"(first difference at {first_diff})")


def main() -> int:
    if not (ROOT / "magma_tpu_torch").is_dir():
        return fail("run from a checkout of the repository: magma_tpu_torch/ is missing")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: this script measures the port on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))

    phase_device(torch)
    phase_build()
    o_err, ms, plain_ms = phase_kernel(torch)
    model, emb, greedy_tokens, launches = phase_slice(torch)
    check(launches > 0, "the main path launched no K1 kernel")
    phase_kernel_vs_plain_path(torch, model, emb, greedy_tokens)

    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "magma_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "magma_tpu/ops/flash_attention.py:75",
        "launches": launches,
        "max_abs_err": o_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
