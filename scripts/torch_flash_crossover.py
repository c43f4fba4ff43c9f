"""Device time of K1's two CUDA bodies on the same inputs, at the shapes
around the rule that picks between them (``flash_fwd_takes_wgmma`` in
``magma_tpu_torch/ops/flash_attention.py``), on one GPU.

    python scripts/torch_flash_crossover.py [--calls 20]

For head_dim 256 and 128, b h = 16 (b 1) and 32 (b 2) with 16 heads, and s
256, 512, 1024 and 2048 (causal, s_q = s_k, seeded bf16 inputs made on the
card), it launches the mma.sync body (``csrc/flash_attn_fwd.cu``) and the
wgmma body (``csrc/flash_attn_fwd_wgmma.cu``) through the module's private
launcher ``_fwd_launch``, which the wrapper calls with the rule's choice,
and times each kernel alone (torch.profiler: the mean duration of the
launches whose name matches).  Prints the card's name and power limit, one
JSON line per shape (both times, the 128-row blocks, the rule's choice and
the largest difference between the two bodies' O), then, for each body at
path A's shape (b 2, s 2048, h 16, hd 256), the host time of one launch
(outputs allocated, tensor maps encoded, the kernel enqueued; the card not
waited for; the median of 5 runs of 50 launches) and the time of one
launch by CUDA events around it, the card waited for after each (the
median of 50).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H = 16
MATCH = {False: "flash_fwd_kernel", True: "flash_fwd_wgmma"}


def _kernel_ms(torch, fn, match, calls):
    """Mean device ms of the kernels whose name holds ``match``, over
    ``calls`` calls of ``fn``; None when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
    return statistics.fmean(times) if times else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times CUDA kernels", file=sys.stderr)
        return 1
    from magma_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for hd in (256, 128):
        for b in (1, 2):
            for s in (256, 512, 1024, 2048):
                q, k, v = (torch.randn((b, s, H, hd), generator=g, device=dev)
                           .to(torch.bfloat16) for _ in range(3))
                kw = dict(scale=hd ** -0.5, causal=True, q_offset=0)
                row = {"hd": hd, "b": b, "h": H, "s": s,
                       "blocks": b * H * -(-s // fa.WGMMA_ROWS),
                       "rule_takes_wgmma": fa.flash_fwd_takes_wgmma(b, H, s, s, hd)}
                outs = {}
                for wgmma in (False, True):
                    call = (lambda w=wgmma: fa._fwd_launch(w, q, k, v, None, **kw))  # noqa: E731
                    outs[wgmma] = call()[0]
                    row["wgmma_ms" if wgmma else "mma_ms"] = _kernel_ms(
                        torch, call, MATCH[wgmma], args.calls)
                diff = outs[True].float() - outs[False].float()
                row["max_abs_diff_o"] = diff.abs().max().item()
                print(json.dumps(row), flush=True)
    b, s, hd = 2, 2048, 256
    q, k, v = (torch.randn((b, s, H, hd), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    out = {}
    for wgmma in (False, True):
        def call(w=wgmma):
            return fa._fwd_launch(w, q, k, v, None, scale=hd ** -0.5, causal=True, q_offset=0)

        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            runs.append((time.perf_counter() - t0) / 50 * 1e6)
            torch.cuda.synchronize()
        events = []
        for _ in range(50):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            events.append(start.elapsed_time(end))
        body = "wgmma" if wgmma else "mma"
        out[f"{body}_host_us"] = statistics.median(runs)
        out[f"{body}_call_ms"] = statistics.median(events)
    print(json.dumps({"path_a_shape_a_launch": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
