"""Device time of the port's int8 weight-only products at M > 8 (K2a, K2b,
K4a) and of their input gradient (K10), compared between checkouts of the
repository on one GPU.

    python scripts/torch_int8_tiles_ab.py DIR [DIR ...] [--repeat 1] [--calls 20]

Each DIR is a checkout (for example its parent unpacked with ``git
archive`` into ``build/parent``, and this one, ".").  Every run is a fresh
process that imports ``magma_tpu_torch`` from its DIR, builds that
checkout's kernels and times each kernel wrapper alone (torch.profiler, the
device time of the launches whose kernel is not an elementwise fill) at the
shapes of the caption prefill (M = 192; K3 also at a 2048-row prompt) and
of the QLoRA step (M = 2048, the head chunk M = 256), on seeded inputs made
on the card (int4 weights quantised there from seeded normals), cycling through
enough layers that the weights do not stay in the 50 MB L2.  The checkouts
run in the order given, then in the reverse order, ``--repeat`` times over
(A B B A).  Prints one JSON line per run and the medians per checkout.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

D, F_, V = 4096, 16384, 50304
# (label, wrapper, M, K, N, layers cycled)
SHAPES = (
    ("K2b in_proj", "stacked", 192, D, 3 * D + F_, 2),
    ("K2b in_proj", "stacked", 2048, D, 3 * D + F_, 2),
    ("K2b o", "stacked", 2048, D, D, 4),
    ("K2b fc_out", "stacked", 2048, F_, D, 2),
    ("K4a o+fc_out", "dual", 192, D + F_, D, 4),
    ("K2a head", "head", 256, D, V, 1),
    ("K10 in_proj", "dx", 2048, D, 3 * D + F_, 2),
    ("K10 o", "dx", 2048, D, D, 4),
    ("K10 fc_out", "dx", 2048, F_, D, 2),
    ("K10 head", "dx", 2048, D, V, 1),
    ("K10 head", "dx", 256, D, V, 1),
    ("K3 in_proj", "int4", 192, D, 3 * D + F_, 2),
    ("K3 in_proj", "int4", 2048, D, 3 * D + F_, 2),
    ("K3 in_proj", "int4", 1, D, 3 * D + F_, 2),
    ("K4b o+fc_out", "int4_dual", 192, D + F_, D, 2),
    ("K4b o+fc_out", "int4_dual", 1, D + F_, D, 2),
)


def _inputs(torch, quant, g, dev, kind, m, k, n, layers):
    """Seeded weights (layers of them), scales, inputs, and a call of the
    kind's kernel wrapper on layer i: (weights, scales, call)."""
    bf16 = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    if kind.startswith("int4"):
        packs = [quant.quantize_int4(torch.randn((k, n), generator=g, device=dev) * 0.02,
                                     compiled=True) for _ in range(layers)]
        wq, s = torch.stack([p["q4"] for p in packs]), torch.stack([p["s4"] for p in packs])
        if kind == "int4_dual":
            ctx, h = bf16(m, D), bf16(m, F_)
            return wq, s, lambda i: quant.int4_dual_kernel(ctx, h, wq, s, i)
        x = bf16(m, k)
        return wq, s, lambda i: quant.int4_matmul_stacked_kernel(x, wq, s, i)
    wq = torch.randint(-127, 128, (layers, k, n), generator=g, device=dev, dtype=torch.int8)
    if kind == "dual":
        s = torch.rand((layers, 2, n), generator=g, device=dev) * 2e-4 + 1e-5
        ctx, h = bf16(m, D), bf16(m, F_)
        return wq, s, lambda i: quant.dual_matmul_kernel(ctx, h, wq, s, i)
    s = torch.rand((layers, n), generator=g, device=dev) * 2e-4 + 1e-5
    if kind == "dx":
        gr = torch.randn((m, n), generator=g, device=dev) * 1e-3
        return wq, s, lambda i: quant.int8_matmul_dx_kernel(gr, wq[i], s[i])
    x = bf16(m, k)
    if kind == "head":
        return wq, s, lambda i: quant.int8_matmul_kernel(x, wq[i], s[i])
    return wq, s, lambda i: quant.int8_matmul_stacked_kernel(x, wq, s, i)


def _child(tree: Path, calls: int, only: tuple) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import magma_tpu_torch
    from magma_tpu_torch import cuda_build
    from magma_tpu_torch.ops import quant

    package = Path(magma_tpu_torch.__file__).resolve().parent
    if package.parent != tree:
        raise RuntimeError(f"imported {package}, not the package of {tree}")
    cuda_build.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": str(tree)}
    for label, kind, m, k, n, layers in SHAPES:
        if only and not label.startswith(only):
            continue
        wq, s, call = _inputs(torch, quant, g, dev, kind, m, k, n, layers)
        match = ("w4a8",) if kind.startswith("int4") else ("int8", "gemv", "mma")
        it = itertools.cycle(range(layers))
        for _ in range(3):
            call(next(it))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call(next(it))
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(word in e.name for word in match)]
        out[f"{label} M={m}"] = (sum(e.time_range.elapsed_us() for e in events) / calls / 1e3
                                 if events else None)
        if kind.startswith("int4") and m > 8:  # the activation pre-pass's share
            out[f"{label} M={m} pre-pass"] = sum(
                e.time_range.elapsed_us() for e in events if "quantize" in e.name) / calls / 1e3
        del wq, s
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated label prefixes to time (e.g. K3,K4b); all by default")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        only = tuple(w for w in args.only.split(",") if w)
        print(json.dumps(_child(args.child.resolve(), args.calls, only)))
        return 0
    trees = [t.resolve() for t in args.trees]
    order = (trees + trees[::-1]) * args.repeat
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree),
                               "--calls", str(args.calls), "--only", args.only],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    for tree in trees:
        mine = [r for r in runs if r["tree"] == str(tree)]
        med = {k: statistics.median(r[k] for r in mine) for k in mine[0]
               if k != "tree" and all(r[k] is not None for r in mine)}
        print(json.dumps({"tree": str(tree), "median_ms": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
