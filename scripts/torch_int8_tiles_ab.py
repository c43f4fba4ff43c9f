"""Device time of the port's int8 weight-only products at M > 8 (K2a, K2b,
K4a) and of their input gradient (K10), compared between checkouts of the
repository on one GPU.

    python scripts/torch_int8_tiles_ab.py DIR [DIR ...] [--repeat 1] [--calls 20]

Each DIR is a checkout (for example its parent unpacked with ``git
archive`` into ``build/parent``, and this one, ".").  Every run is a fresh
process that imports ``magma_tpu_torch`` from its DIR, builds that
checkout's kernels and times each kernel wrapper alone (torch.profiler, the
device time of the launches whose kernel is not an elementwise fill) at the
shapes of the caption prefill (M = 192) and of the QLoRA step (M = 2048, the
head chunk M = 256), on seeded inputs made on the card, cycling through
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
)


def _child(tree: Path, calls: int) -> dict:
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
        wq = torch.randint(-127, 128, (layers, k, n), generator=g, device=dev, dtype=torch.int8)
        if kind == "dual":
            s = torch.rand((layers, 2, n), generator=g, device=dev) * 2e-4 + 1e-5
            ctx = torch.randn((m, D), generator=g, device=dev).to(torch.bfloat16)
            h = torch.randn((m, F_), generator=g, device=dev).to(torch.bfloat16)
            call = lambda i: quant.dual_matmul_kernel(ctx, h, wq, s, i)  # noqa: E731
        else:
            s = torch.rand((layers, n), generator=g, device=dev) * 2e-4 + 1e-5
            if kind == "dx":
                gr = torch.randn((m, n), generator=g, device=dev) * 1e-3
                call = lambda i: quant.int8_matmul_dx_kernel(gr, wq[i], s[i])  # noqa: E731
            else:
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                if kind == "head":
                    call = lambda i: quant.int8_matmul_kernel(x, wq[i], s[i])  # noqa: E731
                else:
                    call = lambda i: quant.int8_matmul_stacked_kernel(x, wq, s, i)  # noqa: E731
        it = itertools.cycle(range(layers))
        for _ in range(3):
            call(next(it))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call(next(it))
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and ("int8" in e.name or "gemv" in e.name or "mma" in e.name)]
        out[f"{label} M={m}"] = sum(times) / calls / 1e3 if times else None
        del wq, s
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(_child(args.child.resolve(), args.calls)))
        return 0
    trees = [t.resolve() for t in args.trees]
    order = (trees + trees[::-1]) * args.repeat
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree),
                               "--calls", str(args.calls)],
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
