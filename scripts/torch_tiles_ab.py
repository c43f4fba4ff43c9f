"""Device time of the port's int8 weight-only products at M > 8 (K2a, K2b,
K4a), of their input gradient (K10), of the W4A8 products (K3, K4b) and of
flash attention at the training shape (K1, K9a, K9b), compared between
checkouts of the repository on one GPU.

    python scripts/torch_tiles_ab.py DIR [DIR ...] [--repeat 1] [--calls 20]
        [--only K1,K9a,K9b]

Each DIR is a checkout (for example its parent unpacked with ``git
archive`` into ``build/parent``, and this one, ".").  Every run is a fresh
process that imports ``magma_tpu_torch`` from its DIR, builds that
checkout's kernels and times each kernel wrapper alone (torch.profiler, the
device time of the launches whose kernel is not an elementwise fill) at the
shapes of the caption prefill (M = 192; K3 also at a 2048-row prompt) and
of the QLoRA step (M = 2048, the head chunk M = 256), and K1 and K9a/K9b
at a training layer's attention (b 2, s 2048, 16 heads of 256, causal;
M = b s), on seeded inputs made on the card (int4 weights quantised there
from seeded normals), cycling through enough layers that the weights do
not stay in the 50 MB L2.  A kernel is matched by a substring of its name
that both trees' kernels share ("w4a8", "flash_fwd", "flash_bwd_dkv",
"flash_bwd_dq", ...).  The checkouts run in the order given, then in the
reverse order, ``--repeat`` times over (A B B A).  Prints one JSON line
per run and the medians per checkout.
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
    # K1, K9: M = b s, then the heads and the head_dim in place of K and N
    ("K1 fwd", "flash_fwd", 2 * 2048, 16, 256, 1),
    ("K9a dK,dV", "flash_dkv", 2 * 2048, 16, 256, 1),
    ("K9b dQ", "flash_dq", 2 * 2048, 16, 256, 1),
)
# the substrings of the kernel names each kind is timed by
MATCH = {"flash_fwd": ("flash_fwd",), "flash_dkv": ("flash_bwd_dkv",),
         "flash_dq": ("flash_bwd_dq",)}


def _inputs(torch, quant, g, dev, kind, m, k, n, layers):
    """Seeded weights (layers of them), scales, inputs, and a call of the
    kind's kernel wrapper on layer i: (weights, scales, call); for K1 and
    K9 the seeded q, k, v, dO of one layer's attention: (q, lse, call)."""
    bf16 = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    if kind.startswith("flash"):
        from magma_tpu_torch.ops import flash_attention as fa

        b, s, h, hd = 2, m // 2, k, n
        q, kk, v, do = (bf16(b, s, h, hd) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, kk, v, scale=hd ** -0.5, causal=True)
        lse = lse.contiguous()
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        kw = dict(scale=hd ** -0.5, causal=True, q_offset=0)
        if kind == "flash_fwd":
            return q, lse, lambda i: fa.flash_attention_kernel(q, kk, v, None, **kw)
        fn = (fa.flash_attention_bwd_dkv_kernel if kind == "flash_dkv"
              else fa.flash_attention_bwd_dq_kernel)
        return q, lse, lambda i: fn(q, kk, v, do, lse, di, None, **kw)
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
        if only and label.split()[0] not in only:
            continue
        wq, s, call = _inputs(torch, quant, g, dev, kind, m, k, n, layers)
        match = MATCH.get(kind, ("w4a8",) if kind.startswith("int4") else ("int8", "gemv", "mma"))
        it = itertools.cycle(range(layers))
        for _ in range(3):
            call(next(it))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call(next(it))
            torch.cuda.synchronize()
        # each matching kernel launches once a call: a call takes the sum of
        # their mean durations, which a trace that lost some of its device
        # events still gives
        by_name = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and any(word in e.name for word in match)):
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
        out[f"{label} M={m}"] = (sum(statistics.fmean(t) for t in by_name.values())
                                 if by_name else None)
        if kind.startswith("int4") and m > 8:  # the activation pre-pass's share
            out[f"{label} M={m} pre-pass"] = sum(
                statistics.fmean(t) for name, t in by_name.items() if "quantize" in name)
        del wq, s
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated kernel ids to time (e.g. K3,K4b: a label's first "
                         "word); all by default")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        only = tuple(w for w in args.only.split(",") if w)
        print(json.dumps(_child(args.child.resolve(), args.calls, only)))
        return 0
    trees = [t.resolve() for t in args.trees]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
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
