"""Where K6's time goes, phase by phase, on one GPU, for one or more
checkouts of the repository.

    python scripts/torch_k6_phases.py DIR [DIR ...] [--runs 5]

Each DIR runs in a fresh process that imports ``magma_tpu_torch`` from it
and launches K6 (``boundary_kernel``) on the seeded int4 GPT-J 6B stacks of
``scripts/torch_tiles_ab.py``'s K6 rows (the v1 mlp adapter, layer 0 with
the next layer's in_proj) at M = 1 and M = 8 rows.  Every block of the
launch writes the card's %globaltimer at the start and the end of each
phase; per phase the script prints the slowest block's end minus the first
block's start and the wait after it (the grid barrier, or the counters the
next phase waits on), the median of ``--runs`` launches after a warm one.

A checkout whose ``ops/quant.py`` has ``boundary_stamped`` (the streamed
kernel) runs that, and its K5 (``fused_adapter_stamped``) on the v1 adapter
of ``scripts/torch_tiles_ab.py``'s K5 rows at M = 1, 8, 16 and 64 as well.
An older one, whose K6 is the phase-per-barrier ``boundary_kernel`` of
``csrc/boundary.cu`` (phases A-G between six grid barriers), runs a copy of
its ``csrc/`` under ``build/k6_phases/`` in which a stamp is written before
and after each of that kernel's grid barriers, built and loaded in place of
its own library.  Prints the card's name and
power limit first, then one JSON line per checkout, kernel and M.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

OLD_PHASES = ("A dual terms", "B branch sums", "C adapter down", "D adapter up + residual",
              "E LN", "F in_proj terms", "G in_proj sums")
MAX_BLOCKS = 2048  # stamp capacity of the older kernel's copy

STAMP_DEFS = r'''
__device__ unsigned long long* g_k6_stamps;
#define K6_STAMP(end)                                                                     \
  do {                                                                                    \
    if (threadIdx.x == 0 && g_k6_stamps != nullptr) {                                     \
      unsigned long long t_;                                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                              \
      g_k6_stamps[((long long)blockIdx.x * 7 + k6_si_) * 2 + (end)] = t_;                 \
    }                                                                                     \
    if (end) ++k6_si_;                                                                    \
  } while (0)
'''


def _stamped_old_csrc(tree: Path, out: Path) -> Path:
    """A copy of an older checkout's csrc/ whose boundary_kernel stamps
    each phase's start and end, with a C entry that sets the stamp buffer
    (``magma_k6_set_stamps``)."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(tree / "magma_tpu_torch" / "csrc", out)
    src = (out / "boundary.cu").read_text()
    head, sep, body = src.partition("boundary_kernel(const Boundary p) {")
    if not sep:
        raise RuntimeError(f"{tree}: no phase-per-barrier boundary_kernel to stamp")
    kernel, sep2, rest = body.partition("\nconstexpr int MAX_DEVICES")
    kernel = kernel.replace("grid.sync();", "{ K6_STAMP(1); grid.sync(); K6_STAMP(0); }")
    kernel = kernel.replace("if (p.qi == nullptr) return;",
                            "if (p.qi == nullptr) { K6_STAMP(1); return; }")
    first = "  phase_dual_terms<"
    kernel = kernel.replace(first, "  K6_STAMP(0);\n" + first, 1)
    last = "phase_inproj_sums<true>(p);\n}"
    if last not in kernel:
        raise RuntimeError(f"{tree}: boundary_kernel does not end in phase G")
    kernel = kernel.replace(last, "phase_inproj_sums<true>(p);\n  K6_STAMP(1);\n}")
    kernel = "\n  int k6_si_ = 0;" + kernel
    entry = ('\nextern "C" int magma_k6_set_stamps(void* p) {\n'
             "  return (int)cudaMemcpyToSymbol(g_k6_stamps, &p, sizeof(p));\n}\n")
    (out / "boundary.cu").write_text(
        head.replace('#include "layer_phases.cuh"', '#include "layer_phases.cuh"\n' + STAMP_DEFS)
        + sep + kernel + sep2 + rest + entry)
    return out


def _old_breakdown(stamps) -> dict:
    """The older kernel's stamps (blocks, 7 phases, 2) -> per phase the
    slowest block's end minus the first block's start, and the barrier
    after it (ms)."""
    used = stamps[:, 0, 0] > 0
    st = stamps[used].double()
    n = int((st[0, :, 1] > 0).sum())
    out = {}
    for i in range(n):
        start, end = st[:, i, 0].min(), st[:, i, 1].max()
        out[OLD_PHASES[i]] = float(end - start) / 1e6
        if i + 1 < n:
            out[f"{OLD_PHASES[i]} barrier"] = float(st[:, i + 1, 0].min() - end) / 1e6
    out["total"] = float(st[:, n - 1, 1].max() - st[:, 0, 0].min()) / 1e6
    out["grid"] = int(used.sum())
    return out


def _child(tree: Path, runs: int) -> None:
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    import magma_tpu_torch
    from magma_tpu_torch import cuda_build
    from magma_tpu_torch.ops import quant

    import torch_tiles_ab as ab

    if Path(magma_tpu_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError(f"imported {magma_tpu_torch.__file__}, not the package of {tree}")
    new = hasattr(quant, "boundary_stamped")
    set_stamps = None
    if not new:  # build the stamped copy in place of the tree's own library
        import ctypes

        cuda_build.CSRC = _stamped_old_csrc(tree, tree / "build" / "k6_phases" / "csrc")
        cuda_build.BUILD_DIR = tree / "build" / "k6_phases" / "kernels"
        set_stamps = cuda_build.load_library().magma_k6_set_stamps
        set_stamps.argtypes = [ctypes.c_void_p]
    cuda_build.build()
    dev = torch.device("cuda")
    dual, w_in, fz, (b_fc_out, ln_g, ln_b) = ab._k6_stacks(torch, quant, 4)
    for m in (1, 8):
        g = torch.Generator(device=dev).manual_seed(m)
        bf16 = lambda *shape, std=1.0: (torch.randn(shape, generator=g, device=dev)  # noqa: E731
                                        * std).to(torch.bfloat16)
        args = (bf16(m, 4096), bf16(m, 16384, std=0.5), bf16(m, 4096, std=0.3), dual,
                b_fc_out, ln_g, ln_b, 0)
        kw = dict(fz_mlp=fz, mlp_src="out", w_in=w_in)
        res = []
        for _ in range(runs + 1):
            if new:
                *_, stamps = quant.boundary_stamped(*args, **kw)
                torch.cuda.synchronize()
                res.append(quant.phase_breakdown(stamps))
            else:
                stamps = torch.zeros((MAX_BLOCKS, 7, 2), dtype=torch.int64, device=dev)
                if set_stamps(stamps.data_ptr()) != 0:
                    raise RuntimeError("cannot set the stamp buffer")
                quant.boundary_kernel(*args, **kw)
                torch.cuda.synchronize()
                res.append(_old_breakdown(stamps.cpu()))
        res = res[1:]
        med = {k: statistics.median(r[k] for r in res) for k in res[0]}
        print(json.dumps({"tree": str(tree), "kernel": "K6", "M": m, "design": "streamed"
                          if new else "phase-per-barrier", "phases_ms": med}))
    if not new:
        set_stamps(None)
        return
    fz = ab._k5_adapter(torch, quant, 4096, 1024, 28)
    for m in (1, 8, 16, 64):
        g = torch.Generator(device=dev).manual_seed(m)
        x = torch.randn((m, 4096), generator=g, device=dev).to(torch.bfloat16)
        res = []
        for i in range(runs + 1):
            _, stamps = quant.fused_adapter_stamped(x, fz, i % 28)
            torch.cuda.synchronize()
            res.append(quant.phase_breakdown(stamps, quant.ADAPTER_PHASES))
        res = res[1:]
        med = {k: statistics.median(r[k] for r in res) for k in res[0]}
        print(json.dumps({"tree": str(tree), "kernel": "K5", "M": m, "design": "streamed",
                          "phases_ms": med}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        _child(args.child.resolve(), args.runs)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    for tree in args.trees:
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree.resolve()),
                               "--runs", str(args.runs)], capture_output=True, text=True,
                              timeout=900)
        print(proc.stdout.strip())
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
