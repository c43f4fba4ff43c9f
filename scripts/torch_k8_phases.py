"""Where K8's time goes, phase by phase, on one GPU, for one or more
checkouts of the repository.

    python scripts/torch_k8_phases.py DIR [DIR ...] [--runs 5]

Each DIR runs in a fresh process that imports ``magma_tpu_torch`` from it
and times K8 (``decode_all_layers_fused``) over the seeded GPT-J 6B stacks
and cache of ``scripts/torch_tiles_ab.py``'s K8 rows (28 layers, the v1 mlp
adapter, a bf16 cache, pos 180), int4 and int8.  Every block of the launch
writes the card's %globaltimer at the start and the end of each phase of
each layer; per phase, summed over the layers, the script prints the
slowest block's end minus the first block's start (the release of the
barrier before it) and the barrier after it, the median of ``--runs``
launches after a warm one.

A checkout whose ``ops/decode_layer.py`` has ``decode_all_layers_stamped``
(the streamed kernel) runs that.  An older one, whose K8 is the
phase-per-barrier ``decode_layers_kernel`` (nine phases a layer, seven on
the last), runs a copy of its ``csrc/`` under ``build/k8_phases/`` in
which a stamp is written before and after each of that kernel's grid
barriers (the same points), built and loaded in place of its own
library.  Prints the card's name and power limit first, then one JSON line
per checkout and format.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

OLD_PHASES = ("attention", "combine", "dual terms", "branch sums", "adapter down",
              "adapter up + residual", "LN", "in_proj terms", "in_proj sums")
MAX_BLOCKS, MAX_PHASES = 2048, 512  # stamp capacity of the older kernel's copy

STAMP_DEFS = r'''
__device__ unsigned long long* g_k8_stamps;
#define K8_STAMP(end)                                                                     \
  do {                                                                                    \
    if (threadIdx.x == 0 && g_k8_stamps != nullptr) {                                     \
      unsigned long long t_;                                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                              \
      g_k8_stamps[((long long)blockIdx.x * MAX_PHASES_ + k8_si_) * 2 + (end)] = t_;       \
    }                                                                                     \
    if (end) ++k8_si_;                                                                    \
  } while (0)
'''


def _stamped_old_csrc(tree: Path, out: Path) -> Path:
    """A copy of an older checkout's csrc/ whose decode_layers_kernel
    stamps each phase's start and end, with a C entry that sets the stamp
    buffer (``magma_k8_set_stamps``)."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(tree / "magma_tpu_torch" / "csrc", out)
    src = (out / "decode_layer.cu").read_text()
    head, sep, body = src.partition("decode_layers_kernel(const Layers p) {")
    if not sep:
        raise RuntimeError(f"{tree}: no phase-per-barrier decode_layers_kernel to stamp")
    kernel, sep2, rest = body.partition("\nconstexpr int MAX_DEVICES")
    kernel = kernel.replace("grid.sync();", "{ K8_STAMP(1); grid.sync(); K8_STAMP(0); }")
    first = "    phase_attention<KV8>("
    kernel = kernel.replace(first, "    K8_STAMP(0);\n" + first, 1)
    # the layer loop's last phase ends where the loop body does
    last = r"\{ K8_STAMP\(1\); grid\.sync\(\); K8_STAMP\(0\); \}"
    kernel = re.sub(r"(\n    if \(l \+ 1 < p\.l1\) )" + last,
                    r"\n    K8_STAMP(1);\1{ grid.sync(); }", kernel)
    kernel = "\n  int k8_si_ = 0;" + kernel
    defs = STAMP_DEFS.replace("MAX_PHASES_", str(MAX_PHASES))
    entry = ('\nextern "C" int magma_k8_set_stamps(void* p) {\n'
             "  return (int)cudaMemcpyToSymbol(g_k8_stamps, &p, sizeof(p));\n}\n")
    (out / "decode_layer.cu").write_text(head.replace('#include "layer_phases.cuh"',
                                                      '#include "layer_phases.cuh"\n' + defs)
                                         + sep + kernel + sep2 + rest + entry)
    return out


def _old_breakdown(stamps, L: int) -> dict:
    """The older kernel's stamps (blocks, phases in launch order, 2) ->
    the same sums as ``phase_breakdown``, by OLD_PHASES."""
    used = stamps[:, :, 0] > 0
    blocks = used.any(1)
    st = stamps[blocks].double()
    n = int(used[blocks][0].sum())
    names = []
    for layer in range(L):
        names += list(OLD_PHASES if layer < L - 1 else OLD_PHASES[:7])
    if len(names) != n:
        raise RuntimeError(f"{n} stamped phases, expected {len(names)}")
    out = {k: 0.0 for k in OLD_PHASES}
    out.update({f"{k} barrier": 0.0 for k in OLD_PHASES})
    for i, name in enumerate(names):
        start, end = st[:, i, 0].min(), st[:, i, 1].max()
        out[name] += float(end - start) / 1e6
        if i + 1 < n:
            out[f"{name} barrier"] += float(st[:, i + 1, 0].min() - end) / 1e6
    out["total"] = float(st[:, n - 1, 1].max() - st[:, 0, 0].min()) / 1e6
    out["grid"] = int(blocks.sum())
    return out


def _child(tree: Path, runs: int) -> None:
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    import magma_tpu_torch
    from magma_tpu_torch import cuda_build
    from magma_tpu_torch.ops import decode_layer as dl
    from magma_tpu_torch.ops import quant

    import torch_tiles_ab as ab

    if Path(magma_tpu_torch.__file__).resolve().parent.parent != tree:
        raise RuntimeError(f"imported {magma_tpu_torch.__file__}, not the package of {tree}")
    new = hasattr(dl, "decode_all_layers_stamped")
    set_stamps = None
    if not new:  # build the stamped copy in place of the tree's own library
        import ctypes

        cuda_build.CSRC = _stamped_old_csrc(tree, tree / "build" / "k8_phases" / "csrc")
        cuda_build.BUILD_DIR = tree / "build" / "k8_phases" / "kernels"
        set_stamps = cuda_build.load_library().magma_k8_set_stamps
        set_stamps.argtypes = [ctypes.c_void_p]
    cuda_build.build()
    dev = torch.device("cuda")
    L = 28
    for fmt in ("int4", "int8"):
        g = torch.Generator(device=dev).manual_seed(0)
        args, kw = ab._k8_inputs(torch, quant, g, dev, fmt, "bf16", L)
        res = []
        for i in range(runs + 1):
            if new:
                *_, stamps = dl.decode_all_layers_stamped(*args, **kw)
                torch.cuda.synchronize()
                res.append(dl.phase_breakdown(stamps))
            else:
                stamps = torch.zeros((MAX_BLOCKS, MAX_PHASES, 2), dtype=torch.int64, device=dev)
                if set_stamps(stamps.data_ptr()) != 0:
                    raise RuntimeError("cannot set the stamp buffer")
                dl.decode_all_layers_fused(*args, **kw)
                torch.cuda.synchronize()
                res.append(_old_breakdown(stamps.cpu(), L))
        res = res[1:]
        med = {k: statistics.median(r[k] for r in res) for k in res[0]}
        print(json.dumps({"tree": str(tree), "format": fmt, "design": "streamed" if new
                          else "phase-per-barrier", "phases_ms": med}))
        if not new:
            set_stamps(None)
        ab._k8_stacks.cache_clear()
        torch.cuda.empty_cache()


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
