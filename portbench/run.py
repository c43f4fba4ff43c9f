"""Benchmark entry: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the run's checks as its last lines on
standard error and the result as one JSON object, the last line of standard
output.  Exits with a code other than 0, and prints no result, when the
card is missing, when the process has loaded JAX, Flax or the JAX package,
or when the program cannot be imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# libraries that load JAX on their own when they find it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# build caches at fixed paths inside the checkout (the port's own kernel
# library already builds into build/kernels/)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import Cell, run_cell

    cell = Cell.load(args.workload, ROOT / "BENCHMARK.json")
    chips = cell.entry.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 3
    os.chdir(ROOT)  # build/ and the kernel library live in the checkout
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    for name, c in result["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name}: {c['value']} (limit {rel} {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
