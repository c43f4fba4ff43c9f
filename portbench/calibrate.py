"""Readings the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 8 \
        [--faults token,stale_cache] [--no-control] [--out chiprun_out/calibrate.jsonl]

For each seed, in one process: a run of the cell's timed path over a short
window (with the named faults planted in the program), then the comparison
on the run's own sample: for a served cell the program's widest
served-token logit gap and its sampler's readings, and the control's gap
(the reference in the nearest lower precision, int4 weights: the gap of
the token it puts first); for training the program's numbers and the
control's (float8 products).  One JSON line a seed.  The benchmark's own
runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def reading(cell, seed, seconds, device, faults=(), log=None, control=True):
    """One seed's readings of the program and of the control (``control``)."""
    from portbench import compare
    from portbench.faults import planted
    from portbench.harness import Ctx, free_device, pick_sample

    ctx = Ctx(cell, seed, seconds, False, device, time.perf_counter())
    if log is not None:
        ctx.log = log
    with planted(faults):
        out = cell.driver().run(ctx)
    bank = out.record.pop("bank", None)
    out.release()
    free_device()
    spec = cell.params["correct"]
    if spec["kind"] == "train":
        got = compare.train(cell, seed, out.trained, device, control=control)
    else:
        sample = pick_sample(out.served, seed, spec["min_tokens"], spec["max_requests"])
        got = compare.served(cell, seed, sample, bank, device, control=control)
        got.update(compare.sampled(out.sampled))
    free_device()
    return {"seed": seed, "faults": list(faults), **got}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import Cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = Cell.load(args.workload, ROOT / "BENCHMARK.json")
    faults = tuple(f for f in args.faults.split(",") if f)
    out = Path(args.out) if args.out else None
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        row = reading(cell, seed, args.seconds, "cuda", faults, control=not args.no_control)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
