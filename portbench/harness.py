"""The harness: finds a cell's files by name, runs its traffic driver against
the program, checks what the timed path produced against the plain
reference, and reduces the run to the contract's result line.

Everything that belongs to one cell, configuration, traffic driver or
per-layer metric is a file of its own, found by its name:

* ``BENCHMARK.json`` (the checkout's root): the cell's configuration and
  traffic names, and which metrics the cell reports;
* ``portbench/workloads/<cell>.json``: the cell's parameters and limits;
* ``portbench/configs/<config>.json``: the model, its yml and its sizes;
* ``portbench/families/<family>.py``: the reference, weights, model FLOPs
  and kernel costs of the language-model family the configuration's
  ``model.family`` names (absent: ``gptj``);
* ``portbench/traffic/<traffic>.py``: ``run(ctx) -> Outcome``;
* ``portbench/metrics/<metric>.py``: ``read(record) -> float or None``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "magma_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A harness file (a driver, a metric or a family) by path, as its own
    module."""
    name = "portbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(model: Dict, root: Path = HERE):
    """The module of the language-model family a configuration's ``model``
    names: ``<root>/families/<model["family"]>.py``, ``gptj`` where it names
    none (``families/gptj.py`` says what a family module gives)."""
    return load_module(root / "families" / f"{model.get('family', 'gptj')}.py")


@dataclasses.dataclass
class Cell:
    """A cell's entries and files, found by its name."""
    name: str
    entry: Dict            # its BENCHMARK.json workload entry
    params: Dict           # portbench/workloads/<name>.json
    config: Dict           # portbench/configs/<config>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path             # the portbench directory its files came from

    @classmethod
    def load(cls, name: str, bench_json: Path, root: Path = HERE) -> "Cell":
        bench = load_json(bench_json)
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in {bench_json}")

        def mine(m):
            return name in m.get("workloads", [name])

        return cls(name, entry, load_json(root / "workloads" / f"{name}.json"),
                   load_json(root / "configs" / f"{entry['config']}.json"),
                   [m for m in bench["end_to_end"] if mine(m)],
                   [m for m in bench["per_layer"] if mine(m)], root)

    def driver(self):
        return load_module(self.root / "traffic" / f"{self.entry['traffic']}.py")

    def metric(self, name: str) -> Callable:
        return load_module(self.root / "metrics" / f"{name}.py").read

    def family(self):
        return family(self.config["model"], self.root)


@dataclasses.dataclass
class Ctx:
    """What a driver is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float                       # the process's start, host clock
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the record the metrics read, the counts,
    the served requests the comparison samples from, a function that frees
    the program's state, and the sampler calls the probe kept."""
    record: Dict
    attempted: int
    failed: int
    served: List                         # [(Request, served token ids)], greedy, finished
    release: Callable[[], None]
    sampled: List = dataclasses.field(default_factory=list)  # serve.SamplerProbe.kept


def build_magma(cell: Cell, weights: Dict, device: str):
    """The program under test: ``Magma`` over the benchmark's weights, in the
    serving layout the configuration names."""
    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.models.magma import Magma

    model = Magma(MultimodalConfig(**cell.config["yml"]), device=device, init_weights=False)
    model.params = {"lm": weights["lm"], "image_prefix": weights["image_prefix"]}
    model.state = {"image_prefix": weights["stats"]}
    bits = cell.config.get("serving", {}).get("bits")
    if bits:
        model.quantize_for_serving(bits)
    return model


def modules_found() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pick_sample(served: List, seed: int, min_tokens: int, max_requests: int) -> List:
    """The requests the comparison checks: the one with the longest prompt,
    then others in an order drawn from the seed until ``min_tokens`` served
    tokens or ``max_requests`` requests."""
    import numpy as np

    if not served:
        return []
    # the longest prompt: the most images, then the most text
    longest = max(range(len(served)),
                  key=lambda i: (served[i][0].n_images(), served[i][0].text_len(), i))
    order = [longest] + [int(i) for i in np.random.default_rng([int(seed), 3]).permutation(
        len(served)) if i != longest]
    out, n = [], 0
    for i in order:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(served[i])
        n += len(served[i][1])
    return out


def correctness(cell: Cell, seed: int, out: Outcome, bank, device: str, log) -> Dict:
    """{number: {"value", "limit"}} of the cell's comparison ("at_least": a
    floor rather than a ceiling)."""
    from portbench import compare

    spec = cell.params["correct"]
    if spec["kind"] == "train":
        got = compare.train(cell, seed, out.trained, device)
        log(f"[check] losses {got['losses']}; {got['leaves_compared']} leaves compared, "
            f"{got['leaves_left_out']} left out")
        return {k: {"value": got[k], "limit": v} for k, v in spec["limits"].items()}
    sample = pick_sample(out.served, seed, spec["min_tokens"], spec["max_requests"])
    checks, n = {}, 0
    if sample:
        got = compare.served(cell, seed, sample, bank, device)
        n = got["tokens_compared"]
        log(f"[check] {got['requests_compared']} greedy requests, {n} served tokens "
            f"against the reference")
        checks["logit_gap"] = {"value": got["logit_gap"], "limit": spec["limits"]["logit_gap"]}
    checks["served_greedy_tokens"] = {"value": n, "limit": spec["floor_tokens"],
                                      "at_least": True}
    drawn = compare.sampled(out.sampled)
    log(f"[check] {drawn['sampled_checked']} sampled tokens against the sampler's "
        f"semantics on the logits it saw")
    for k in ("nucleus_gap", "sample_z"):
        checks[k] = {"value": drawn[k], "limit": spec["limits"][k]}
    checks["sampled_tokens"] = {"value": drawn["sampled_checked"], "limit": spec["floor_sampled"],
                                "at_least": True}
    return checks


def materialize(req, bank) -> List:
    """A request's prompt as the reference takes it: uint8 images and id arrays."""
    return [bank[v] if k == "image" else v for k, v in req.parts]


def free_device():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, faults: tuple = ()) -> Dict:
    """One run: the driver's window, the comparison, the result line's dict
    (with its checks under "checks", last).  ``faults`` (tests only): faults
    planted in the program (``faults.py``)."""
    import torch

    ctx = Ctx(cell, seed, seconds, trace, device, t_start)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    from portbench.faults import planted

    with planted(faults):
        out = cell.driver().run(ctx)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bank = out.record.pop("bank", None)
    out.release()
    free_device()
    found = modules_found()
    if found:
        raise SystemExit(f"the process loaded {found} (no JAX, Flax or JAX-package module "
                         f"may be loaded)")
    checks = correctness(cell, seed, out, bank, device, ctx.log)
    correct = all(c["value"] >= c["limit"] if c.get("at_least") else c["value"] <= c["limit"]
                  for c in checks.values())
    rec = out.record
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cell.metric(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if trace and rec.get("trace"):
        from portbench.trace import breakdown

        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = breakdown(rec["trace"])
    result["checks"] = checks
    return result
