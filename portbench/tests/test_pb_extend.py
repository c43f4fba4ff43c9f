"""A later change adds a configuration, a cell, a traffic driver, a
per-layer metric or a language-model family as new files (and entries in
BENCHMARK.json) only: in a temporary copy of the harness, the harness finds
them by name and runs the new cells, and no file that was there changes."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from conftest import HERE, PORTBENCH, REPO

SCRIPT = """
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from pathlib import Path
from portbench.harness import Cell, run_cell
root = Path(sys.argv[1]) / "portbench"
cell = Cell.load("tiny_v1.b1_twice", Path(sys.argv[1]) / "BENCHMARK.json", root)
assert cell.root == root and [m["name"] for m in cell.per_layer][-1] == "requests.twice"
assert cell.metric("requests.twice")({"twice": True, "latency_ms": [1.0]}) == 1.0
print(json.dumps(run_cell(cell, 99, 5, False, "cpu", time.perf_counter())))
"""

DRIVER = '''"""generate_closed, each request submitted twice in a row."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "gc", Path(__file__).with_name("generate_closed.py"))
_gc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gc)


def run(ctx):
    out = _gc.run(ctx)
    out.record["twice"] = True
    return out
'''

METRIC = '''"""The count of requests in the window (a new per-layer metric)."""


def read(record):
    return float(len(record["latency_ms"])) if record.get("twice") else None
'''


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_only(tmp_path):
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    root = tmp_path / "portbench"
    for sub in ("configs", "workloads"):
        for f in (HERE / "data" / sub).iterdir():
            shutil.copy(f, root / sub / f.name)
    bench = json.loads((HERE / "data" / "BENCHMARK.json").read_text())
    before = _digest(root)

    # the new files
    cfg = json.loads((root / "configs" / "tiny_v1.json").read_text())
    cfg["name"] = "tiny_v1_copy"
    (root / "configs" / "tiny_v1_copy.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "tiny_v1.b1.json").read_text())
    cell.update(name="tiny_v1.b1_twice", config="tiny_v1_copy", traffic="generate_twice")
    (root / "workloads" / "tiny_v1.b1_twice.json").write_text(json.dumps(cell))
    (root / "traffic" / "generate_twice.py").write_text(DRIVER)
    (root / "metrics" / "requests.twice.py").write_text(METRIC)
    # and their entries
    bench["configs"].append({"name": "tiny_v1_copy", "source": "test",
                             "file": "portbench/configs/tiny_v1_copy.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny_v1.b1_twice", "config": "tiny_v1_copy",
                               "traffic": "generate_twice", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "tiny_v1.b1" in m.get("workloads", []):
            m["workloads"].append("tiny_v1.b1_twice")
    bench["per_layer"].append({"name": "requests.twice", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "facade and vision",
                               "moves": "caption_p95_ms", "workloads": ["tiny_v1.b1_twice"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    run = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path), str(REPO)],
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    result = json.loads(run.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"caption_p95_ms", "setup_s"}
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_the_new_metric_is_read(tmp_path):
    """The per-layer reader of a new metric file, by its name."""
    from portbench.harness import load_module

    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "requests.twice.py").write_text(METRIC)
    read = load_module(tmp_path / "metrics" / "requests.twice.py").read
    assert read({"twice": True, "latency_ms": [1.0, 2.0]}) == 2.0
    assert read({"latency_ms": [1.0]}) is None


# the body of a family module that is GPT-J under another name
GPTJ_AGAIN = '''
from pathlib import Path

from portbench.harness import load_module

_gptj = load_module(Path(__file__).with_name("gptj.py"))
globals().update({k: v for k, v in vars(_gptj).items() if not k.startswith("__")})
'''

# a second family, counting twice its training FLOPs, so that a reading
# shows the harness took it
PROBE = '''"""GPT-J, its training FLOPs counted twice."""''' + GPTJ_AGAIN + '''

def train_sample_flops(model, n, labels):
    return 2 * _gptj.train_sample_flops(model, n, labels)
'''

# a faulty one: its reference makes its weights from another seed than the
# program's
RESEEDED = '''"""GPT-J, its reference on weights of another seed."""''' + GPTJ_AGAIN + '''

def lm_logits(weights, model, embeds, tokens, bits, head_bits):
    other = _gptj.make_weights(model, 7, embeds[0].device)
    return _gptj.lm_logits(other, model, embeds, tokens, bits, head_bits)


def run_steps(weights, model, recipe, batches, seed, device, n_steps, low_precision=False):
    return _gptj.run_steps(_gptj.make_weights(model, seed + 1, device), model, recipe, batches,
                           seed, device, n_steps, low_precision)
'''

FLOPS_METRIC = '''"""Model FLOPs a training sample of the window (untraced runs)."""


def read(record):
    return record["mfu_flops"] / record["samples"] if "samples" in record else None
'''

FAMILY_SCRIPT = """
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from pathlib import Path
from portbench.harness import Cell, run_cell
root = Path(sys.argv[1]) / "portbench"
out = {}
for name in sys.argv[3:]:
    cell = Cell.load(name, Path(sys.argv[1]) / "BENCHMARK.json", root)
    out[name] = run_cell(cell, 99, 5, False, "cpu", time.perf_counter())
print(json.dumps(out))
"""

# (new configuration, the tiny one it copies with its one cell, its family)
FAMILY_CONFIGS = [("tiny_v1_probe", "tiny_v1.b1", "gptj_probe"),
                  ("tiny_v2_probe", "tiny_v2.train", "gptj_probe"),
                  ("tiny_v1_reseeded", "tiny_v1.b1", "gptj_reseeded"),
                  ("tiny_v2_reseeded", "tiny_v2.train", "gptj_reseeded")]
FAMILY_CELLS = ["tiny_v2.train"] + [f"{c}.{plain.split('.')[1]}"
                                    for c, plain, _ in FAMILY_CONFIGS]


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    """The tiny cells again on two new families, added as new files and
    entries in a temporary copy: (results by cell, the copy's files before,
    after)."""
    tmp = tmp_path_factory.mktemp("family")
    shutil.copytree(PORTBENCH, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    root = tmp / "portbench"
    for sub in ("configs", "workloads"):
        for f in (HERE / "data" / sub).iterdir():
            shutil.copy(f, root / sub / f.name)
    bench = json.loads((HERE / "data" / "BENCHMARK.json").read_text())
    before = _digest(root)

    (root / "families" / "gptj_probe.py").write_text(PROBE)
    (root / "families" / "gptj_reseeded.py").write_text(RESEEDED)
    (root / "metrics" / "flops.sample.py").write_text(FLOPS_METRIC)
    for name, plain, fam in FAMILY_CONFIGS:
        cfg = json.loads((root / "configs" / f"{plain.split('.')[0]}.json").read_text())
        cfg["name"] = name
        cfg["model"]["family"] = fam
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        cell = json.loads((root / "workloads" / f"{plain}.json").read_text())
        cell.update(name=f"{name}.{plain.split('.')[1]}", config=name)
        (root / "workloads" / f"{cell['name']}.json").write_text(json.dumps(cell))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "test"})
        bench["workloads"].append({"name": cell["name"], "config": name,
                                   "traffic": cell["traffic"], "chips": 1, "why": "test"})
        for m in bench["end_to_end"]:
            if plain in m.get("workloads", []):
                m["workloads"].append(cell["name"])
    trains = [n for n in FAMILY_CELLS if n.endswith(".train")]
    bench["end_to_end"].append({"name": "flops.sample", "unit": "FLOP", "better": "higher",
                                "bound": 0.01, "source": "host_clock", "workloads": trains})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))

    run = subprocess.run([sys.executable, "-c", FAMILY_SCRIPT, str(tmp), str(REPO),
                          *FAMILY_CELLS], capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1]), before, _digest(root)


def test_a_family_by_new_files_only(family_runs):
    """A served and a training cell on a second family run correct, the
    family's own FLOP count is the one read (twice the plain tiny cell's on
    the same seed), and no file that was there changes."""
    results, before, after = family_runs
    for name in ("tiny_v2.train", "tiny_v1_probe.b1", "tiny_v2_probe.train"):
        assert results[name]["correct"], (name, results[name]["checks"])
    assert set(results["tiny_v1_probe.b1"]["metrics"]) == {"caption_p95_ms", "setup_s"}
    flops = {n: results[n]["metrics"]["flops.sample"]["value"]
             for n in ("tiny_v2.train", "tiny_v2_probe.train")}
    assert flops["tiny_v2_probe.train"] == 2 * flops["tiny_v2.train"] > 0
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_family_with_a_reference_on_other_weights_is_not_correct(family_runs):
    results, _, _ = family_runs
    for name in ("tiny_v1_reseeded.b1", "tiny_v2_reseeded.train"):
        assert not results[name]["correct"], (name, results[name]["checks"])
