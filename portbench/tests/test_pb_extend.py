"""A later change adds a configuration, a cell, a traffic driver and a
per-layer metric as new files (and entries in BENCHMARK.json) only: in a
temporary copy of the harness, the harness finds them by name and runs the
new cell, and no file that was there changes."""

import hashlib
import json
import shutil
import subprocess
import sys

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
