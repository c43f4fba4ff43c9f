"""Fixtures of the harness's CPU tests: a harness root made of the real
traffic drivers and metric readers with the tiny test configurations and
cells (``tests/data``), so the tests drive the harness as a run does, at a
size the CPU holds."""

import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
REPO = PORTBENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def make_root(tmp: Path) -> Path:
    """A portbench-like root in ``tmp``: traffic/, metrics/ and families/
    copied from the harness, configs/ and workloads/ from the test data."""
    root = tmp / "portbench"
    for sub in ("traffic", "metrics", "families"):
        shutil.copytree(PORTBENCH / sub, root / sub)
    for sub in ("configs", "workloads"):
        shutil.copytree(HERE / "data" / sub, root / sub)
    shutil.copy(HERE / "data" / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def tiny_cell(tiny_root):
    from portbench.harness import Cell

    def load(name):
        return Cell.load(name, tiny_root.parent / "BENCHMARK.json", tiny_root)

    return load
