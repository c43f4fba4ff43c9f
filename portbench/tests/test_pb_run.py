"""The entry point's refusals, and (on the card) a whole run of each tiny
cell through the CUDA kernels."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from conftest import PORTBENCH, REPO

CMD = [sys.executable, "portbench/run.py", "--workload", "magma_v1.int8_b1", "--seed",
       "3000000000", "--seconds", "1", "--trace", "0"]


def _has_card():
    import torch

    return torch.cuda.is_available()


def test_no_card_no_result():
    if _has_card():
        pytest.skip("this machine has a CUDA device")
    run = subprocess.run(CMD, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout.strip() == ""
    assert "CUDA" in run.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the files under paths."""
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    run = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert run.returncode != 0 and run.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny_v1.b1", "tiny_v2.train"])
def test_tiny_cell_on_the_card(tiny_cell, name):
    if not _has_card():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda portbench/tests)")
    from portbench.harness import run_cell

    # the profiler's first start on the card takes seconds of the window: 20 s
    # leave the untraced part enough requests for the comparison's floors
    out = run_cell(tiny_cell(name), 2 ** 31 + 99, 20, True, "cuda", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    json.dumps(out)
