"""The comparison that decides ``correct`` fails where it should, at a size
the CPU holds: a whole run of each tiny cell with the timed path broken
underneath (a token altered where it is produced, a cache write that leaves
the state unchanged, a sampler that ignores top_p or the temperature; for
training, an optimizer step that leaves the
parameters unchanged and a step that takes half of its micro-batches)
comes out not correct; the sound run comes out correct (the tiny cells
sample at temperature 0.1: the tiny LM's logits spread too little for a
draw at temperature 1 to read apart from one at 0.7 in a few dozen draws); and the control
(the reference in the precision below the configuration's) reads above
the tiny cells' limits.  The tiny limits sit between the tiny readings
(served: program <= 2.5e-4, control >= 0.07; training, program / control:
loss <= 1.1e-4 / >= 4.8e-4, bn <= 4.7e-4 / >= 4.9e-3; the grad and change
numbers of the tiny tower's BatchNorm leaves spread to 0.45 and 0.50 in
bf16 and do not separate at this size, so their tiny limits only hold a
step that leaves the state unchanged, which reads 1)."""

import time

import pytest

from portbench.calibrate import reading
from portbench.harness import run_cell

SEED = 2 ** 31 + 12345


def _run(cell, faults=()):
    return run_cell(cell, SEED, 6, False, "cpu", time.perf_counter(), faults=faults)


@pytest.mark.parametrize("name", ["tiny_v1.b1", "tiny_v2.train"])
def test_sound_run_is_correct(tiny_cell, name):
    out = _run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in tiny_cell(name).end_to_end}
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("name,fault", [
    ("tiny_v1.b1", "token"), ("tiny_v1.b1", "stale_cache"),
    ("tiny_v1.b1", "top_p_off"), ("tiny_v1.b1", "temperature_off"),
    ("tiny_v2.train", "frozen_step"), ("tiny_v2.train", "half_batch")])
def test_broken_run_is_not_correct(tiny_cell, name, fault):
    out = _run(tiny_cell(name), (fault,))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["tiny_v1.b1", "tiny_v2.train"])
def test_control_fails(tiny_cell, name):
    cell = tiny_cell(name)
    got = reading(cell, SEED + 1, 3, "cpu", log=lambda m: None)
    limits = cell.params["correct"]["limits"]
    assert all(got[k] <= v for k, v in limits.items()), got
    assert any(got["control"][k] > v for k, v in limits.items()), got["control"]
