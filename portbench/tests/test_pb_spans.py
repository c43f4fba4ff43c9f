"""``portbench/spans.py`` and the metrics that read it, on synthetic Chrome
traces whose busy intervals, program ranges and idle gaps are known."""

import json

import pytest

from conftest import PORTBENCH
from portbench import spans
from portbench.harness import load_module

US = 1e-6


def _x(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid}


def _serve_trace():
    """Busy [100, 300], [500, 600], [650, 700] (a kernel, an overlapping one,
    a copy); pb.generate [50, 900]; the program's ranges below; one range
    crossing the slice's end, one device range outside it."""
    return {"traceEvents": [
        _x("pb.slice", 0, 1000),
        _x("pb.generate", 50, 850),
        _x("k_a", 100, 100, "kernel"), _x("k_b", 150, 150, "kernel"),
        _x("k_c", 500, 100, "kernel"), _x("Memcpy HtoD", 650, 50, "gpu_memcpy"),
        _x("k_late", 1200, 100, "kernel"),
        _x("lm.generate", 60, 820),
        _x("lm.prefill", 60, 340), _x("kernel.int8", 70, 20),
        _x("lm.prefill", 60, 340, "gpu_user_annotation"),  # the device-side copy: not a span
        _x("lm.decode_step", 400, 300), _x("lm.sample", 400, 50),
        _x("lm.decode_forward", 460, 230),
        _x("lm.decode_step", 700, 180), _x("lm.sample", 700, 20),
        _x("kernel.k8", 990, 110),
        _x("aten::mm", 120, 10, "cpu_op"),
    ]}


def test_counts_wall_and_idle_inside_the_slice():
    s = spans.Spans(_serve_trace())
    assert s.busy == [[100, 300], [500, 600], [650, 700]]
    assert s.count(("lm.prefill",)) == 1 and s.count(("kernel.",)) == 2
    assert s.wall_s(("kernel.",)) == pytest.approx(30 * US)  # k8 clipped to the slice
    assert s.idle_s(("lm.prefill",)) == pytest.approx(140 * US)
    # the union of both steps [400, 880] less 150 busy
    assert s.idle_s(("lm.decode_step",)) == pytest.approx(330 * US)
    assert s.idle_s(("lm.sample", "lm.decode_forward")) == pytest.approx(160 * US)
    summary = s.summary()
    assert set(summary) == {"lm.generate", "lm.prefill", "lm.decode_step", "lm.sample",
                            "lm.decode_forward", "kernel.int8", "kernel.k8"}
    assert summary["lm.decode_step"]["count"] == 2
    assert summary["lm.generate"]["idle_s"] == pytest.approx(470 * US)


def test_leaves_and_the_cover_of_the_benchmarks_range():
    s = spans.Spans(_serve_trace())
    assert sorted(r[2] for r in s.leaves()) == sorted(
        ["lm.prefill", "kernel.int8", "lm.sample", "lm.decode_forward", "lm.sample",
         "kernel.k8"])
    cover = s.leaf_cover("generate")
    assert cover["idle_s"] == pytest.approx(500 * US)
    assert cover["under_leaf_s"] == pytest.approx(300 * US)
    assert cover["rest"] == pytest.approx({"no program span": 30 * US,
                                           "lm.decode_step": 170 * US})


def _train_trace():
    return {"traceEvents": [
        _x("pb.slice", 0, 2000), _x("pb.train_step", 10, 1900),
        _x("k", 100, 400, "kernel"), _x("k", 700, 500, "kernel"), _x("k", 1500, 100, "kernel"),
        _x("train.step", 20, 1800),
        _x("train.micro", 30, 600), _x("train.forward", 30, 300), _x("train.backward", 330, 300),
        _x("kernel.flash_bwd_dq", 340, 100, tid=2),  # the autograd thread
        _x("train.micro", 630, 600), _x("train.forward", 630, 300),
        _x("train.backward", 930, 300),
        _x("train.optimizer", 1300, 250), _x("train.loss_read", 1550, 200),
    ]}


def _read(monkeypatch, tmp_path, trace, name, record=None):
    monkeypatch.setattr(spans, "TRACE_DIR", tmp_path)
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    record = record if record is not None else {"trace": {"busy_s": 1.0}}
    return load_module(PORTBENCH / "metrics" / f"{name}.py").read(record)


def test_the_training_metrics(monkeypatch, tmp_path):
    rec = {"trace": {"busy_s": 1.0}}
    assert _read(monkeypatch, tmp_path, _train_trace(), "optim_ms.train", rec) == \
        pytest.approx(0.25)
    # forward and backward [30, 1230] less busy [100, 500] and [700, 1200]
    assert _read(monkeypatch, tmp_path, _train_trace(), "fwd_bwd_idle_ms.train", rec) == \
        pytest.approx(0.3)
    # read once a run: the record keeps the first reading
    assert isinstance(rec["program_spans"], spans.Spans)


def test_the_serving_metrics_and_the_counters(monkeypatch, tmp_path):
    from magma_tpu_torch import observability as obs

    obs.take()
    with obs.tracing():
        obs.count("lm.prompt_positions", 149)
        obs.count("lm.prefill_positions", 192)
    rec = {"trace": {"busy_s": 1.0}}
    got = {m: _read(monkeypatch, tmp_path, _serve_trace(), m, rec)
           for m in ("prefill_idle_ms.b1", "decode_idle_ms_tok.b1", "launch_host_us.b1",
                     "prefill_useful.b1")}
    assert got == pytest.approx({"prefill_idle_ms.b1": 0.14, "decode_idle_ms_tok.b1": 0.165,
                                 "launch_host_us.b1": 15.0,
                                 "prefill_useful.b1": 100 * 149 / 192})
    assert obs.take() == ([], {})  # taken once, by the first reading


def test_a_program_without_the_tracer_reads_none(monkeypatch, tmp_path):
    """The parent's program: no program range in the trace, no ``take``."""
    from magma_tpu_torch import observability as obs

    monkeypatch.delattr(obs, "take")
    bare = {"traceEvents": [e for e in _serve_trace()["traceEvents"] + _train_trace()[
        "traceEvents"][2:] if not e["name"].startswith(spans.PROGRAM)]}
    rec = {"trace": {"busy_s": 1.0}}
    for m in ("optim_ms.train", "fwd_bwd_idle_ms.train", "prefill_idle_ms.b1",
              "decode_idle_ms_tok.b1", "launch_host_us.b1", "prefill_useful.b1"):
        assert _read(monkeypatch, tmp_path, bare, m, rec) is None, m
    # an untraced run has no slice: nothing is read
    assert _read(monkeypatch, tmp_path, bare, "prefill_useful.b1", {"trace": None}) is None
