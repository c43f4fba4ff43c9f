"""BENCHMARK.json against the contract's form: names, units, keys, files
found by name, and each per-layer metric's ``moves`` reported wherever the
metric is."""

import json
import math
import re

from conftest import PORTBENCH, REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _cells_of(m):
    return m.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(set(metric_names)) == len(metric_names)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_and_one_more_end_to_end_and_a_per_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if w["name"] in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in _cells_of(m) for m in BENCH["per_layer"]), w["name"]


def test_moves_is_reported_wherever_the_metric_is():
    e2e = {m["name"]: set(_cells_of(m)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert set(_cells_of(m)) <= e2e[m["moves"]], m["name"]


def test_one_layer_name_a_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 and "\n" not in x for x in layers)
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_files_found_by_name():
    for w in BENCH["workloads"]:
        cell = json.loads((PORTBENCH / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["why"] == w["why"] and cell["chips"] == w["chips"]
        assert (PORTBENCH / "traffic" / f"{w['traffic']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (PORTBENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_configs_state_what_the_program_builds():
    """Each configuration file against its entry, then, through its
    language-model family's ``check_config``, against what the program
    builds from its ``yml``."""
    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.models.magma import Magma
    from portbench.harness import family

    for c in BENCH["configs"]:
        f = json.loads((REPO / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        program = Magma(MultimodalConfig(**f["yml"]), device="cpu", init_weights=False)
        family(f["model"]).check_config(f, program)


def test_run_seconds_fits_the_check():
    # 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare
    total = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    assert not math.isnan(total)
