"""BENCHMARK.json and the files its names lead to."""
import json
import re

import pytest

from fdcm_bench import harness

ROOT = harness.ROOT
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["fdcm_bench"]
    assert SPEC["command"] == ["python3", "fdcm_bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configuration_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert entry["file"].startswith("fdcm_bench/configs/")
    assert config["matching"]["precision"] == "float32"
    assert set(config["limits"]) == {"score_gap", "rows_differ"}
    assert "assumed" in config


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    _, _, config, traffic = harness.resolve(SPEC, cell["name"])
    assert traffic["kind"] in ("batch", "closed_loop")
    e2e = harness.metrics_of(SPEC, cell, trace=False)
    layer = harness.metrics_of(SPEC, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in layer:                  # each per-layer metric's end-to-end metric is here
        assert m["moves"] in {e["name"] for e in e2e}


METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")


def test_names_unique_and_well_formed():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert {c["config"] for c in SPEC["workloads"]} == {c["name"] for c in SPEC["configs"]}
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_paths_hold_only_the_benchmark():
    files = [p.relative_to(ROOT).as_posix() for p in (ROOT / "fdcm_bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    assert all(re.match(r"^[A-Za-z0-9_./-]+$", f) for f in files)
