"""The harness finds every cell, configuration, traffic mix, metric and probe by its name,
and BENCHMARK.json keeps to the shape the benchmark's contract gives it."""

import importlib
import json
import re

import pytest

from perfbench import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"] == f"perfbench/configs/{entry['name']}.json"
    config = harness.load_json(harness.ROOT / entry["file"])
    assert (harness.BENCH / "datasets" / f"{config['generator']}.py").is_file()
    assert config["dtype"] in ("float32", "float64") and config["task"] in ("classifier", "regressor")


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_every_cell_loads(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"} and entry["chips"] == 1
    assert len(entry["why"]) <= 200
    cell = harness.load_cell(entry["name"])
    assert (harness.BENCH / "drivers" / f"{cell.traffic['kind']}.py").is_file()
    assert cell.limits and all(isinstance(v, float) and v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_reader_and_its_probes_resolve(metric):
    reader = harness.load_module(harness.BENCH / "metrics" / f"{metric['name']}.py")
    assert callable(reader.read)
    for probe in reader.PROBES:
        target = harness.load_json(harness.BENCH / "probes" / f"{probe}.json")["target"]
        module, attr = target.split(":")
        owner = importlib.import_module(module)
        for part in attr.split("."):
            owner = getattr(owner, part)
        assert callable(owner)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        harness.load_cell("no.such.cell", SPEC)
