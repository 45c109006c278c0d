"""BENCHMARK.json and the files it names: every cell, configuration and
metric loads from its own files, and the file keeps to the benchmark's
contract (keys, names, limits)."""
from __future__ import annotations

import json
import re

import pytest

from benchmark import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    spec = harness.cell_spec(BENCH, cell)
    assert spec["cell"]["chips"] in (1, 4)
    driver = harness.driver_module(spec["workload"]["driver"])
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(driver, fn))
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"], "every cell reports a per-layer metric"
    assert spec["workload"]["limits"]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_loads(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.metric_reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        moves = e2e[metric["moves"]]
        # each cell that reads this metric reports the metric it moves
        assert set(metric["workloads"]) <= set(moves.get("workloads", cells))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(config):
    with open(harness.ROOT / config["file"]) as f:
        cfg = json.load(f)
    assert config["file"].startswith("benchmark/")
    assert cfg["reduced"] == config["reduced"] == []
    for key in ("wav2vec", "face", "vq", "audio_encoder", "prior", "precision"):
        assert key in cfg
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
