"""A configuration, a workload and a metric added as files, with entries in
a BENCHMARK.json, are found and run with no edit to the harness."""
from __future__ import annotations

from benchmark import harness
from benchmark.tests import toy


def test_extra_files_found(toy_root):
    spec = toy.spec(toy_root, "toy-gen")
    assert spec["cfg"]["prior"]["dim"] == 16
    assert [m["name"] for m in spec["per_layer"]] == ["requests_done.toy"]
    reader = harness.metric_reader("requests_done.toy", spec["here"])
    assert reader(type("R", (), {"requests": [1, 2, 3]})()) == 3.0


def test_extra_cell_runs_traced(toy_root):
    out = harness.execute(toy.spec(toy_root, "toy-gen"), 2 ** 40 + 7, 1.5, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests_done.toy"]["value"] == out["attempted"] > 0
    assert list(out)[-1] == "checks"
