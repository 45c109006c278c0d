"""The control on the card, at each cell's own size: the plain reference in
the program's place, computed in the precision below the configuration's
(float8 weights with one scale a tensor for the bf16 inference tables;
TF32 for training's float32), fails one of the cell's limits on every
seed, while the program on the same requests or steps passes them.  Run on
the card with

    python -m pytest benchmark/tests -m cuda
"""
from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.conftest import require_cuda

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3_000_000_001, 3_000_000_002, 3_000_000_003])
def test_control_fails_program_passes(cell, seed):
    require_cuda()
    spec = harness.cell_spec(BENCH, cell)
    out, run = harness.execute(spec, seed, 4.0, False, "cuda", hooks={"control": True},
                               with_run=True)
    assert out["correct"], out["checks"]
    limits = spec["workload"]["limits"]
    control = run.extra["control"]
    assert any(control[k] > limits[k] for k in control if k in limits), (control, limits)
