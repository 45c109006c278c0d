"""The check fails a run whose timed path is broken underneath: the rest of
a run is driven on the CPU at toy widths (no look for a chip), with one
fault of `benchmark.faults` planted in the program, and `correct` comes
out false, on the number that fault is for."""
from __future__ import annotations

import pytest

from benchmark import faults, harness
from benchmark.tests import toy

CASES = [
    ("token", "toy-gen", "token_gap"),
    ("token", "toy-body", "token_gap"),
    ("half_decode", "toy-body", "token_gap"),
    ("face", "toy-gen", "face_rel"),
    ("body", "toy-gen", "body_rel"),
    ("body", "toy-body", "body_rel"),
    ("frozen", "toy-vq", "update_gap_median"),
    ("frozen", "toy-pixel", "update_gap_median"),
    ("half_batch", "toy-vq", "loss_gap"),
    ("half_batch", "toy-pixel", "loss_gap"),
]


@pytest.mark.parametrize("fault,cell,number", CASES, ids=lambda v: str(v))
def test_fault_fails_the_check(toy_root, fault, cell, number):
    undo = faults.plant(fault)
    try:
        out = harness.execute(toy.spec(toy_root, cell), 4242, 1.0, False, "cpu")
    finally:
        undo()
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"], out["checks"]


@pytest.mark.parametrize("cell", ["toy-gen", "toy-body", "toy-vq", "toy-pixel"])
def test_unfaulted_passes(toy_root, cell):
    out = harness.execute(toy.spec(toy_root, cell), 4242, 1.0, False, "cpu")
    assert out["correct"], out["checks"]
