"""Readings for the limits of a cell's check: the program's on many seeds
and the control's (the reference with float8 weights in the program's
place) on the same requests, in one process.

    python -m benchmark.calibrate --workload <cell> --seeds 11,12,13 --seconds 4

prints one JSON line a seed: {"seed", "program": {number: reading},
"control": {number: reading}, "checked"}.  `--fault <name>` plants one of
`benchmark.faults` in the program first (its readings are a fault's).  The limits in the workload
file lie between the largest program reading and the smallest control
reading (PERF.md gives both)."""
from __future__ import annotations

import argparse
import json
import os
import sys

os.environ["OMP_NUM_THREADS"] = "1"      # the load of a benchmark run (run.py)
os.environ["MKL_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    from benchmark import harness
    p = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--fault", default=None, help="a fault of benchmark.faults to plant")
    p.add_argument("--diagnose", type=int, default=0,
                   help="1: also print the worst leaves and the losses of a training cell")
    args = p.parse_args(argv)
    if args.fault:
        from benchmark import faults
        faults.plant(args.fault)
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res, run = harness.execute(spec, seed, args.seconds, False, "cuda",
                                   hooks={"control": bool(args.control),
                                          "diagnose": bool(args.diagnose)},
                                   with_run=True)
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": res["correct"],
                          "program": {k: v["value"] for k, v in res["checks"].items()},
                          "control": run.extra.get("control", {}),
                          "checked": run.extra.get("checked"),
                          **{k: run.extra[k] for k in ("worst", "loss", "code_flips",
                                                           "token_mismatch_first_steps")
                             if k in run.extra}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
