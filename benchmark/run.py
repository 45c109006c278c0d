"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device, with --trace 1 breakdown,
and last the numbers the check compared, each beside its limit; those
numbers are also the last lines of standard error.  Exits non-zero, with no
result, without enough CUDA devices, or if JAX, flax or the JAX package is
loaded once the window has closed."""
from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("USE_FLAX", "0")   # keep transformers, if anything loads it, off flax
# one host thread for PyTorch's and the BLAS's CPU pools, set before torch is
# imported: on a host shared with other processes the default pools made the
# generate cells ~12 % slower and their runs spread wider
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    from benchmark import harness

    t_start = harness.process_age_s()
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    import torch
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    result = harness.execute(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                             t_start=t_start)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
