"""One run of one cell: find its files, set the program up, measure the
window, check the outputs against the reference, read the metrics.

Everything that belongs to a configuration, a traffic mix, an entry point
or a metric is found by name:

- `BENCHMARK.json` (the repository root) lists the cells, configurations
  and metrics;
- `benchmark/workloads/<cell>.json`: the traffic mix and the limits of the
  check; its ``driver`` key names `benchmark/drivers/<driver>.py`, and
  ``cudnn_deterministic`` asks for cuDNN's deterministic algorithms;
- a configuration's ``file``: its widths;
- `benchmark/metrics/<metric>.py`: a `read(run)` that returns the metric's
  value, or None where the run holds nothing to read.

A driver module has `setup(run) -> state`, `window(run, state)`,
`release(run, state)` and `check(run, state) -> [(name, value, limit)]`
(each value passes at or under its limit)."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "talkshow_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(bench: dict, name: str, root: Path = ROOT, here: Path = HERE) -> dict:
    """The cell's entry, workload file, configuration file and the names of
    the metrics it reports (end-to-end and per-layer)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(here / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    with open(root / config["file"]) as f:
        cfg = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "config": config, "workload": workload, "cfg": cfg,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"]),
            "here": here}


def metric_reader(name: str, here: Path = HERE):
    return load_module(here / "metrics" / f"{name}.py", f"benchmark_metric_{name}").read


def driver_module(name: str, here: Path = HERE):
    return load_module(here / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


@dataclass
class Run:
    """What a run measured; metric readers read it."""
    spec: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    tmp: str
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: list = field(default_factory=list)   # completed in the window
    steps: list = field(default_factory=list)      # training steps completed
    attempted: int = 0
    failed: int = 0
    profile: dict | None = None       # Profile.reduce() of the traced part, + window_s
    extra: dict = field(default_factory=dict)      # driver-specific readings
    hooks: dict = field(default_factory=dict)      # "control", "diagnose" (calibrate)

    @property
    def cfg(self) -> dict:
        return self.spec["cfg"]

    @property
    def workload(self) -> dict:
        return self.spec["workload"]


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
            hooks: dict | None = None, t_start: float | None = None, with_run: bool = False):
    """One run; returns the result object (without printing it), and the Run
    with `with_run`."""
    import torch

    age0 = process_age_s() if t_start is None else t_start
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    # cuDNN's deterministic algorithms where the entry asks for them (the
    # train CLI does); PyTorch's default, free choice, elsewhere
    torch.backends.cudnn.deterministic = bool(spec["workload"].get("cudnn_deterministic"))
    driver = driver_module(spec["workload"]["driver"], spec["here"])
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        run = Run(spec, seed, seconds, trace, device, tmp, hooks=dict(hooks or {}))
        state = driver.setup(run)
        run.setup_s = age0 + (time.perf_counter() - t0)
        driver.window(run, state)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        driver.release(run, state)
        numbers = driver.check(run, state)
    names = [m["name"] for m in (spec["per_layer"] if trace else spec["end_to_end"])]
    metrics = {}
    units = {m["name"]: m["unit"] for m in spec["per_layer"] + spec["end_to_end"]}
    for name in names:
        value = metric_reader(name, spec["here"])(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    correct = (run.failed == 0 and bool(numbers)
               and all(v == v and v <= lim for _, v, lim in numbers))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": spec["cell"]["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        out["breakdown"] = breakdown(run.profile)
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    return (out, run) if with_run else out


def breakdown(profile: dict) -> dict:
    ops = sorted(profile["kernels"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(profile["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
