"""A throwaway benchmark tree at toy widths, for the CPU tests: its own
BENCHMARK.json, configuration, workloads and a metric of its own, beside
copies of the real drivers and metrics."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

TOY_CFG = {
    "wav2vec": {"hidden_size": 32, "num_layers": 2, "num_heads": 2, "intermediate_size": 64,
                "conv_dim": [16] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
                "conv_stride": [5, 2, 2, 2, 2, 2, 2], "num_conv_pos_embeddings": 16,
                "num_conv_pos_embedding_groups": 4, "layer_norm_eps": 1e-5},
    "face": {"num_classes": 4, "jaw_dim": 3, "exp_dim": 100, "feature_dim": 256},
    "vq": {"code_num": 64, "embedding_dim": 8, "num_hiddens": 32, "num_residual_layers": 2,
           "body_channels": 39, "hand_channels": 90},
    "audio_encoder": {"in_dim": 64, "num_hiddens": 16},
    "prior": {"input_dim": 64, "dim": 16, "n_layers": 3, "n_classes": 4, "hidden": 32},
    "precision": {"decode_tables": "bfloat16"},
    "reduced": [],
}

#: CPU limits: the program's plain path against the reference, both float32
TOY_LIMITS = {"token_gap": 1e-3, "face_rel": 1e-4, "body_rel": 1e-4, "fixed_abs": 0.0}


def workload(driver: str, samples: int) -> dict:
    lim = dict(TOY_LIMITS) if driver == "generate" else {
        k: TOY_LIMITS[k] for k in ("token_gap", "body_rel")}
    return {"driver": driver, "clip_seconds": [1, 2], "variants": 1, "speakers": [0, 1, 2, 3],
            "num_samples": samples, "noise_given_per_block": 2, "check_noise_given": 2,
            "check_others": 1, "limits": lim}


def make_tree(root: Path, extra_metric: bool = True) -> Path:
    """Write the toy tree under root; returns its `benchmark` directory."""
    here = root / "benchmark"
    for sub in ("configs", "workloads", "metrics", "drivers"):
        (here / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("drivers", "metrics"):
        for f in (harness.HERE / sub).glob("*.py"):
            shutil.copy(f, here / sub / f.name)
    json.dump(TOY_CFG, open(here / "configs" / "toy.json", "w"))
    json.dump(workload("generate", 1), open(here / "workloads" / "toy-gen.json", "w"))
    json.dump(workload("generate_body", 3), open(here / "workloads" / "toy-body.json", "w"))
    for cell, driver in (("toy-vq", "train_vq"), ("toy-pixel", "train_pixel")):
        lim = {"loss_gap": 1e-5, "grad_gap_median": 1e-4, "update_gap_median": 1e-3}
        if driver == "train_pixel":
            lim["token_mismatch"] = 0.0
        json.dump({"driver": driver, "cudnn_deterministic": True, "rep6d": False, "batch": 4, "window": 16,
                   "pool_batches": 4, "limits": lim},
                  open(here / "workloads" / f"{cell}.json", "w"))
    cells = ["toy-gen", "toy-body", "toy-vq", "toy-pixel"]
    per_layer = []
    if extra_metric:
        (here / "metrics" / "requests_done.toy.py").write_text(
            "def read(run):\n    return float(len(run.requests)) or None\n")
        per_layer.append({"name": "requests_done.toy", "unit": "requests", "better": "higher",
                          "source": "host_clock", "layer": "test", "moves": "motion_s_per_s",
                          "workloads": ["toy-gen", "toy-body"]})
    bench = {
        "command": ["python3", "-m", "benchmark.run"], "paths": ["benchmark"], "run_seconds": 2,
        "configs": [{"name": "toy", "source": "test", "file": "benchmark/configs/toy.json",
                     "reduced": [], "why": "toy widths"}],
        "workloads": [{"name": c, "config": "toy", "traffic": c, "chips": 1, "why": "test"}
                      for c in cells],
        "end_to_end": [
            {"name": "clip_ms_p95", "unit": "ms", "better": "lower", "bound": 0.1,
             "source": "host_clock", "workloads": ["toy-gen", "toy-body"]},
            {"name": "motion_s_per_s", "unit": "s/s", "better": "higher", "bound": 0.1,
             "source": "host_clock", "workloads": ["toy-gen", "toy-body"]},
            {"name": "train_frames_per_s", "unit": "frames/s", "better": "higher",
             "bound": 0.1, "source": "host_clock", "workloads": ["toy-vq", "toy-pixel"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": per_layer,
    }
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return here


def spec(root: Path, cell: str) -> dict:
    here = root / "benchmark"
    return harness.cell_spec(harness.load_benchmark(root), cell, root=root, here=here)
