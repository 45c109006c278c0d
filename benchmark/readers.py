"""Arithmetic the metric readers share (`benchmark/metrics/<name>.py` each
call one of these with their own arguments).  A reader returns None where
the run holds nothing for it to read; a share of a peak or a roofline is
never made up as 0."""
from __future__ import annotations

import numpy as np

from benchmark import counts


def latency_p95_ms(run):
    lat = [r["latency_s"] for r in run.requests]
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None


def motion_rate(run):
    if not run.requests:
        return None
    return sum(r["motion_s"] for r in run.requests) / run.window_s


def train_rate(run):
    if not run.steps:
        return None
    return sum(s["frames"] for s in run.steps) / run.window_s


def span_ms(run, span: str):
    """Mean ms of `span` per completed request (CUDA events)."""
    vals = [r["spans"].get(span, 0.0) for r in run.requests if "spans" in r]
    return float(np.mean(vals)) if vals and any(vals) else None


def ar_decode_roofline_pct(run):
    """100 x the least time of the profiled requests' decodes (from the
    prior's widths) over the device time of the decode kernel in the trace."""
    if not run.profile:
        return None
    dev_s = sum(s for name, s in run.profile["kernels"].items() if "decode_kernel" in name)
    if dev_s <= 0:
        return None
    pr, A = run.cfg["prior"], run.cfg["audio_encoder"]["num_hiddens"]
    tdt = run.cfg["precision"]["decode_tables"]
    least = sum(counts.ar_decode_least_s(pr, A, n["H"], n["B"], tdt, n["noise_given"])
                for r in run.requests if r.get("profiled")
                for n in r.get("notes", []) if n.get("span") == "ar_decode")
    return 100.0 * least / dev_s if least > 0 else None


def generate_mfu_pct(run, with_face: bool):
    """100 x the model FLOPs of the window's completed requests over the
    window's seconds at the bf16 dense peak."""
    if not run.requests:
        return None
    flops = sum(counts.generate_flops(run.cfg, r["samples"], r["wav_len"],
                                      counts.mfcc_frames(r["wav_len"]), with_face)
                for r in run.requests)
    return 100.0 * flops / (run.window_s * counts.BF16_FLOP_S)


def device_idle_pct(run):
    """100 x the share of the profiled wall time that no kernel, copy or fill
    covered (the union of their intervals)."""
    if not run.profile or run.profile["window_s"] <= 0 or run.profile["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - run.profile["busy_s"] / run.profile["window_s"])


def train_mfu_pct(run):
    """100 x the model FLOPs of the window's steps over the window's seconds
    at the bf16 dense peak."""
    if not run.steps:
        return None
    flops = counts.train_flops(run.cfg, run.workload) * len(run.steps)
    return 100.0 * flops / (run.window_s * counts.BF16_FLOP_S)


def launches_per_step(run):
    """Kernels the profiler saw per step taken while it ran."""
    n = sum(1 for s in run.steps if s.get("profiled"))
    if not run.profile or not n:
        return None
    return run.profile["launches"] / n
