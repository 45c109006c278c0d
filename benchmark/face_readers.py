"""Arithmetic of the per-layer metrics of the WavLM face cell
(`metrics/*.face.py`): K2's and K3's shares of their rooflines and the
face's share of the bf16 peak.  Each returns None where the run holds
nothing to read (a program without these kernels, an untraced run)."""
from __future__ import annotations

import re

from benchmark import counts, wavlm_counts

#: the device kernels of each stage in its WavLM mode: K2's GEMMs
#: (instance 2 of the shared GEMM), gated attention and LayerNorm + gate;
#: K3's layer 0, GEMMs (instance 3) and LayerNorm + gelu
KERNELS = {
    "encoder": re.compile(r"wgmma_gemm_kernel<\d+, [^,<>]+, 2>|attention_(tc|f32)_kernel<[^>]*true>"
                          r"|ln_gate_kernel"),
    "extractor": re.compile(r"wgmma_gemm_kernel<\d+, [^,<>]+, 3>|conv0_ln_kernel|ln_gelu_kernel"),
}


def device_s(run, stage: str) -> float:
    """Seconds of the stage's kernels in the traced run's device part."""
    pat = KERNELS[stage]
    return sum(s for name, s in run.profile["kernels"].items() if pat.search(name))


def roofline_pct(run, stage: str):
    """100 x the least time of the profiled requests' work of `stage`
    (`wavlm_counts`, bytes or FLOPs, whichever binds) over the stage's
    device time in the trace."""
    if not run.profile:
        return None
    dev = device_s(run, stage)
    if dev <= 0:
        return None
    prof = [r for r in run.requests if r.get("profiled")]
    if stage == "encoder":
        least = sum(wavlm_counts.encoder_least_s(run.cfg, wavlm_counts.frames(r["wav_len"]))
                    for r in prof)
    else:
        least = sum(wavlm_counts.extractor_least_s(run.cfg, r["wav_len"]) for r in prof)
    return 100.0 * least / dev if least > 0 else None


def face_mfu_pct(run):
    """100 x the WavLM face's model FLOPs of the window's completed requests
    over the window's seconds at the bf16 dense peak."""
    if not run.requests:
        return None
    flops = sum(wavlm_counts.face_flops(run.cfg, r["wav_len"]) for r in run.requests)
    return 100.0 * flops / (run.window_s * counts.BF16_FLOP_S)
