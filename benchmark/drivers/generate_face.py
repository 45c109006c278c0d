"""Entry `Pipeline.generate_face(wav16k)`: the face stage alone on a clip
already in host memory (no file read), one client in a closed loop at
batch 1, on a configuration whose face generator is WavLM
(`talkshow-wavlm-large`): K3 in its LayerNorm mode and K2 in its pre-norm
mode with the gated relative bias do the device work.

Clips: the workload's `clip_seconds` x `variants`, drawn by `traffic.py`'s
generator (written as 16-bit wavs at set-up and read back once into host
memory); the stream sends each block of every clip once, in an order from
the seed.  The program is built from `wavlm_weights.draw` and holds only
the face generator (the entry reads no body part).

The check, once the window has closed and the program is freed: a sample
drawn from the seed of the requests whose outputs were kept (every length,
`check_per_length` of each, the longest first) replayed by
`reference/wavlm.py`; ``face_rel`` is the worst ||served - ref|| / ||ref||
over all frames of jaw and expression.  With the "control" hook, the
control (the reference on float8 weights) is read on the same clips.

Spans of the traced run: `Pipeline.generate_face` (face_stage)."""
from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import traffic, wavlm_weights
from benchmark.gen import read_wav
from benchmark.reference import wavlm as ref_wavlm

#: the share of requests whose outputs are kept beyond the first of each length
KEEP = 0.05
#: outputs kept of each clip length first, whatever the draw
KEEP_FIRST = 4


class State:
    pass


def program_config(cfg: dict):
    """The program's `Wav2Vec2Config` of the configuration's encoder (a
    program without WavLM's keys raises here, before anything is drawn)."""
    from talkshow_torch.models.wav2vec import Wav2Vec2Config
    wc = cfg["wav2vec"]
    return Wav2Vec2Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in wc.items()})


def build_program(cfg: dict, w: dict, device: str):
    """A `Pipeline` holding the WavLM face generator with the weights `w`
    ({"face": state dict}); no body part (`generate_face` reads none)."""
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.pipeline import Pipeline

    fc = cfg["face"]
    w2v = program_config(cfg)
    with torch.device("meta"):
        face = FaceGenerator(w2v, fc["num_classes"], fc["jaw_dim"], fc["exp_dim"])
    face = face.to_empty(device=device).eval()
    face.load_state_dict(w["face"])
    return Pipeline(face, None, torch.device(device), num_classes=fc["num_classes"])


def setup(run) -> State:
    """Weights, program, clips in host memory, and two calls of each clip
    length (every shape the stream sends)."""
    st = State()
    program_config(run.cfg)
    st.weights = wavlm_weights.draw(run.cfg, run.seed, run.device)
    st.pipe = build_program(run.cfg, st.weights, run.device)
    st.clips = traffic.make_clips(run.workload, run.seed, os.path.join(run.tmp, "clips"))
    st.audio = {c.path: read_wav(c.path) for c in st.clips}
    by_len = {}
    for c in st.clips:
        by_len.setdefault(c.seconds, c)
    for c in by_len.values():
        for _ in range(2):
            st.pipe.generate_face(st.audio[c.path])
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return st


def window(run, st: State) -> None:
    """The closed loop of one client for `run.seconds`: a request completes
    inside the window or does not count.  A traced run's window leaves out
    the pauses in which the profiler wrote its traces."""
    from benchmark.trace import Spans, WindowProfile

    spans = prof = None
    if run.trace:
        spans = Spans(cuda=run.device == "cuda")
        spans.wrap(st.pipe, "generate_face", "face_stage")
        prof = WindowProfile(run.seconds, run.device == "cuda", run.tmp)
    rng = np.random.default_rng(np.random.SeedSequence([int(run.seed), 4]))
    stream = traffic.requests(run.workload, st.clips, run.seed)
    kept: dict = {}
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    reported = False
    for req in stream:
        now = time.perf_counter()
        if now >= t_end:
            break
        profiled = prof is not None and prof.tick(now - t0)
        wav = st.audio[req.clip.path]
        if spans is not None:
            spans.begin_request()
        t1 = time.perf_counter()
        try:
            out = st.pipe.generate_face(wav)
        except Exception:                # a failed request: counted, the loop goes on
            if not reported:
                traceback.print_exc(file=sys.stderr)
                reported = True
            if time.perf_counter() <= t_end:
                run.attempted += 1
                run.failed += 1
            continue
        t2 = time.perf_counter()
        if t2 > t_end:
            break
        run.attempted += 1
        rec = {"index": req.index, "clip": req.clip, "latency_s": t2 - t1,
               "motion_s": req.clip.seconds, "samples": 1, "wav_len": req.clip.samples,
               "profiled": profiled}
        n = kept.get(req.clip.seconds, 0)
        if n < KEEP_FIRST or rng.random() < KEEP:
            rec["out"] = out
            kept[req.clip.seconds] = n + 1
        if spans is not None:
            rec["spans"] = spans.end_request()
        run.requests.append(rec)
    run.window_s = run.seconds
    if prof is not None:
        spans.restore()
        run.profile = prof.finish()
        run.window_s -= prof.paused_s


def release(run, st: State) -> None:
    del st.pipe
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return float("inf")
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def sample(run, st: State) -> list:
    """Up to `check_per_length` kept requests of each clip length, in an
    order drawn from the seed, the longest clip first."""
    rng = np.random.default_rng(np.random.SeedSequence([int(run.seed), 5]))
    kept = [r for r in run.requests if "out" in r]
    order = [kept[i] for i in rng.permutation(len(kept))]
    picked: dict = {}
    for r in order:
        got = picked.setdefault(r["clip"].seconds, [])
        if len(got) < run.workload["check_per_length"]:
            got.append(r)
    return [r for sec in sorted(picked, reverse=True) for r in picked[sec]]


def check(run, st: State) -> list:
    """[("face_rel", worst reading, limit)] over the sample; with the
    "control" hook, the control's worst reading goes to
    run.extra["control"]."""
    ref = ref_wavlm.Reference(run.cfg, st.weights, run.device)
    control = None
    if run.hooks.get("control"):
        control = ref_wavlm.Reference(run.cfg, st.weights, run.device,
                                      quantize=wavlm_weights.fp8_rounded)
    picked = sample(run, st)
    worst = worst_c = 0.0
    for rec in picked:
        wav = torch.as_tensor(st.audio[rec["clip"].path], device=run.device)
        want = ref.face(wav)
        worst = max(worst, _rel(torch.as_tensor(np.asarray(rec["out"]), device=run.device), want))
        if control is not None:
            worst_c = max(worst_c, _rel(control.face(wav), want))
    lengths = {r["clip"].seconds for r in picked}
    if len(lengths) < len(run.workload["clip_seconds"]):
        worst = float("inf")             # a clip length went unchecked
    run.extra["checked"] = len(picked)
    run.extra["control"] = {"face_rel": worst_c} if control is not None else {}
    return [("face_rel", worst, run.workload["limits"]["face_rel"])]
