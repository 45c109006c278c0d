"""Entry `MotionServer(pipe, bucket_frames=32, max_batch=8)` (`submit`,
`flush`) on `talkshow-3d`, under open-loop arrivals: the service that
animates many users' clips as they arrive.

Traffic (the workload file): Poisson arrivals drawn from the seed at a
mean of ``rate_per_s``, in bursts: bursts start as a Poisson process of one
per ``burst_every_s`` seconds, each lasting ``burst_s`` at
``burst_factor`` x the mean rate, and between bursts the rate is
``base_factor`` x the mean.  Each request's clip length is drawn
log-uniform on ``clip_seconds_range``, and its clip is that many samples
of one of ``sources`` speech recordings (`traffic.speech`, 16-bit PCM, as
long as the range's top) from an offset drawn with it; its speaker is one
of ``speakers``.

The loop: whenever the server is idle, every request now due is submitted
and `flush` serves them; if nothing is due, the loop waits for the next
arrival.  A request's latency runs from its due time to the return of the
flush that served it.  No flush starts past the window; the one running
at its end is waited for and counted, and the window is taken to its end.
Set-up warms every bucket of clips up to the range's top at max_batch,
with the program's noise and with given noise.

Every ``noise_given_every``-th flush samples with gumbel blocks the
benchmark draws (the server's ``noise`` hook), so its tokens are
argmax(logit + gumbel), which the check replays.  The tokens of each group
are taken where the server hands them to nothing (its call of
`generate_conv_poses`), so the server serves what it serves without the
check.

The check (gen-3d-s1's, on a sample of served rows drawn from the seed):
``token_gap`` teacher-forced on the served tokens, on the reference's MFCC
of the padded row the server featurised; ``face_rel`` on the real frames
against the reference's face stage of the unpadded clip; ``body_rel`` and
``fixed_abs`` of the assembled motion."""
from __future__ import annotations

import math
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import gen, traffic, weights
from benchmark.reference import audio as ref_audio
from benchmark.reference import model as ref_model
from benchmark.reference import pose as ref_pose

#: the share of requests served with the program's own noise whose outputs are kept
KEEP_OTHERS = 0.1


class State:
    pass


def arrivals(workload: dict, seed: int, seconds: float) -> list:
    """Due times (s from the window's start) over `seconds`: Poisson
    arrivals thinned from the bursts' rate.  The burst starts are a Poisson
    process from `burst_s` before the window, so a burst may run into it."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 6]))
    mean = workload["rate_per_s"]
    hi, lo = workload["burst_factor"] * mean, workload["base_factor"] * mean
    starts, t = [], -workload["burst_s"]
    while True:
        t += rng.exponential(workload["burst_every_s"])
        if t >= seconds:
            break
        starts.append(t)
    starts = np.asarray(starts)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / hi)
        if t >= seconds:
            return out
        burst = bool(((starts <= t) & (t < starts + workload["burst_s"])).any())
        if rng.random() * hi < (hi if burst else lo):
            out.append(t)


def sources(workload: dict, seed: int) -> list:
    """`sources` int16 speech recordings as long as the range's top."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 2]))
    top = workload["clip_seconds_range"][1]
    return [np.clip(np.round(traffic.speech(top, rng) * 32767.0), -32768, 32767).astype(np.int16)
            for _ in range(workload["sources"])]


def clips(workload: dict, seed: int, n: int, source_len: int) -> list:
    """n requests' clips [(source, offset, samples)]: lengths log-uniform on
    the range, each cut from a source drawn with it at an offset drawn
    with it."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
    a, b = workload["clip_seconds_range"]
    sec = np.exp(rng.uniform(math.log(a), math.log(b), size=n))
    samples = np.minimum(np.round(sec * traffic.RATE).astype(np.int64), source_len)
    src = rng.integers(workload["sources"], size=n)
    off = rng.integers(0, source_len - samples + 1)
    return [(int(s), int(o), int(m)) for s, o, m in zip(src, off, samples)]


def pcm(st, clip) -> np.ndarray:
    """The int16 samples of a request's clip (source, offset, samples)."""
    s, o, m = clip
    return st.sources[s][o:o + m]


def setup(run) -> State:
    from talkshow_torch import serving
    from talkshow_torch.serving import MotionServer

    st = State()
    wl = run.workload
    st.weights = weights.draw(run.cfg, run.seed, run.device)
    st.pipe = gen.build_program(run.cfg, st.weights, run.device)
    st.K = run.cfg["prior"]["input_dim"]
    st.sources = sources(wl, run.seed)
    st.server = MotionServer(st.pipe, bucket_frames=wl["bucket_frames"],
                             max_batch=wl["max_batch"])
    st.bucket_frames = wl["bucket_frames"]
    st.blocks = {}
    st.rows = {}          # rid -> (tokens of its group, row, noise block key or None)
    st.given = False

    def noise(base, bucket, index, rows):
        key = (base, bucket, index)
        if key not in st.blocks:
            st.blocks[key] = gen.gumbel(weights.seed63(*key), rows, wl["max_batch"], st.K,
                                        run.device)
        return st.blocks[key]

    st.noise = noise
    inner_decode = serving.generate_conv_poses

    def decode(*args, **kwargs):
        conv, tokens = inner_decode(*args, **kwargs)
        st.last_tokens = tokens
        return conv, tokens

    st.restore = lambda: setattr(serving, "generate_conv_poses", inner_decode)
    serving.generate_conv_poses = decode
    inner_group = st.server._run_group

    def run_group(bucket, B, requests, base=0, index=0):
        fut = inner_group(bucket, B, requests, base, index)
        for j, r in enumerate(requests or ()):
            if r.rid in st.keep:
                st.rows[r.rid] = (st.last_tokens, j,
                                  (base, bucket, index) if st.given else None)
        return fut

    st.server._run_group = run_group
    st.keep = set()
    for given in (False, True):
        st.server.noise = noise if given else None
        st.server.warmup(max_clip_seconds=wl["clip_seconds_range"][1])
    st.server.noise = None
    st.blocks.clear()
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return st


def window(run, st: State) -> None:
    """The open loop for `run.seconds` (see the module docstring).  A traced
    run's window leaves out the pauses in which the profiler wrote its
    traces."""
    from benchmark.trace import WindowProfile

    wl = run.workload
    prof = WindowProfile(run.seconds, run.device == "cuda", run.tmp) if run.trace else None
    rng = np.random.default_rng(np.random.SeedSequence([int(run.seed), 7]))
    due = arrivals(wl, run.seed, run.seconds)
    picks = clips(wl, run.seed, len(due), len(st.sources[0]))
    speakers = rng.choice(wl["speakers"], size=len(due))
    flush_seeds = rng.integers(0, 2 ** 62, size=len(due) + 1)
    pending: dict = {}
    nxt = nflush = 0
    reported = False
    t0 = time.perf_counter()
    t_end = last = t0 + run.seconds
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if nxt >= len(due):
            time.sleep(max(0.0, t_end - now))
            break
        if t0 + due[nxt] > now:
            time.sleep(min(t0 + due[nxt], t_end) - now)
            continue
        profiled = prof is not None and prof.tick(now - t0)
        given = nflush % wl["noise_given_every"] == 0
        while nxt < len(due) and t0 + due[nxt] <= now:
            x = pcm(st, picks[nxt])
            rid = st.server.submit(x, speaker=int(speakers[nxt]))
            pending[rid] = {"due": t0 + due[nxt], "clip": picks[nxt],
                            "speaker": int(speakers[nxt]), "motion_s": len(x) / traffic.RATE,
                            "samples": 1, "wav_len": len(x), "profiled": profiled,
                            "given": given}
            if rng.random() < (wl["keep_given_share"] if given else KEEP_OTHERS):
                st.keep.add(rid)
            nxt += 1
        st.given = given
        st.server.noise = st.noise if given else None
        try:
            out = st.server.flush(seed=int(flush_seeds[nflush]))
        except Exception:            # a failed flush: its requests counted, the loop goes on
            if not reported:
                traceback.print_exc(file=sys.stderr)
                reported = True
            run.attempted += len(st.server._queue)
            run.failed += len(st.server._queue)
            st.server._queue.clear()
            pending.clear()
            nflush += 1
            continue
        done = time.perf_counter()
        nflush += 1
        if given:        # keep the gumbel blocks of kept rows only
            need = {row[2] for row in st.rows.values()}
            st.blocks = {k: v for k, v in st.blocks.items() if k in need}
        for rid, motion in out.items():
            rec = pending.pop(rid)
            rec["latency_s"] = done - rec["due"]
            if rid in st.keep:
                rec["out"] = motion
                rec["rid"] = rid
            run.requests.append(rec)
            run.attempted += 1
        if done >= t_end:
            last = done
            break
    run.extra["flushes"] = nflush
    run.window_s = last - t0
    if prof is not None:
        run.profile = prof.finish()
        run.window_s -= prof.paused_s


def release(run, st: State) -> None:
    st.restore()
    del st.server, st.pipe
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sample(run, st: State) -> list:
    """Up to `check_noise_given` served rows with given noise, the longest
    clip first, then up to `check_others` of the rest, in orders drawn from
    the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(run.seed), 5]))
    kept = [r for r in run.requests if "out" in r and r["rid"] in st.rows]
    picked = []
    for given, n in ((True, run.workload["check_noise_given"]),
                     (False, run.workload["check_others"])):
        pool = [r for r in kept if (st.rows[r["rid"]][2] is not None) == given]
        if not pool:
            continue
        order = [pool[i] for i in rng.permutation(len(pool))]
        longest = max(order, key=lambda r: r["motion_s"])
        picked += [longest] + [r for r in order if r is not longest][:n - 1]
    return picked


def readings(ref, st: State, rec: dict, device: str, served=None) -> dict:
    """The check's numbers for one served row; `served`: the control, read
    in the program's place on the same tokens."""
    from talkshow_torch.serving import _SPF
    wl_bucket = st.bucket_frames
    x = pcm(st, rec["clip"])
    wav = torch.as_tensor(x.astype(np.float32) * (1.0 / 32768.0), device=device)
    frames = len(x) * 30 // 16000
    bucket = -(-frames // wl_bucket) * wl_bucket
    padded = torch.zeros((bucket + 1) * _SPF, device=device)
    padded[:len(x)] = wav
    tokens_all, j, key = st.rows[rec["rid"]]
    tokens = tokens_all[j:j + 1].to(device).long()                      # (1, H, 2)
    feat = ref_audio.get_mfcc(padded)
    Tp = max(-(-max(feat.shape[0], 4) // 4) * 4, 4)
    feat = torch.nn.functional.pad(feat, (0, 0, 0, Tp - feat.shape[0]))
    out = {}
    if key is not None:
        g = st.blocks[key][:, :, j:j + 1]
        logits = ref.logits(tokens, rec["speaker"], ref.audio_from_mfcc(feat))
        if served is None:
            choice = tokens
        else:
            z = served.logits(tokens, rec["speaker"], served.audio_from_mfcc(feat))
            choice = (z + g.permute(2, 0, 1, 3)).argmax(-1)
        out["token_gap"] = gen._gap(logits, g, choice)
    src = ref if served is None else served
    full_ref = ref_pose.assemble(ref.face(wav), ref.decode(tokens))[0]
    full = (torch.as_tensor(np.asarray(rec["out"]), device=device) if served is None
            else ref_pose.assemble(src.face(wav), src.decode(tokens))[0])
    if full.shape != full_ref.shape:
        return {k: float("inf") for k in gen.NUMBERS}
    grp = ref_pose.channel_groups()
    out["face_rel"] = gen._rel(full[:, grp["face"]], full_ref[:, grp["face"]])
    out["body_rel"] = gen._rel(full[:, grp["body"]], full_ref[:, grp["body"]])
    out["fixed_abs"] = float((full[:, grp["fixed"]] - full_ref[:, grp["fixed"]]).abs().max())
    return out


def check(run, st: State) -> list:
    """[(name, worst reading, limit)] over the sample; with the "control"
    hook, the control's readings go to run.extra["control"]."""
    limits = run.workload["limits"]
    ref = ref_model.Reference(run.cfg, st.weights, run.device)
    control = None
    if run.hooks.get("control"):
        control = ref_model.Reference(run.cfg, st.weights, run.device,
                                      quantize=weights.fp8_rounded)
    worst: dict = {}
    worst_c: dict = {}
    picked = sample(run, st)
    for rec in picked:
        for k, v in readings(ref, st, rec, run.device).items():
            worst[k] = max(worst.get(k, 0.0), v)
        if control is not None:
            for k, v in readings(ref, st, rec, run.device, control).items():
                worst_c[k] = max(worst_c.get(k, 0.0), v)
    run.extra["checked"] = len(picked)
    run.extra["control"] = worst_c
    if not any(st.rows[r["rid"]][2] is not None for r in picked):
        worst["token_gap"] = float("inf")      # no served token could be judged
    return [(k, worst.get(k, float("inf")), limits[k]) for k in gen.NUMBERS if k in limits]
