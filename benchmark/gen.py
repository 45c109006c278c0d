"""What the generate drivers share: the program built on the benchmark's
weights, the closed loop over the request stream, and the check of served
clips against the reference.

Requests: most sample with the program's own noise (Philox in the AR
decode kernel).  One request per clip length in each block of the stream
carries a gumbel block the benchmark draws from the request's seed; the
program's tokens are then argmax(logit + gumbel), a deterministic function
of its logits, and the check replays them.

The check, once the window has closed and the program is freed, takes the
requests the window completed whose outputs were kept (every request with
given noise, one in ten of the others; see `KEEP_OTHERS`), and a sample of
them drawn from the seed with the longest clip first, and on each:

- ``token_gap``: with the same gumbel block, the widest gap over every
  served token between the reference's best logit + gumbel and that of the
  served token, the reference teacher-forced on the served tokens (its own
  MFCC, audio encoder and prior);
- ``face_rel``: the served jaw and expression against the reference's face
  stage, ||d|| / ||ref|| (entry `generate`);
- ``body_rel``: the served conv channels against the reference's VQ
  decoders on the served tokens, assembled to the face's length;
- ``fixed_abs``: the largest difference in the lower body's fixed channels
  (exact; entry `generate`).

Each reading is the worst over the sample."""
from __future__ import annotations

import os
import sys
import time
import traceback
import wave

import numpy as np
import torch

from benchmark import counts, traffic, weights
from benchmark.reference import model as ref_model
from benchmark.reference import pose as ref_pose

#: the share of requests with the program's own noise whose outputs are kept
KEEP_OTHERS = 0.1


class State:
    pass


def build_program(cfg: dict, w: dict, device: str):
    """A `talkshow_torch.pipeline.Pipeline` at the configuration's widths
    holding the weights `w` (copied in by its `load_converted`)."""
    from talkshow_torch.models.body import BodyModels
    from talkshow_torch.models.face import FaceGenerator
    from talkshow_torch.models.pixelcnn import GatedPixelCNN
    from talkshow_torch.models.vqvae import VQVAE, AudioEncoder
    from talkshow_torch.models.wav2vec import Wav2Vec2Config
    from talkshow_torch.ops.vq import VQState
    from talkshow_torch.pipeline import Pipeline

    wc, fc, vq, pr, ae = (cfg[k] for k in ("wav2vec", "face", "vq", "prior", "audio_encoder"))
    w2v = Wav2Vec2Config(hidden_size=wc["hidden_size"], num_layers=wc["num_layers"],
                         num_heads=wc["num_heads"], intermediate_size=wc["intermediate_size"],
                         conv_dim=tuple(wc["conv_dim"]), conv_kernel=tuple(wc["conv_kernel"]),
                         conv_stride=tuple(wc["conv_stride"]),
                         num_conv_pos_embeddings=wc["num_conv_pos_embeddings"],
                         num_conv_pos_embedding_groups=wc["num_conv_pos_embedding_groups"],
                         layer_norm_eps=wc["layer_norm_eps"])
    with torch.device("meta"):
        face = FaceGenerator(w2v, fc["num_classes"], fc["jaw_dim"], fc["exp_dim"])
        mods = {
            "vq_body": VQVAE(vq["body_channels"], vq["embedding_dim"], vq["num_hiddens"],
                             vq["num_residual_layers"]),
            "vq_hand": VQVAE(vq["hand_channels"], vq["embedding_dim"], vq["num_hiddens"],
                             vq["num_residual_layers"]),
            "audio_enc": AudioEncoder(ae["in_dim"], num_hiddens=ae["num_hiddens"]),
            "prior": GatedPixelCNN(input_dim=pr["input_dim"], dim=pr["dim"],
                                   n_layers=pr["n_layers"], n_classes=pr["n_classes"],
                                   audio_channels=ae["num_hiddens"], hidden=pr["hidden"]),
        }
    face = face.to_empty(device=device).eval()
    mods = {k: m.to_empty(device=device).eval() for k, m in mods.items()}

    def vq_state(book):
        K = book.shape[0]
        return VQState(book.clone(), torch.zeros_like(book), torch.zeros(K, device=device),
                       torch.zeros((), dtype=torch.int32, device=device))

    body = BodyModels(mods["vq_body"], mods["vq_hand"], vq_state(w["codebook_body"]),
                      vq_state(w["codebook_hand"]), mods["audio_enc"], mods["prior"])
    pipe = Pipeline(face, body, torch.device(device), num_classes=fc["num_classes"])
    return pipe.load_converted({k: w[k] for k in ref_model.PARTS})


def gumbel(noise_seed: int, H: int, S: int, K: int, device: str) -> torch.Tensor:
    """(H, 2, S, K) gumbel block of a request with given noise."""
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    u = torch.rand((H, 2, S, K), generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


def decode_note(args, kwargs) -> dict:
    """What the AR decode's roofline needs of one `sample_tokens_fused` call."""
    audio = args[2]
    return {"span": "ar_decode", "B": int(audio.shape[0]), "H": int(audio.shape[1]),
            "noise_given": kwargs.get("noise") is not None}


def setup(run, entry) -> State:
    """Weights, program, clips and the warm-up of every shape the stream
    sends (each clip length with the program's noise and with given noise)."""
    st = State()
    st.entry = entry
    st.weights = weights.draw(run.cfg, run.seed, run.device)
    st.pipe = build_program(run.cfg, st.weights, run.device)
    st.clips = traffic.make_clips(run.workload, run.seed, os.path.join(run.tmp, "clips"))
    st.S = run.workload["num_samples"]
    st.K = run.cfg["prior"]["input_dim"]
    st.tokens = None
    inner = st.pipe.generate_conv

    def keep_tokens(*args, **kwargs):
        conv, tokens = inner(*args, **kwargs)
        st.tokens = tokens
        return conv, tokens

    st.pipe.generate_conv = keep_tokens
    by_len = {}
    for c in st.clips:
        by_len.setdefault(c.seconds, c)
    for c in by_len.values():
        H = counts.mfcc_frames(c.samples) // 4
        entry.call(st, c.path, 0, st.S, 1, None)
        entry.call(st, c.path, 0, st.S, 1, gumbel(1, H, st.S, st.K, run.device))
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
        st.entry.wrap(spans, st)
        prof = WindowProfile(run.seconds, run.device == "cuda", run.tmp)
    rng = np.random.default_rng(np.random.SeedSequence([int(run.seed), 4]))
    stream = traffic.requests(run.workload, st.clips, run.seed)
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    reported = False
    for req in stream:
        now = time.perf_counter()
        if now >= t_end:
            break
        profiled = prof is not None and prof.tick(now - t0)
        H = counts.mfcc_frames(req.clip.samples) // 4
        noise = (None if req.noise_seed is None
                 else gumbel(req.noise_seed, H, st.S, st.K, run.device))
        keep = req.noise_seed is not None or rng.random() < KEEP_OTHERS
        if spans is not None:
            spans.begin_request()
        t1 = time.perf_counter()
        try:
            out = st.entry.call(st, req.clip.path, req.speaker, st.S, req.seed, noise)
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
        rec = {"index": req.index, "clip": req.clip, "speaker": req.speaker,
               "noise_seed": req.noise_seed, "latency_s": t2 - t1,
               "motion_s": st.S * req.clip.seconds, "samples": st.S,
               "wav_len": req.clip.samples, "profiled": profiled}
        if keep:
            rec["out"], rec["tokens"] = out, st.tokens
        if spans is not None:
            rec["spans"] = spans.end_request()
            rec["notes"] = spans.notes
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


def _gap(logits: torch.Tensor, g: torch.Tensor, tokens: torch.Tensor) -> float:
    """Widest (best logit + g) - (served token's logit + g) over positions;
    logits (S, H, 2, K), g (H, 2, S, K), tokens (S, H, 2)."""
    z = logits + g.permute(2, 0, 1, 3)
    served = z.gather(-1, tokens[..., None])[..., 0]
    return float((z.amax(-1) - served).max())


def sample(run, st: State) -> list:
    """The checked requests: up to `check_noise_given` with given noise, the
    longest clip first, then the others in an order drawn from the seed, and
    up to `check_others` of the rest."""
    rng = np.random.default_rng(np.random.SeedSequence([int(run.seed), 5]))
    kept = [r for r in run.requests if "out" in r]
    given = [r for r in kept if r["noise_seed"] is not None]
    others = [r for r in kept if r["noise_seed"] is None]
    picked = []
    for pool, n in ((given, run.workload["check_noise_given"]),
                    (others, run.workload["check_others"])):
        if not pool:
            continue
        order = [pool[i] for i in rng.permutation(len(pool))]
        longest = max(order, key=lambda r: r["clip"].seconds)
        picked += [longest] + [r for r in order if r is not longest][:n - 1]
    return picked


def readings(ref, st: State, rec: dict, with_face: bool, device: str, served=None) -> dict:
    """The check's numbers for one request.  `served`: a stand-in for the
    program (the control), a Reference whose outputs are read in place of
    the served ones on the same tokens."""
    wav = torch.as_tensor(read_wav(rec["clip"].path), device=device)
    tokens = rec["tokens"].to(device).long()
    S, H = tokens.shape[0], tokens.shape[1]
    aud = ref.audio(wav)
    conv_ref = ref.decode(tokens)
    out = {}
    if rec["noise_seed"] is not None:
        g = gumbel(rec["noise_seed"], H, S, st.K, device)
        logits = ref.logits(tokens, rec["speaker"], aud)
        if served is None:
            choice = tokens
        else:
            z = served.logits(tokens, rec["speaker"], served.audio(wav)) + g.permute(2, 0, 1, 3)
            choice = z.argmax(-1)
        out["token_gap"] = _gap(logits, g, choice)
    if with_face:
        face_ref = ref.face(wav)
        full_ref = ref_pose.assemble(face_ref, conv_ref)
        if served is None:
            full = torch.as_tensor(np.asarray(rec["out"]), device=device)
        else:
            full = ref_pose.assemble(served.face(wav), served.decode(tokens))
        grp = ref_pose.channel_groups()
        if full.shape != full_ref.shape:
            return {"token_gap": float("inf"), "face_rel": float("inf"),
                    "body_rel": float("inf"), "fixed_abs": float("inf")}
        out["face_rel"] = _rel(full[..., grp["face"]], full_ref[..., grp["face"]])
        out["body_rel"] = _rel(full[..., grp["body"]], full_ref[..., grp["body"]])
        out["fixed_abs"] = float((full[..., grp["fixed"]] - full_ref[..., grp["fixed"]])
                                 .abs().max())
    else:
        conv = (torch.as_tensor(np.asarray(rec["out"]), device=device) if served is None
                else served.decode(tokens))
        out["body_rel"] = _rel(conv, conv_ref)
    return out


NUMBERS = ("token_gap", "face_rel", "body_rel", "fixed_abs")


def check(run, st: State, with_face: bool) -> list:
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
        for k, v in readings(ref, st, rec, with_face, run.device).items():
            worst[k] = max(worst.get(k, 0.0), v)
        if control is not None:
            for k, v in readings(ref, st, rec, with_face, run.device, control).items():
                worst_c[k] = max(worst_c.get(k, 0.0), v)
    run.extra["checked"] = len(picked)
    run.extra["control"] = worst_c
    if not any(r["noise_seed"] is not None for r in picked):
        worst["token_gap"] = float("inf")      # no served token could be judged
    return [(k, worst.get(k, float("inf")), limits[k]) for k in NUMBERS if k in limits]
