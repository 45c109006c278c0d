"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the script exits non-zero):
  1 device   CUDA present; the card's name and power limit (nvidia-smi);
             TF32 off for matmuls and cuDNN convolutions
  2 build    nvcc builds talkshow_torch/csrc/ar_decode.cu (sm_90a), loaded
  3 K1       the AR-decode kernel against its plain PyTorch version at full
             width (dim 256, 15 layers, K 2048, H 75), B in {1, 8, 32}:
             a) f32 tables, injected gumbel noise: free-run tokens equal,
                every emitted token = argmax(emitted logits + noise),
                teacher-forced logits within 1e-3 (same f32 math, summed in
                another order through 15 layers)
             b) bf16 tables against the plain version on the same
                bf16-rounded weights: teacher-forced logits within 1e-3 of
                max|logit| (activations are f32 on both sides, so only the
                summation order differs), and >= 97 % of the draws
                argmax(logits + noise) agree
             c) in-kernel Philox noise: seeded, in [0, K), and the sampled
                tokens' mean log-probability within 4 standard errors of the
                logits' mean negative entropy
  4 main     Pipeline.create(seed, device="cuda") at full width: generate()
             on a synthetic 10 s 16 kHz wav for S in {1, 8}; (S, 300, 265)
             finite output, the kernel launched, the plain sampler not
             called; then a 1 s clip against the same weights on the CPU
             (f32 tables, shared noise): equal tokens, motion within 1e-3
  5 times    generate() p50 over 10 runs at S=1 and 5 runs at S=8 (CUDA
             events, fresh seed per run), the S=1 stages, and the K1 decode
             against the plain decode at B = 1 and 8, H = 75, each beside the
             card's name and limit
Then one JSON line of kernels, the nvidia-smi line, and the result line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

FULL = dict(dim=256, layers=15, K=2048, H=75)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device-clock ms of fn() over reps, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def prior_case(B: int, seed: int, dev):
    from talkshow_torch.models.layers import init_weights_
    from talkshow_torch.models.pixelcnn import GatedPixelCNN, gumbel_noise
    gen = torch.Generator().manual_seed(seed)
    model = init_weights_(GatedPixelCNN(input_dim=FULL["K"], dim=FULL["dim"],
                                        n_layers=FULL["layers"]), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    H, K = FULL["H"], FULL["K"]
    label = torch.randint(0, 4, (B,), generator=gen).to(dev)
    audio = torch.randn((B, H, 256), generator=gen).to(dev)
    given = torch.randint(0, K, (B, H, 2), generator=gen).to(dev)
    noise = gumbel_noise((H, 2, B, K), gen, dev)
    return model.to(dev).eval(), label, audio, given, noise


def phase3(dev) -> float:
    from talkshow_torch.kernels.ar_decode import (pack_decode_tables, round_like_tables,
                                                  sample_tokens_fused)
    from talkshow_torch.models.pixelcnn import sample_tokens
    H, K = FULL["H"], FULL["K"]
    worst = 0.0
    for B in (1, 8, 32):
        model, label, audio, given, noise = prior_case(B, B, dev)
        # (a) f32 tables
        t32 = pack_decode_tables(model, torch.float32)
        tok, lg_free = sample_tokens_fused(model, label, audio, tables=t32, noise=noise,
                                           return_logits=True)
        want = sample_tokens(model, label, audio, noise=noise)
        n_eq = int((tok == want).sum())
        if n_eq != tok.numel():
            raise AssertionError(f"3a B={B}: free-run tokens differ at "
                                 f"{tok.numel() - n_eq}/{tok.numel()} positions")
        draws = torch.argmax(lg_free + noise.permute(2, 0, 1, 3), dim=-1)
        if not torch.equal(draws, tok):
            raise AssertionError(f"3a B={B}: emitted tokens are not argmax(logits + noise)")
        _, lg = sample_tokens_fused(model, label, audio, tables=t32, noise=noise,
                                    prefix_tokens=given, prefix_len=H, return_logits=True)
        _, lg_ref = sample_tokens(model, label, audio, noise=noise, prefix_tokens=given,
                                  prefix_len=H, return_logits=True)
        err = (lg - lg_ref).abs().max().item()
        worst = max(worst, err)
        if not err <= 1e-3:
            raise AssertionError(f"3a B={B}: teacher-forced max|dlogit| {err} > 1e-3")
        log(f"phase 3a B={B}: f32 tables, free-run tokens equal {n_eq}/{tok.numel()}, "
            f"teacher-forced max|dlogit| {err:.3e} <= 1e-3")
        # (b) bf16 tables against the plain version on bf16-rounded weights
        t16 = pack_decode_tables(model, torch.bfloat16)
        rounded = round_like_tables(model, torch.bfloat16)
        _, lg16 = sample_tokens_fused(model, label, audio, tables=t16, noise=noise,
                                      prefix_tokens=given, prefix_len=H, return_logits=True)
        _, lg16_ref = sample_tokens(rounded, label, audio, noise=noise, prefix_tokens=given,
                                    prefix_len=H, return_logits=True)
        scale = lg16_ref.abs().max().item()
        rel = (lg16 - lg16_ref).abs().max().item() / scale
        g = noise.permute(2, 0, 1, 3)
        agree = (torch.argmax(lg16 + g, -1) == torch.argmax(lg16_ref + g, -1)).float().mean().item()
        if not (rel <= 1e-3 and agree >= 0.97):
            raise AssertionError(f"3b B={B}: rel err {rel}, draw agreement {agree}")
        log(f"phase 3b B={B}: bf16 tables, teacher-forced max|dlogit|/max|logit| "
            f"{rel:.3e} <= 1e-3, draws agree {agree:.4f} >= 0.97")
        # (c) Philox
        def run(seed, **kw):
            return sample_tokens_fused(model, label, audio, tables=t16,
                                       generator=torch.Generator().manual_seed(seed), **kw)
        a, b, c = run(11), run(11), run(12)
        if not (torch.equal(a, b) and not torch.equal(a, c)
                and int(a.min()) >= 0 and int(a.max()) < K):
            raise AssertionError(f"3c B={B}: Philox tokens not seeded or out of range")
        tok_p, lg_p = run(13, return_logits=True)
        logp = torch.log_softmax(lg_p.double(), dim=-1)
        picked = logp.gather(-1, tok_p[..., None])[..., 0]
        negent = (logp.exp() * logp).sum(-1)
        diff = (picked - negent).flatten()
        z = diff.mean().item() / (diff.std().item() / math.sqrt(diff.numel()))
        if not abs(z) <= 4.0:
            raise AssertionError(f"3c B={B}: sampled log-prob off by {z:.2f} standard errors")
        log(f"phase 3c B={B}: Philox seeded and in [0, {K}), mean log p(token) "
            f"{picked.mean().item():.4f} vs mean -entropy {negent.mean().item():.4f} "
            f"({z:+.2f} s.e.)")
    return worst


def write_wav(path: str, seconds: float, seed: int) -> None:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (1 + np.sin(2 * np.pi * 3 * t))
    x = x + 0.05 * rng.standard_normal(t.shape)
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def main() -> int:
    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"phase 1 device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- phase 2: build ------------------------------------------------------
    from talkshow_torch.kernels import _build, ar_decode, counts
    t0 = time.time()
    so = _build.build("ar_decode")
    ar_decode._lib()
    log(f"phase 2 build: {os.path.relpath(so)} built and loaded in {time.time() - t0:.1f} s")

    # ---- phase 3: K1 against its plain version -------------------------------
    max_err = phase3(dev)

    # ---- phase 4: the main path ----------------------------------------------
    from talkshow_torch.models.pixelcnn import gumbel_noise
    from talkshow_torch.pipeline import Pipeline
    pipe = Pipeline.create(seed=0, device="cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    wav10, wav1 = os.path.join(tmp, "speech10.wav"), os.path.join(tmp, "speech1.wav")
    write_wav(wav10, 10.0, 0)
    write_wav(wav1, 1.0, 1)
    counts.clear()
    outs = {S: pipe.generate(wav10, speaker="oliver", num_samples=S, seed=S) for S in (1, 8)}
    torch.cuda.synchronize()
    launches, plain_calls = counts["ar_decode"], counts["sample_tokens_plain"]
    for S, out in outs.items():
        if out.shape != (S, 300, 265) or not np.isfinite(out).all():
            raise AssertionError(f"phase 4: S={S} output {out.shape}, finite={np.isfinite(out).all()}")
    if launches < 1 or plain_calls != 0:
        raise AssertionError(f"phase 4: ar_decode launches {launches}, plain sampler calls {plain_calls}")
    log(f"phase 4 main: generate S=1 -> {outs[1].shape}, S=8 -> {outs[8].shape}, finite; "
        f"ar_decode launches {launches}, plain sampler calls {plain_calls}")

    ref = Pipeline.create(seed=0, device="cpu")
    pipe.table_dtype = torch.float32
    pipe.__dict__.pop("_decode_tables", None)
    from talkshow_torch.ops.audio import get_mfcc
    feat = get_mfcc(wav1).numpy()
    noise = gumbel_noise((feat.shape[0] // 4, 2, 2, FULL["K"]),
                         torch.Generator().manual_seed(5), "cpu")
    _, tok_gpu = pipe.generate_conv(feat, 0, 2, noise=noise)
    _, tok_cpu = ref.generate_conv(feat, 0, 2, noise=noise)
    m_gpu = pipe.generate(wav1, speaker=0, num_samples=2, noise=noise)
    m_cpu = ref.generate(wav1, speaker=0, num_samples=2, noise=noise)
    dm = float(np.abs(m_gpu - m_cpu).max())
    if not (torch.equal(tok_gpu.cpu(), tok_cpu) and dm <= 1e-3):
        raise AssertionError(f"phase 4 reference: tokens equal "
                             f"{torch.equal(tok_gpu.cpu(), tok_cpu)}, max|dmotion| {dm}")
    log(f"phase 4 reference: 1 s clip, CUDA (f32 tables) vs CPU on the same weights and "
        f"noise: tokens equal, max|dmotion| {dm:.2e} <= 1e-3")
    pipe.table_dtype = torch.bfloat16
    pipe.__dict__.pop("_decode_tables", None)
    del ref

    # ---- phase 5: times ------------------------------------------------------
    card = card_line()
    times = []
    for i in range(11):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.generate(wav10, speaker="oliver", num_samples=1, seed=100 + i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    p50 = float(np.median(times[1:]))
    log(f"phase 5 generate S=1 10 s clip: p50 {p50:.2f} ms over {len(times) - 1} runs "
        f"(min {min(times[1:]):.2f}, max {max(times[1:]):.2f}) [{card}]")
    times8 = []
    for i in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.generate(wav10, speaker="oliver", num_samples=8, seed=200 + i)
        end.record()
        torch.cuda.synchronize()
        times8.append(start.elapsed_time(end))
    log(f"phase 5 generate S=8 10 s clip: p50 {float(np.median(times8[1:])):.2f} ms over "
        f"{len(times8) - 1} runs (min {min(times8[1:]):.2f}, max {max(times8[1:]):.2f}) [{card}]")

    from talkshow_torch.ops.audio import load_wav
    wav, _ = load_wav(wav10)
    feat10 = get_mfcc(wav10, device=dev)
    x = feat10[None]
    ids = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.no_grad():
        audio = pipe.body.audio_enc(x)
        tokens = ar_decode.sample_tokens_fused(pipe.body.prior, ids, audio,
                                               tables=pipe._decode_tables)
        stages = {
            "face": cuda_ms(lambda: pipe.generate_face(wav), 3),
            "mfcc": cuda_ms(lambda: get_mfcc(wav10, device=dev), 3),
            "audio_encoder": cuda_ms(lambda: pipe.body.audio_enc(x), 3),
            "ar_decode": cuda_ms(lambda: ar_decode.sample_tokens_fused(
                pipe.body.prior, ids, audio, tables=pipe._decode_tables), 3),
            "vq_decode": cuda_ms(lambda: (
                pipe.body.vq_body.decode_latents(tokens[..., 0], pipe.body.vq_body_state),
                pipe.body.vq_hand.decode_latents(tokens[..., 1], pipe.body.vq_hand_state)), 3),
        }
    log("phase 5 stages S=1 (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f" [{card}]")

    from talkshow_torch.models.pixelcnn import sample_tokens
    decode = {}
    for B in (1, 8):
        model, label, audio_b, _, _ = prior_case(B, 40 + B, dev)
        t16 = ar_decode.pack_decode_tables(model, torch.bfloat16)
        gen = torch.Generator().manual_seed(0)

        def kern():
            return ar_decode.sample_tokens_fused(model, label, audio_b, tables=t16,
                                                 generator=gen)

        def plain():
            return sample_tokens(model, label, audio_b, generator=gen)

        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern, 5), cuda_ms(kern, 5), cuda_ms(plain)
        decode[B] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"phase 5 ar_decode B={B} H=75: kernel (bf16 tables) {k1:.2f} / {k2:.2f} ms, "
            f"plain {p1:.2f} / {p2:.2f} ms [{card}]")

    print(json.dumps({"kernels": [{
        "name": "ar_decode", "route": "cuda", "source": ar_decode.SOURCE,
        "replaces": ar_decode.REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": decode[1][0], "plain_ms": decode[1][1]}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
