"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the script exits non-zero):
  1 device   CUDA present; the card's name and power limit (nvidia-smi);
             TF32 off for matmuls and cuDNN convolutions
  2 build    nvcc builds the four kernels of talkshow_torch/csrc/ (sm_90a),
             one process per source, all started together; loaded
  3 K1       the AR-decode kernel against its plain PyTorch version at full
             width (dim 256, 15 layers, K 2048, H 75), B in {1, 8, 32}:
             a) f32 tables, injected gumbel noise: free-run tokens equal,
                every emitted token = argmax(emitted logits + noise),
                teacher-forced logits within 1e-3 (same f32 math, summed in
                another order through 15 layers)
             b) bf16 tables against the plain version on the same
                bf16-rounded weights: teacher-forced logits within 1e-3 of
                max|logit| (activations are f32 on both sides, so only the
                summation order differs, and at B = 32, on the tensor cores,
                x's split into bf16 hi + lo, 2^-17 of it), and >= 97 % of the draws
                argmax(logits + noise) agree
             c) in-kernel Philox noise: seeded, in [0, K), and the sampled
                tokens' mean log-probability within 4 standard errors of the
                logits' mean negative entropy
             d) B = 1 and 8: a prefix of 30 of the 75 rows (f32 tables): tokens
                equal, forced rows kept, logits within 1e-3; 20 reruns with one
                Philox seed (bf16 tables) bit-equal in tokens and logits
  4 main     Pipeline.create(seed, device="cuda") at full width: generate()
             on a synthetic 10 s 16 kHz wav for S in {1, 8}; (S, 300, 265)
             finite output, the kernel launched, the plain sampler not
             called; then a 1 s clip against the same weights on the CPU
             (f32 tables, shared noise): equal tokens, motion within 1e-3
  5 times    generate() p50 over 10 runs at S=1 and 5 runs at S=8 (CUDA
             events, fresh seed per run), the S=1 stages; K1 (bf16 tables,
             Philox) at B = 1, 8, 32 and H = 75, 25: ms, us per row, us per
             dependent step (the slope
             between H = 75 and 25 over the steps of a row) and the launch's
             shape, and where a row's time goes (the kernel's %globaltimer
             probe, `decode_timeline`); the K1 decode against the plain
             decode at B = 1 and 8,
             H = 75; K1's device time by kernel (torch.profiler); each beside
             the card's name and limit
  6 K2       the wav2vec encoder-layer kernel against its plain version at
             full width (12 layers, 768 wide, 12 heads, FFN 3072, T = 300) on
             random weights: B = 1 unmasked, B = 8 masked (valid 300, 270, ..,
             90); two runs equal bit for bit; f32 tables within 1e-3 on valid
             rows (the same f32 math in another order through 12 post-norm
             layers), bf16 tables within 1e-2 of max|out| (both sides round
             every product's operands to bf16; an intermediate may round the
             other way), padded rows finite; then the Hopper GEMM that K2 and
             K3 share, alone, at each of their product shapes (B = 1 and 8):
             within 1e-4 of max|C| of torch.matmul on the same bf16 operands,
             and its TFLOP/s from a captured CUDA graph
  7 K3       the conv-extractor kernel against its plain version, full 7-conv
             512-channel stack, 10 s clip, B = 1 and 8, f32 within 1e-3 and
             bf16 within 1e-2 of max|out|; two runs equal bit for bit
  8 face     models/wav2vec_fused.face_apply_fused at full width, f32
             tables, on Pipeline.create(seed=0)'s weights, against the plain
             face stage (FaceGenerator.forward): unmasked B = 1 on the 10 s
             clip and masked B = 8 (clips of 10, 9, .., 3 s padded to 10 s),
             real frames within 1e-3; launch counts read around each call
             (K2 and K3 > 0 unmasked; K2 and the plain masked extractor > 0
             masked); bf16 tables reported beside them
  9 times    K2, K3 and face_apply_fused (bf16 tables) against their plain
             versions at B = 1 and 8, K2's library yardstick (one
             nn.TransformerEncoder call on the same weights, bf16, eager and
             replayed from a captured CUDA graph) and, at B = 1 and 8, the
             device time of one K2 and one K3 call by kernel (torch.profiler)
             with the device-idle share of the call (1 - device time / CUDA-event
             wall time), each beside the card (phase 5's "face" stage is the
             plain Pipeline.generate_face)
 10 K4       the nearest-code kernel against its plain version at full width
             (codebook 2048 x 64 and 2047 x 64, N in {1, 75, 2816}; each shape's
             plan: tile rows, cluster, CTAs): two runs equal bit for bit, exact
             ties between codes in different CTAs' slices take the lower index,
             indices equal to plain except on near-tie rows (best and
             second-best distances within 1e-5 (1 + |best|); the kernel sums
             ||e||^2 itself), and on every row the pick's distance within that
             tolerance of the minimum
 11 train    python -m talkshow_torch.train (its main()) for s2g_body_vq at full
             width (batch 128, window 88, num_hiddens 1024) on a synthetic
             dataset, one epoch of >= 10 steps: every logged loss finite,
             nearest_code launched twice per step, the plain search never; a
             checkpoint, and resume + one step equal to the uninterrupted run's
             next step bit for bit; one step from one fresh state on CUDA
             against the CPU (B = 8, TF32 off): losses within 1e-4 relative,
             indices equal apart from near-ties, decoder gradients within 1e-3
             of max|g|; encoder gradients, whose f32 rounding reaches ~1e-2 of
             max|g| on either device (three levels of batch-statistics
             BatchNorm behind the straight-through estimator), within 2e-2 of
             an f64 CPU reference, the CPU's own f32 error beside them;
             BatchNorm statistics and VQ states within 1e-4, parameters within
             2 lr (Adam's first step moves each by about lr sign(g)) and at
             least 99 % of them within 1e-2 lr; make_token_encoder on a batch
             of 128 launches K4
 12 times    the body-VQ step p50 and windows/s at B = 128, T = 88, its device
             time by kernel (torch.profiler) and, for the record, its time with
             cuDNN's non-deterministic algorithms (TF32 off) and with TF32 on;
             K4 (bare, and through ops/vq.nearest_code as the step calls it), its
             plain version and the two-call yardstick argmin(addmm) at N = 75
             and 2816 with the bound share, the kernels one ops/vq.nearest_code
             call launches (torch.profiler; more than one fails); the token
             encode at B = 128; each beside the card
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
#: published H100 SXM peaks: bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s
#: outside the tensor cores
HBM_BYTES_S, BF16_FLOP_S, F32_FLOP_S = 3.35e12, 989e12, 67e12
KERNELS = ("ar_decode", "wav2vec_layers", "wav2vec_extractor", "nearest_code")
#: stage-1 training at full width (talkshow_tpu/config.py:21,60-62,79)
TRAIN = dict(batch=128, window=88, num_hiddens=1024, codes=2048, dim=64)


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


def phase3d(dev) -> None:
    """K1 with a prefix shorter than H, and reruns with one Philox seed:
    the kernel's roles meet only through flags, so a missing wait shows as a
    rerun that differs."""
    from talkshow_torch.kernels.ar_decode import pack_decode_tables, sample_tokens_fused
    from talkshow_torch.models.pixelcnn import sample_tokens
    P = 30
    for B in (1, 8):
        model, label, audio, given, noise = prior_case(B, 60 + B, dev)
        t32 = pack_decode_tables(model, torch.float32)
        tok, lg = sample_tokens_fused(model, label, audio, tables=t32, noise=noise,
                                      prefix_tokens=given, prefix_len=P, return_logits=True)
        want, want_lg = sample_tokens(model, label, audio, noise=noise, prefix_tokens=given,
                                      prefix_len=P, return_logits=True)
        err = (lg - want_lg).abs().max().item()
        if not (torch.equal(tok, want) and torch.equal(tok[:, :P], given[:, :P].long())
                and err <= 1e-3):
            raise AssertionError(f"3d B={B}: prefix {P}/{FULL['H']}: tokens equal "
                                 f"{int((tok == want).sum())}/{tok.numel()}, max|dlogit| {err}")
        t16 = pack_decode_tables(model, torch.bfloat16)
        runs = [sample_tokens_fused(model, label, audio, tables=t16, return_logits=True,
                                    generator=torch.Generator().manual_seed(21))
                for _ in range(20)]
        same = sum(torch.equal(t, runs[0][0]) and torch.equal(g, runs[0][1]) for t, g in runs)
        if same != len(runs):
            raise AssertionError(f"3d B={B}: {same}/{len(runs)} Philox reruns bit-equal")
        log(f"phase 3d B={B}: prefix {P} of {FULL['H']} rows (f32 tables): tokens equal "
            f"{tok.numel()}/{tok.numel()}, forced rows kept, max|dlogit| {err:.3e} <= 1e-3; "
            f"bf16 tables, {same}/{len(runs)} Philox reruns bit-equal (tokens and logits)")


def phase5_k1(dev, card: str) -> dict:
    """K1 (bf16 tables, Philox) at B = 1, 8, 32 and H = 75, 25: ms, us per
    row, us per dependent step (the slope between H = 75 and 25 over the
    steps of a row), the launch's shape and the timeline probe; the plain
    decode at B = 1 and 8 in the order plain, kernel, kernel, plain; one
    profiler line.  Returns (kernel ms, plain ms) per B."""
    from talkshow_torch.kernels import ar_decode
    from talkshow_torch.kernels.ar_decode import chain_steps
    from talkshow_torch.models.pixelcnn import sample_tokens
    steps = len(chain_steps(FULL["layers"], FULL["dim"], FULL["K"], 512)) + 2
    res = {}
    for B in (1, 8, 32):
        model, label, audio_b, _, _ = prior_case(B, 40 + B, dev)
        t16 = ar_decode.pack_decode_tables(model, torch.bfloat16)
        gen = torch.Generator().manual_seed(0)
        ms = {}
        for H in (75, 25):
            aud = audio_b[:, :H].contiguous()
            ms[H] = cuda_ms(lambda: ar_decode.sample_tokens_fused(
                model, label, aud, tables=t16, generator=gen), 5)
        step_us = (ms[75] - ms[25]) * 1e3 / 50 / steps
        shape = dict(ar_decode.last_launch)
        tl = ar_decode.decode_timeline(model, label, audio_b, t16,
                                       torch.Generator().manual_seed(1))
        log(f"phase 5 K1 B={B}: H=75 {ms[75]:.3f} ms, H=25 {ms[25]:.3f} ms, "
            f"{ms[75] * 1e3 / 75:.1f} us/row, {step_us:.3f} us per dependent step "
            f"({steps} per row); chain CTAs {shape['chain_ctas']}, vertical CTAs "
            f"{shape['vertical_ctas']}, shared memory {shape['smem_bytes']} B/CTA, "
            f"ring {shape['ring_stages']} x {ar_decode.CHUNK_BYTES} B [{card}]")
        log(f"phase 5 K1 B={B} timeline (%globaltimer, mean over rows "
            f"1-74, us): " + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in tl.items()))
        if B in (1, 8):
            def kern():
                return ar_decode.sample_tokens_fused(model, label, audio_b, tables=t16,
                                                     generator=gen)

            def plain():
                return sample_tokens(model, label, audio_b, generator=gen)

            p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern, 5), cuda_ms(kern, 5), cuda_ms(plain)
            res[B] = ((k1 + k2) / 2, (p1 + p2) / 2)
            log(f"phase 5 ar_decode B={B} H=75: kernel (bf16 tables) {k1:.2f} / {k2:.2f} ms, "
                f"plain {p1:.2f} / {p2:.2f} ms [{card}]")
            if B == 1:
                log(f"phase 5 K1 B=1 device time by kernel: {kernel_breakdown(kern)} [{card}]")
    return res


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


def bound(nbytes: float, flops: float, peak: float = BF16_FLOP_S) -> tuple[float, str]:
    """Least ms the card could take: bytes over HBM rate vs operations over
    the peak rate for their type (bf16 tensor cores unless given),
    whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def w2v_encoder(seed: int, dev):
    """A full-width Wav2Vec2Encoder with random weights, biases and norm
    parameters (init_weights_ leaves biases 0 and norms 1)."""
    from talkshow_torch.models.layers import init_weights_
    from talkshow_torch.models.wav2vec import Wav2Vec2Encoder
    gen = torch.Generator().manual_seed(seed)
    enc = init_weights_(Wav2Vec2Encoder(), gen)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return enc.to(dev).eval()


def speech(B: int, seconds: float, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * (180.0 + 20 * np.arange(B)[:, None]) * t) \
        + 0.05 * rng.standard_normal((B, t.size))
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def check_close(tag: str, out, want, valid, dtype) -> float:
    """max|out - want| over real rows; raises past the stated tolerance."""
    err, scale = 0.0, 0.0
    for b, n in enumerate(valid):
        err = max(err, (out[b, :n] - want[b, :n]).abs().max().item())
        scale = max(scale, want[b, :n].abs().max().item())
    tol = 1e-3 if dtype == torch.float32 else 1e-2 * scale
    finite = bool(torch.isfinite(out).all())
    if not (err <= tol and finite):
        raise AssertionError(f"{tag}: max|d| {err} > {tol} or non-finite output ({finite})")
    return err if dtype == torch.float32 else err / scale


def k2_ops(valid, T: int, tables) -> float:
    """Products of the layer stack over real rows and real keys."""
    L, H, F = tables["wqkv"].shape[0], tables["wqkv"].shape[2], tables["w1"].shape[1]
    rows = float(sum(valid))
    per_layer = 2 * rows * H * (4 * H + 2 * F) + 4 * sum(float(v) * v for v in valid) * H
    return L * per_layer


def k3_ops(B: int, N: int, tables) -> float:
    ops, n, cin = 0.0, N, 1
    for k, s, cout in tables["layers"]:
        n = (n - k) // s + 1
        ops += 2.0 * B * n * cout * k * cin
        cin = cout
    return ops


def phase6(dev) -> float:
    from talkshow_torch.kernels import wav2vec_layers as k2
    enc = w2v_encoder(6, dev)
    gen = torch.Generator().manual_seed(6)
    worst = 0.0
    for B, valid in ((1, [300]), (8, [300 - 30 * i for i in range(8)])):
        x = torch.randn((B, 300, 768), generator=gen).to(dev)
        vf = None if B == 1 else torch.tensor(valid, dtype=torch.int32, device=dev)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tables = k2.pack_encoder_tables(enc, dtype)
            out = k2.encoder_layers_kernel(tables, x, vf)
            if not torch.equal(out, k2.encoder_layers_kernel(tables, x, vf)):
                raise AssertionError(f"phase 6 K2 B={B} {dtype}: two runs differ")
            errs[dtype] = check_close(f"phase 6 K2 B={B} {dtype}", out,
                                      k2.encoder_layers_plain(tables, x, vf), valid, dtype)
        worst = max(worst, errs[torch.float32])
        log(f"phase 6 K2 B={B} {'masked ' + str(valid) if vf is not None else 'unmasked'}: "
            f"two runs equal; f32 tables max|d| {errs[torch.float32]:.3e} <= 1e-3, bf16 tables "
            f"max|d|/max|out| {errs[torch.bfloat16]:.3e} <= 1e-2, all rows finite")
    return worst


def gemm_shapes() -> dict:
    """(M, N, K, lda, a_batch, Z) of every product K2 and K3 run at full
    width: K2's four at B = 1 and 8 (T = 300), K3's six strided convs of a
    10 s clip at B = 1 and 8 (overlapping rows, one batch per clip)."""
    shapes = {}
    for B in (1, 8):
        M = 300 * B
        for name, N, K in (("qkv", 2304, 768), ("wo", 768, 768), ("w1", 3072, 768),
                           ("w2", 768, 3072)):
            shapes[f"K2 {name} M={M}"] = (M, N, K, K, 0, 1)
        T_in = 31999
        for i, k in enumerate((3, 3, 3, 3, 2, 2)):
            T_out = (T_in - k) // 2 + 1
            shapes[f"K3 layer{i + 1} B={B}"] = (T_out, 512, k * 512, 1024, T_in * 512, B)
            T_in = T_out
    return shapes


def graph_ms(fn, reps: int = 5) -> float:
    """Device ms of fn() replayed from a captured CUDA graph (host work out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def phase6_gemm(dev, card: str) -> None:
    """The Hopper GEMM that K2 and K3 share, alone, at every product shape
    they run: against torch.matmul on the same bf16 operands in f32 (TF32
    off; only the f32 summation order differs: within 1e-4 of max|C|), and
    its device time from a captured graph of 10 calls."""
    from talkshow_torch.kernels import wav2vec_layers as k2
    gen = torch.Generator().manual_seed(66)
    for name, (M, N, K, lda, ab, Z) in gemm_shapes().items():
        a = torch.randn((Z - 1) * ab + (M - 1) * lda + K, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn((N, K), generator=gen) / K ** 0.5).to(dev, torch.bfloat16)
        c = k2.gemm_kernel(a, w, M, lda, ab, Z)
        want = a.as_strided((Z, M, K), (ab, lda, 1)).float() @ w.float().T
        err = (c - want).abs().max().item() / want.abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"phase 6 gemm {name}: max|d|/max|C| {err}")
        ms = graph_ms(lambda: [k2.gemm_kernel(a, w, M, lda, ab, Z) for _ in range(10)]) / 10
        wg, splits, kt = k2.gemm_plan(M, N, K, Z)
        log(f"phase 6 gemm {name} (M={M} N={N} K={K} z={Z}; {64 * wg}-row tiles, {splits} "
            f"split(s) of {kt} k tiles): max|d|/max|C| {err:.2e} <= 1e-4; {ms * 1e3:.2f} us, "
            f"{2.0 * M * N * K * Z / ms / 1e9:.1f} TFLOP/s [{card}]")


def phase7(dev) -> float:
    from talkshow_torch.kernels import wav2vec_extractor as k3
    enc = w2v_encoder(7, dev)
    worst = 0.0
    for B in (1, 8):
        wave = speech(B, 10.0, 70 + B, dev)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tables = k3.pack_extractor_tables(enc.feature_extractor, dtype)
            out = k3.extractor_kernel(tables, wave)
            if out.shape != (B, 499, 512) or not torch.equal(out, k3.extractor_kernel(tables, wave)):
                raise AssertionError(f"phase 7 K3 B={B}: shape {tuple(out.shape)} or runs differ")
            errs[dtype] = check_close(f"phase 7 K3 B={B} {dtype}", out,
                                      k3.extractor_plain(tables, wave), [499] * B, dtype)
        worst = max(worst, errs[torch.float32])
        log(f"phase 7 K3 B={B} 10 s: out (B, 499, 512), two runs equal; f32 tables max|d| "
            f"{errs[torch.float32]:.3e} <= 1e-3, bf16 tables max|d|/max|out| "
            f"{errs[torch.bfloat16]:.3e} <= 1e-2")
    return worst


def phase8(face, wav10: torch.Tensor) -> dict:
    """face_apply_fused against the plain face stage; returns the launches
    of the kernels over both runs."""
    from talkshow_torch.kernels import counts
    from talkshow_torch.models.wav2vec_fused import face_apply_fused, pack_face_tables
    dev = wav10.device
    t32, t16 = (pack_face_tables(face, dt) for dt in (torch.float32, torch.bfloat16))
    launches = dict.fromkeys(KERNELS, 0)
    seconds = [10 - i for i in range(8)]
    masked_wave = torch.zeros((8, 160000), device=dev)
    for i, sec in enumerate(seconds):
        masked_wave[i, :sec * 16000] = wav10[0, :sec * 16000]
    vs = torch.tensor([sec * 16000 for sec in seconds], dtype=torch.int32, device=dev)
    vf = vs * 30 // 16000
    cases = (("unmasked B=1", wav10, {}, [300]),
             ("masked B=8", masked_wave, dict(valid_samples=vs, valid_frames=vf), vf.tolist()))
    for tag, wave, kw, valid in cases:
        onehot = torch.zeros((wave.shape[0], 4), device=dev)
        counts.clear()
        out = face_apply_fused(face, wave, onehot, 300, tables=t32, **kw)
        torch.cuda.synchronize()
        seen = dict(counts)
        for k in launches:
            launches[k] += seen.get(k, 0)
        with torch.no_grad():
            want = face(wave, onehot, 300, **kw)
        err = check_close(f"phase 8 {tag}", out, want, valid, torch.float32)
        out16 = face_apply_fused(face, wave, onehot, 300, tables=t16, **kw)
        err16 = max((out16[b, :n] - want[b, :n]).abs().max().item() for b, n in enumerate(valid))
        k3_name = "wav2vec_extractor" if not kw else "extractor_plain"
        if not (seen.get("wav2vec_layers", 0) > 0 and seen.get(k3_name, 0) > 0
                and bool(torch.isfinite(out16).all())):
            raise AssertionError(f"phase 8 {tag}: launch counts {seen}")
        log(f"phase 8 face {tag}: face_apply_fused f32 tables vs plain face stage max|d| "
            f"{err:.3e} <= 1e-3 on real frames; counts {dict(sorted(seen.items()))}; "
            f"bf16 tables vs plain (f32) max|d| {err16:.3e} (reported)")
    return launches


def kernel_breakdown(fn, reps: int = 3) -> str:
    """Device time per kernel name over reps calls (torch.profiler), as
    'name: total ms / launches'; 'not measured' when the trace holds no
    device time."""
    return device_breakdown(fn, reps)[1]


def device_rows(fn, reps: int = 3) -> list:
    """(device ms per call, launches per call, kernel name) of fn()'s
    kernels over reps calls (torch.profiler; a trace of many short launches
    may drop a few), largest first; [] when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if dev_us > 0 and ev.count > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((dev_us / reps / 1e3, ev.count / reps, ev.key))
    return sorted(rows, reverse=True)


def launches_per_call(fn, reps: int = 20) -> float | None:
    """Kernel launches per fn() call: the CUDA runtime's launch calls that
    torch.profiler records on the host, over reps calls; None when it
    records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages() if ev.key.startswith("cudaLaunch"))
    return n / reps if n else None


def device_breakdown(fn, reps: int = 3) -> tuple[float | None, str]:
    """(device ms per call, kernel_breakdown's text); None when the trace
    holds no device time."""
    rows = device_rows(fn, reps)
    if not rows:
        return None, "not measured"
    total = sum(r[0] for r in rows)
    return total, f"total {total:.3f} ms; " + "; ".join(
        f"{key[:60]}: {ms:.3f} ms / {n:g}" for ms, n, key in rows[:8])


def library_encoder(tables, dtype):
    """nn.TransformerEncoder with K2's weights: the library yardstick."""
    L, _, H = tables["wqkv"].shape
    layer = torch.nn.TransformerEncoderLayer(H, tables["heads"], tables["w1"].shape[1],
                                             dropout=0.0, activation="gelu",
                                             layer_norm_eps=tables["eps"], batch_first=True,
                                             norm_first=False)
    lib = torch.nn.TransformerEncoder(layer, L, enable_nested_tensor=False)
    with torch.no_grad():
        for l, m in enumerate(lib.layers):
            m.self_attn.in_proj_weight.copy_(tables["wqkv"][l])
            m.self_attn.in_proj_bias.copy_(tables["bqkv"][l])
            m.self_attn.out_proj.weight.copy_(tables["wo"][l])
            m.self_attn.out_proj.bias.copy_(tables["bo"][l])
            m.linear1.weight.copy_(tables["w1"][l])
            m.linear1.bias.copy_(tables["b1"][l])
            m.linear2.weight.copy_(tables["w2"][l])
            m.linear2.bias.copy_(tables["b2"][l])
            for norm, p in ((m.norm1, tables["ln1"][l]), (m.norm2, tables["ln2"][l])):
                norm.weight.copy_(p[0])
                norm.bias.copy_(p[1])
    return lib.to(tables["wqkv"].device, dtype).eval()


def phase9(face, card: str) -> dict:
    """Times at B = 1 and 8 (bf16 tables), in the order plain, kernel,
    kernel, plain; returns the B = 1 numbers of K2 and K3 for the JSON."""
    from talkshow_torch.kernels import wav2vec_extractor as k3
    from talkshow_torch.kernels import wav2vec_layers as k2
    from talkshow_torch.models.wav2vec_fused import face_apply_fused, pack_face_tables
    dev = next(face.parameters()).device
    enc = face.audio_encoder
    t16 = pack_face_tables(face, torch.bfloat16)
    t32 = k2.pack_encoder_tables(enc, torch.float32)
    lib16, lib32 = library_encoder(t16["enc"], torch.bfloat16), library_encoder(t32, torch.float32)
    gen = torch.Generator().manual_seed(9)
    res = {}
    for B in (1, 8):
        x = torch.randn((B, 300, 768), generator=gen).to(dev)
        wave = speech(B, 10.0, 90 + B, dev)
        onehot = torch.zeros((B, 4), device=dev)
        pad = torch.zeros((B, 300), dtype=torch.bool, device=dev)
        with torch.no_grad():
            lib_err = (lib32(x, src_key_padding_mask=pad)
                       - k2.encoder_layers_plain(t32, x)).abs().max().item()
            x16 = x.to(torch.bfloat16)
            rows = {
                "K2 wav2vec_layers": (lambda: k2.encoder_layers_kernel(t16["enc"], x),
                                      lambda: k2.encoder_layers_plain(t16["enc"], x)),
                "K3 wav2vec_extractor": (lambda: k3.extractor_kernel(t16["ext"], wave),
                                         lambda: k3.extractor_plain(t16["ext"], wave)),
                "face_apply_fused": (lambda: face_apply_fused(face, wave, onehot, 300,
                                                              tables=t16),
                                     lambda: face(wave, onehot, 300)),
            }
            for name, (kern, plain) in rows.items():
                p1, k1, k2_, p2 = cuda_ms(plain), cuda_ms(kern, 5), cuda_ms(kern, 5), cuda_ms(plain)
                res[(name, B)] = ((k1 + k2_) / 2, (p1 + p2) / 2)
                extra = ""
                if name.startswith("K2"):
                    lib_ms = cuda_ms(lambda: lib16(x16, src_key_padding_mask=pad), 5)
                    lib_graph = graph_ms(lambda: lib16(x16))
                    res[("library", B)] = lib_ms
                    extra = (f"; library nn.TransformerEncoder bf16 {lib_ms:.3f} ms eager, "
                             f"{lib_graph:.3f} ms replayed from a CUDA graph (its f32 output vs "
                             f"the plain f32 stack max|d| {lib_err:.2e})")
                log(f"phase 9 {name} B={B}: kernel (bf16 tables) {k1:.3f} / {k2_:.3f} ms, "
                    f"plain {p1:.3f} / {p2:.3f} ms{extra} [{card}]")
            for name, fn in (("K2", rows["K2 wav2vec_layers"][0]),
                             ("K3", rows["K3 wav2vec_extractor"][0])):
                dev_ms, text = device_breakdown(fn)
                idle = ("not measured" if dev_ms is None else
                        f"{1 - dev_ms / cuda_ms(fn, 5):.1%} of the call's wall time")
                log(f"phase 9 {name} B={B} device time by kernel: {text}; device idle {idle} "
                    f"[{card}]")
    res["x1"] = torch.randn((1, 300, 768), generator=gen).to(dev)
    res["t16"] = t16
    return res


def code_distances(x, emb, e2):
    """-2 x.E^T + ||e||^2, the f32 expression both K4 versions minimise."""
    return -2.0 * (x @ emb.T) + e2[None, :]


def check_codes(tag: str, idx, x, emb, e2, want=None) -> tuple[int, int, float]:
    """Hold indices to the plain distance matrix of (x, emb): on every row
    the picked code's distance within 1e-5 (1 + |best|) of the row's
    minimum; against `want`, equal except on near-tie rows (best and
    second-best within that tolerance).  Returns (near-tie rows, rows that
    differ from want, largest distance excess of a pick)."""
    dist = code_distances(x, emb, e2)
    top2 = dist.topk(2, dim=1, largest=False).values
    tol = 1e-5 * (1 + top2[:, 0].abs())
    near = (top2[:, 1] - top2[:, 0]) <= tol
    excess = dist.gather(1, idx[:, None])[:, 0] - top2[:, 0]
    if not bool((excess <= tol).all()):
        raise AssertionError(f"{tag}: a picked code is {excess.max().item()} past the minimum")
    differ = 0
    if want is not None:
        diff = idx != want
        if bool((diff & ~near).any()):
            raise AssertionError(f"{tag}: indices differ on {int((diff & ~near).sum())} rows "
                                 f"that are not near-ties")
        differ = int(diff.sum())
    return int(near.sum()), differ, excess.max().item()


def phase10(dev) -> float:
    """K4 against its plain version at full width; returns the largest
    distance excess of the kernel's picks."""
    from talkshow_torch.kernels import nearest_code as k4
    K, D = TRAIN["codes"], TRAIN["dim"]
    gen = torch.Generator().manual_seed(10)
    limit = (6.0 / (K + D)) ** 0.5               # init_vq_state's codebook
    emb0 = (torch.rand((K, D), generator=gen) * 2 - 1) * limit
    dup = torch.arange(8) * 7
    emb0[K - 8:] = emb0[dup]                     # exact duplicates: the lower index must win
    emb0 = emb0.to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for N, Kc in ((1, K), (75, K), (2816, K), (75, K - 1), (2816, K - 1)):
        emb = emb0[:Kc]                          # K - 1: a ragged last slice
        e2 = k4.code_norms(emb)
        plan = k4.search_plan(N, Kc, D, sms)
        twins = [(int(a), b) for a, b in zip(dup, range(K - 8, Kc))]
        if plan.cluster < 2 or any(a // plan.slice == b // plan.slice for a, b in twins):
            raise AssertionError(f"phase 10 K4 N={N} K={Kc}: a duplicated code shares its "
                                 f"twin's slice ({plan})")
        x = 0.05 * torch.randn((N, D), generator=gen)
        n8 = min(N, 8)
        x[:n8] = emb0[dup[:n8]].cpu()            # rows sitting on a duplicated code
        x = x.to(dev)
        idx = k4.nearest_code_kernel(x, emb)
        again = k4.nearest_code_kernel(x, emb)
        plain = k4.nearest_code_plain(x, emb, e2)
        torch.cuda.synchronize()
        if not (torch.equal(idx, again) and torch.equal(idx[:n8].cpu(), dup[:n8])):
            raise AssertionError(f"phase 10 K4 N={N} K={Kc}: runs differ or a tie took the "
                                 f"higher index")
        near, differ, excess = check_codes(f"phase 10 K4 N={N} K={Kc}", idx, x, emb, e2, plain)
        worst = max(worst, excess)
        log(f"phase 10 K4 N={N} codebook ({Kc}, {D}), plan {plan.rows}-row tiles x cluster "
            f"{plan.cluster} of {plan.slice} codes = {plan.ctas} CTAs, {plan.smem} B shared: "
            f"two runs equal bit for bit, exact ties across slices take the lower index, "
            f"indices equal to plain on {N - differ}/{N} rows ({differ} differ, all near-ties; "
            f"{near} near-tie rows; the kernel sums ||e||^2 itself in depth order, the plain "
            f"version with torch.sum, so e2 may differ by ulps), largest distance excess of a "
            f"pick {excess:.3e} <= 1e-5 (1 + |best|)")
    return worst


def write_train_config(path: str) -> None:
    """A reference-format stage-1 config at full width: batch 128, window 88."""
    cfg = {"Data": {"pose": {"generate_length": TRAIN["window"]}},
           "Model": {"model_name": "s2g_body_vq", "code_num": TRAIN["codes"]},
           "DataLoader": {"batch_size": TRAIN["batch"]},
           "Train": {"epochs": 1, "learning_rate": {"generator_learning_rate": 1e-4}},
           "Log": {"save_every": 1, "print_every": 5, "name": "body-vq"}}
    with open(path, "w") as f:
        json.dump(cfg, f)


def flat_state(state) -> dict:
    out = {}
    for part, model in state.models.items():
        out.update({f"{part}.{k}": v for k, v in model.state_dict().items()})
        out.update({f"{part}.vq.{k}": v for k, v in state.vq[part]._asdict().items()})
    return out


def phase11(dev, tmp: str) -> dict:
    """Stage-1 training through `python -m talkshow_torch.train`'s entry
    point at full width; resume; one step CUDA against CPU; the token
    encode.  Returns what phase 12 times and the K4 launch count."""
    import copy
    import re

    from talkshow_torch.kernels import counts
    from talkshow_torch.kernels.nearest_code import code_norms, nearest_code_plain
    from talkshow_torch.models.vqvae import VQVAE
    from talkshow_torch.ops import vq as vq_ops
    from talkshow_torch.ops.pose import BODY_DIM, HAND_DIM
    from talkshow_torch.train.__main__ import main as train_main
    from talkshow_torch.train.steps import (PARTS, conv_channels, make_body_vq_step,
                                            make_token_encoder, part_losses)
    cfg = os.path.join(tmp, "body_vq.json")
    write_train_config(cfg)
    run_a, run_b = os.path.join(tmp, "run_a"), os.path.join(tmp, "run_b")
    argv = ["--config_file", cfg, "--synthetic", "--epochs", "1", "--device", str(dev)]
    counts.clear()
    t0 = time.time()
    trainer = train_main(argv + ["--run_dir", run_a])
    torch.cuda.synchronize()
    seen, steps = dict(counts), trainer.global_step
    width = trainer.state.models["body"].encoder.pre_vq_conv.in_channels
    if (steps < 10 or width != TRAIN["num_hiddens"] or seen.get("nearest_code", 0) != 2 * steps
            or seen.get("nearest_code_plain", 0)):
        raise AssertionError(f"phase 11: {steps} steps, width {width}, counts {seen}")
    with open(os.path.join(run_a, "train.log")) as f:
        logged = [float(v) for line in f for _, v in re.findall(r"(\w+)=(\S+)", line)]
    with open(os.path.join(run_a, "history.json")) as f:
        hist = json.load(f)
    logged += [v for h in hist for k, v in h.items() if k != "epoch"]
    ckpt = os.path.join(run_a, "ckpt-0.pt")
    if not (logged and all(math.isfinite(v) for v in logged) and os.path.isfile(ckpt)):
        raise AssertionError(f"phase 11: logged values {logged[:12]}, checkpoint "
                             f"{os.path.isfile(ckpt)}")
    log(f"phase 11 train: python -m talkshow_torch.train s2g_body_vq, batch {TRAIN['batch']}, "
        f"window {TRAIN['window']}, num_hiddens {TRAIN['num_hiddens']}: {steps} steps in "
        f"{time.time() - t0:.1f} s (first cuDNN calls included); "
        f"{len(logged)} logged values all finite; nearest_code launches "
        f"{seen['nearest_code']} = 2 x {steps}, plain calls 0; {os.path.basename(ckpt)} written")

    # resume + one step == the uninterrupted run's next step
    resumed = train_main(argv + ["--run_dir", run_b, "--resume", ckpt])
    batch = next(trainer.dataset.batches(TRAIN["batch"], np.random.default_rng(99)))
    batch = {"poses": batch["poses"]}
    _, m_a = trainer.step_fn(trainer.state, trainer.put_batch(batch))
    _, m_b = resumed.step_fn(resumed.state, resumed.put_batch(batch))
    fa, fb = flat_state(trainer.state), flat_state(resumed.state)
    same = all(float(m_a[k]) == float(m_b[k]) for k in m_a) and all(
        torch.equal(v, fb[k]) for k, v in fa.items())
    if not same:
        raise AssertionError("phase 11: resume + one step differs from the uninterrupted run")
    log(f"phase 11 resume: ckpt-0 + one step equals the uninterrupted run's next step bit for "
        f"bit ({len(fa)} tensors, {len(m_a)} metrics)")
    del resumed

    # one step from one state, CUDA against CPU (B = 8, full width, TF32 off)
    lr = 1e-4

    def fresh(device):
        vb = VQVAE(BODY_DIM, TRAIN["dim"], TRAIN["num_hiddens"])
        vh = VQVAE(HAND_DIM, TRAIN["dim"], TRAIN["num_hiddens"])
        init, step = make_body_vq_step(vb, vh, lr, code_num=TRAIN["codes"])
        return init(torch.Generator().manual_seed(11), device), step

    (s_cpu, step_cpu), (s_gpu, step_gpu) = fresh("cpu"), fresh(dev)
    poses8 = torch.as_tensor(batch["poses"][:8])
    conv8 = conv_channels(poses8)
    skip_codes, idx_note = {}, []
    for name, sl in PARTS:
        with torch.no_grad():
            zc = copy.deepcopy(s_cpu.models[name]).train().encoder(conv8[..., sl])
            zg = copy.deepcopy(s_gpu.models[name]).train().encoder(conv8[..., sl].to(dev))
        zc = zc.reshape(-1, TRAIN["dim"])
        emb = s_cpu.vq[name].embeddings
        want = nearest_code_plain(zc, emb)
        got = vq_ops.nearest_code(zg.reshape(-1, TRAIN["dim"]), s_gpu.vq[name].embeddings).cpu()
        near, differ, _ = check_codes(f"phase 11 {name} indices", got, zc, emb, code_norms(emb),
                                      want)
        skip_codes[name] = torch.cat([want[got != want], got[got != want]]).unique()
        idx_note.append(f"{name} {zc.shape[0] - differ}/{zc.shape[0]} equal ({near} near-ties)")
    # f64 reference gradients on the CPU: the encoder's (behind the
    # straight-through estimator and three levels of batch-statistics
    # BatchNorm, 1024 channels at 176 positions) carry ~1e-2 of max|g| of
    # f32 rounding on either device; the decoder's ~1e-4
    g64 = {}
    for name, sl in PARTS:
        m64 = copy.deepcopy(s_cpu.models[name]).double().train()
        vq64 = vq_ops.VQState(*(t.double() if t.is_floating_point() else t
                                for t in s_cpu.vq[name]))
        sum(part_losses(m64, vq64, conv8[..., sl].double())[:3]).backward()
        g64[name] = {k: p.grad for k, p in m64.named_parameters()}
        del m64
    _, mc = step_cpu(s_cpu, {"poses": poses8})
    _, mg = step_gpu(s_gpu, {"poses": poses8.to(dev)})
    rel = max(abs(float(mg[k]) - float(mc[k])) / max(abs(float(mc[k])), 1e-12)
              for k in mc if k != "nonfinite_skips")
    g_err = dec_err = enc_gpu = enc_cpu = p_err = stat_err = vq_err = 0.0
    within, total = 0, 0
    for name, _ in PARTS:
        pc = dict(s_cpu.models[name].named_parameters())
        pg = dict(s_gpu.models[name].named_parameters())
        gmax = max(g.abs().max().item() for g in g64[name].values())
        for k, p in pc.items():
            gc, gg, gr = p.grad.double(), pg[k].grad.cpu().double(), g64[name][k]
            g_err = max(g_err, (gg - gc).abs().max().item() / gmax)
            if k.startswith("decoder."):
                dec_err = max(dec_err, (gg - gc).abs().max().item() / gmax)
            else:
                enc_gpu = max(enc_gpu, (gg - gr).abs().max().item() / gmax)
                enc_cpu = max(enc_cpu, (gc - gr).abs().max().item() / gmax)
            d = (pg[k].detach().cpu() - p.detach()).abs()
            p_err = max(p_err, d.max().item())
            within += int((d <= 1e-2 * lr).sum())
            total += d.numel()
        bc, bg = s_cpu.models[name].state_dict(), s_gpu.models[name].state_dict()
        stat_err = max(stat_err, max((bg[k].cpu() - v).abs().max().item() for k, v in bc.items()
                                     if k.endswith(("running_mean", "running_var"))))
        keep = torch.ones(TRAIN["codes"], dtype=torch.bool)
        keep[skip_codes[name]] = False
        for a, b in zip(s_gpu.vq[name], s_cpu.vq[name]):
            a = a.cpu()
            vq_err = max(vq_err, (a[keep].double() - b[keep].double()).abs().max().item()
                         if a.dim() else abs(int(a) - int(b)))
    # Adam's first step moves a parameter by at most lr; 1e-3 of it covers
    # the rounding of the stored values.  It moves each by about lr sign(g),
    # so only parameters whose gradient is near zero beside its f32 rounding
    # (conv biases under batch-statistics BatchNorm, small encoder
    # gradients) may take another sign on the card: at least 99 % must land
    # within 1e-2 lr of the CPU's, which a missing, scaled or reversed
    # update fails
    share = within / total
    if not (rel <= 1e-4 and dec_err <= 1e-3 and enc_gpu <= 2e-2 and stat_err <= 1e-4
            and vq_err <= 1e-4 and p_err <= 2 * lr * (1 + 1e-3) and share >= 0.99):
        raise AssertionError(f"phase 11 CUDA vs CPU: losses rel {rel}, decoder grads {dec_err} "
                             f"of max, encoder grads vs f64 {enc_gpu} (CPU f32 {enc_cpu}), "
                             f"statistics {stat_err}, VQ states {vq_err}, params {p_err}, "
                             f"share within 1e-2 lr {share}")
    log(f"phase 11 CUDA vs CPU, one step from one state (B=8, T={TRAIN['window']}, full width, "
        f"TF32 off): indices {', '.join(idx_note)}; losses within {rel:.2e} relative <= 1e-4; "
        f"decoder gradients within {dec_err:.2e} of max|g| <= 1e-3; encoder gradients vs an "
        f"f64 CPU reference within {enc_gpu:.2e} of max|g| <= 2e-2 (the CPU's f32: "
        f"{enc_cpu:.2e}); all gradients CUDA vs CPU within {g_err:.2e} (reported); BatchNorm "
        f"statistics within {stat_err:.2e}, VQ states within {vq_err:.2e} <= 1e-4 (codes of "
        f"differing rows left out: {sum(len(v) for v in skip_codes.values())}); parameters "
        f"within {p_err:.2e} <= 2 lr = {2 * lr:g}, {share:.4%} of them within 1e-2 lr = "
        f"{1e-2 * lr:g} >= 99 %")
    del s_cpu, s_gpu

    # the frozen-token encode
    enc = make_token_encoder(trainer.state.models["body"], trainer.state.models["hand"],
                             trainer.state.vq)
    poses128 = torch.as_tensor(batch["poses"], device=dev)
    counts.clear()
    tok = enc(poses128)
    torch.cuda.synchronize()
    if counts["nearest_code"] != 2 or tuple(tok.shape) != (TRAIN["batch"], TRAIN["window"] // 4, 2):
        raise AssertionError(f"phase 11 token encode: shape {tuple(tok.shape)}, counts {dict(counts)}")
    log(f"phase 11 token encode: make_token_encoder on B={TRAIN['batch']} -> "
        f"{tuple(tok.shape)} int64, nearest_code launches {counts['nearest_code']}")
    return dict(trainer=trainer, batch=batch, encode=enc, poses=poses128,
                launches=seen["nearest_code"], steps=steps)


def phase12(train: dict, card: str) -> dict:
    """Times: the body-VQ step, K4 against its plain version and the
    two-call yardstick, the token encode; returns K4's numbers at N = 2816."""
    from talkshow_torch.kernels import nearest_code as k4
    from talkshow_torch.ops import vq as vq_ops
    trainer = train["trainer"]
    batch = trainer.put_batch(train["batch"])
    times = []
    for _ in range(11):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.step_fn(trainer.state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    p50 = float(np.median(times[1:]))
    log(f"phase 12 body-VQ step B={TRAIN['batch']} T={TRAIN['window']}: p50 {p50:.2f} ms over "
        f"{len(times) - 1} steps (min {min(times[1:]):.2f}, max {max(times[1:]):.2f}), "
        f"{TRAIN['batch'] / p50 * 1e3:.1f} windows/s [{card}]")
    log(f"phase 12 body-VQ step device time by kernel: "
        f"{kernel_breakdown(lambda: trainer.step_fn(trainer.state, batch), reps=1)} [{card}]")
    # for the record only, how the step time splits between determinism and
    # precision: cuDNN free to pick non-deterministic algorithms (by its
    # heuristics, then by timing them), still f32; then TF32 on, deterministic
    # again.  Both change what the port is held to (bit-equal resume, f32 sums)
    step_once = lambda: trainer.step_fn(trainer.state, batch)   # noqa: E731
    cudnn = torch.backends.cudnn
    cudnn.deterministic = False
    nondet_ms = cuda_ms(step_once, 5)
    cudnn.benchmark = True          # cuda_ms's warm-up call times the algorithms
    bench_ms = cuda_ms(step_once, 5)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = True
    tf32_ms = cuda_ms(step_once, 5)
    torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False
    log(f"phase 12 body-VQ step, not the port's settings: TF32 off with cuDNN's "
        f"non-deterministic algorithms {nondet_ms:.2f} ms (heuristic choice), "
        f"{bench_ms:.2f} ms (cudnn.benchmark); TF32 on, deterministic {tf32_ms:.2f} ms "
        f"[{card}]")
    emb = trainer.state.vq["body"].embeddings
    e2 = k4.code_norms(emb)
    gen = torch.Generator().manual_seed(12)
    res = {}
    for N in (75, 2816):
        x = (0.05 * torch.randn((N, TRAIN["dim"]), generator=gen)).to(emb.device)
        kern = lambda: k4.nearest_code_kernel(x, emb)             # noqa: E731
        step_call = lambda: vq_ops.nearest_code(x, emb)           # noqa: E731
        plain = lambda: k4.nearest_code_plain(x, emb, e2)         # noqa: E731
        lib = lambda: torch.argmin(torch.addmm(e2, x, emb.T, alpha=-2), 1)  # noqa: E731
        # in turns: plain, kernel, yardstick, step call, step call, yardstick, kernel, plain
        p1, k1, l1, o1 = (cuda_ms(f, 50) for f in (plain, kern, lib, step_call))
        o2, l2, k2, p2 = (cuda_ms(f, 50) for f in (step_call, lib, kern, plain))
        res[N] = ((k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2, x)
        bms, by = bound(nbytes(x, emb) + N * 8, 2.0 * N * emb.numel() + 2.0 * emb.numel(),
                        F32_FLOP_S)
        log(f"phase 12 K4 nearest_code N={N} K={TRAIN['codes']} D={TRAIN['dim']}: kernel "
            f"{k1:.4f} / {k2:.4f} ms, through ops/vq.nearest_code (the step's call, ||e||^2 "
            f"included) {o1:.4f} / {o2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, two-call "
            f"yardstick argmin(addmm) {l1:.4f} / {l2:.4f} ms; bound {bms:.4f} ms ({by}), the "
            f"kernel at {bms / ((k1 + k2) / 2):.1%} of it [{card}]")
        launches = launches_per_call(step_call)
        if launches is not None and round(launches) != 1:
            raise AssertionError(f"phase 12 K4 N={N}: ops/vq.nearest_code launched {launches:g} "
                                 f"kernels a call")
        log(f"phase 12 K4 N={N} ops/vq.nearest_code device time by kernel: "
            f"{kernel_breakdown(step_call, reps=20)}; kernel launches a call (CUDA runtime "
            f"calls in the trace) {'not measured' if launches is None else f'{launches:g}'} "
            f"[{card}]")
    # why search_plan takes 8-row tiles at N = 75, 64-row tiles at 300, and
    # two passes a CTA at 2816: each choice's device time a launch
    K, D = emb.shape
    sms = torch.cuda.get_device_properties(emb.device).multi_processor_count
    alts = []
    for N, plans in ((75, [k4.tile_plan(75, K, D, 1), k4.tile_plan(75, K, D, 0)]),
                     (300, [k4.tile_plan(300, K, D, 1), k4.tile_plan(300, K, D, 0)]),
                     (2816, [k4.tile_plan(2816, K, D, 0), k4.tile_plan(2816, K, D, 0, 2)])):
        x = (0.05 * torch.randn((N, D), generator=gen)).to(emb.device)
        idx = torch.empty((N,), dtype=torch.int64, device=emb.device)
        for plan in plans:
            launch = lambda: k4._lib().talkshow_nearest_code(       # noqa: E731
                N, K, D, plan.variant, plan.cluster, plan.slice, x.data_ptr(), emb.data_ptr(),
                idx.data_ptr(), emb.device.index,
                torch._C._cuda_getCurrentRawStream(emb.device.index))
            if launch() or not torch.equal(idx, k4.nearest_code_plain(x, emb, e2)):
                raise AssertionError(f"phase 12 K4 N={N} {plan}: refused or not the plain indices")
            rows = device_rows(launch, reps=50)
            us = "not measured" if not rows else f"{rows[0][0] / rows[0][1] * 1e3:.2f} us"
            chosen = " (search_plan's)" if plan == k4.search_plan(N, K, D, sms) else ""
            alts.append(f"N={N} {plan.rows}-row tiles x cluster {plan.cluster}, {plan.passes} "
                        f"pass(es), {plan.ctas} CTAs{chosen}: {us}")
    log(f"phase 12 K4 plans, device time a launch: {'; '.join(alts)} [{card}]")
    enc_ms = cuda_ms(lambda: train["encode"](train["poses"]), 10)
    log(f"phase 12 token encode B={TRAIN['batch']} T={TRAIN['window']}: {enc_ms:.3f} ms [{card}]")
    res["emb"] = emb
    return res


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
    from concurrent.futures import ThreadPoolExecutor

    from talkshow_torch.kernels import (_build, ar_decode, counts, nearest_code,
                                        wav2vec_extractor, wav2vec_layers)
    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        sos = list(pool.map(_build.build, KERNELS))
    for mod in (ar_decode, wav2vec_layers, wav2vec_extractor, nearest_code):
        mod._lib()
    log(f"phase 2 build: {', '.join(os.path.relpath(so) for so in sos)} built and loaded "
        f"in {time.time() - t0:.1f} s")

    # ---- phase 3: K1 against its plain version -------------------------------
    max_err = phase3(dev)
    phase3d(dev)

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
    feat = get_mfcc(wav1, device="cpu").numpy()
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

    decode = phase5_k1(dev, card)

    # ---- phases 6-9: the fused face stage (K2, K3) -------------------------------
    err_k2 = phase6(dev)
    phase6_gemm(dev, card)
    err_k3 = phase7(dev)
    face_launches = phase8(pipe.face_model, speech(1, 10.0, 0, dev))
    times = phase9(pipe.face_model, card)
    del pipe

    # ---- phases 10-12: training stage 1 and K4 -----------------------------------
    err_k4 = phase10(dev)
    train = phase11(dev, tmp)
    k4_times = phase12(train, card)

    # bounds at B = 1 (K4: N = 2816, one quantizer's rows of a training batch)
    # from the timed inputs
    t1 = ar_decode.pack_decode_tables(prior_case(1, 41, dev)[0], torch.bfloat16)
    # MACs per row: both columns of the vertical stack, v2h and fusion_v, and
    # the chain's streams (both columns' horizontal passes and heads)
    d, L, H = FULL["dim"], FULL["layers"], FULL["H"]
    steps = ar_decode.chain_steps(L, d, FULL["K"], 512)
    chain_macs = sum(klen * n * urows for _, _, _, klen, n, urows in steps)
    # column 1 reads every chain table (column 0 reads a part of wh): bf16 bytes
    chain_bytes = sum(2 * klen * n * urows for _, c, _, klen, n, urows in steps if c == 1)
    k1_ops = 2.0 * H * (t1["wv0"].numel() + t1["wvB"].numel() + 2 * t1["wv2h"].numel()
                        + 2 * t1["wfv"].numel() + chain_macs)
    k1_bytes = nbytes(*(v for k, v in t1.items() if k != "chain")) + chain_bytes \
        + H * 2 * 4 + 4 * (L * 2 * d + 2 * H * d)
    enc_t, ext_t = times["t16"]["enc"], times["t16"]["ext"]
    x1 = times["x1"]
    k2_bytes = nbytes(*(v for v in enc_t.values() if torch.is_tensor(v))) + 2 * nbytes(x1) + 4
    k3_bytes = nbytes(ext_t["w0"], ext_t["ws"], ext_t["gn"]) + 160000 * 4 + 499 * 512 * 4
    k4_ms, k4_plain, _, k4_x = k4_times[2816]
    N4, K4, D4 = k4_x.shape[0], TRAIN["codes"], TRAIN["dim"]
    k4_bytes = nbytes(k4_x, k4_times["emb"]) + N4 * 8
    rows = [
        ("ar_decode", "B=1", ar_decode, launches, max_err, decode[1],
         bound(k1_bytes, k1_ops), None),
        ("wav2vec_layers", "B=1", wav2vec_layers, face_launches["wav2vec_layers"], err_k2,
         times[("K2 wav2vec_layers", 1)], bound(k2_bytes, k2_ops([300], 300, enc_t)),
         times[("library", 1)]),
        ("wav2vec_extractor", "B=1", wav2vec_extractor, face_launches["wav2vec_extractor"],
         err_k3, times[("K3 wav2vec_extractor", 1)], bound(k3_bytes, k3_ops(1, 160000, ext_t)),
         None),
        # f32 sums, so the f32 peak; no single PyTorch call computes K4 (phase 12 times
        # the two-call argmin(addmm) yardstick)
        ("nearest_code", f"N={N4}", nearest_code, train["launches"], err_k4, (k4_ms, k4_plain),
         bound(k4_bytes, 2.0 * (N4 + 1) * K4 * D4, F32_FLOP_S), None),
    ]
    for name, shape, _, n, _, (ms, plain_ms), (bms, by), _ in rows:
        log(f"bound {name} {shape}: {bms:.4f} ms ({by}); kernel {ms:.4f} ms = {bms / ms:.1%} "
            f"of the bound's rate; launches on the main path {n}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
        "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
        for name, _, mod, n, err, (ms, plain_ms), (bms, by), lib_ms in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
