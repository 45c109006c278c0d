"""The yardstick's arithmetic of the WavLM face (`talkshow-wavlm-large`):
the work of its two hand-written stages per clip, K3 (the conv extractor)
and K2 (the layer stack with its gated bias), each as FLOPs and the bytes
it must move, and the model FLOPs of a whole face stage, counted over the
reference.  Least times are `counts.least_s` (the H100's published HBM
rate and bf16 dense peak)."""
from __future__ import annotations

import functools
import json

import torch

from benchmark import counts

#: bytes of a table value at the configuration's face-table type
_ESIZE = {"bfloat16": 2, "float32": 4}


def frames(wav_len: int) -> int:
    """30 fps frames of a 16 kHz clip (the face stage's output length)."""
    return wav_len * 30 // 16000


def extractor_frames(cfg: dict, wav_len: int) -> list:
    """Output frames of each conv layer (VALID)."""
    w, out, n = cfg["wav2vec"], [], wav_len
    for k, s in zip(w["conv_kernel"], w["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def extractor_work(cfg: dict, wav_len: int) -> tuple[float, float]:
    """(FLOPs, bytes) of K3 on one clip: every conv's multiply-adds (a
    multiply-add is 2 FLOPs); the bytes it must move at least: the
    waveform in f32, every weight once at the table type, the LayerNorms
    in f32, and the features out in f32."""
    w = cfg["wav2vec"]
    e = _ESIZE[cfg["precision"]["face_tables"]]
    T = extractor_frames(cfg, wav_len)
    cin, flops, nw, nv = 1, 0.0, 0, 0
    for (k, c), t in zip(zip(w["conv_kernel"], w["conv_dim"]), T):
        flops += 2.0 * t * c * k * cin
        nw += c * k * cin
        nv += 2 * c
        cin = c
    return flops, 4.0 * wav_len + e * nw + 4.0 * nv + 4.0 * T[-1] * w["conv_dim"][-1]


def encoder_work(cfg: dict, T: int) -> tuple[float, float]:
    """(FLOPs, bytes) of K2 on one clip of T frames: per layer the four
    products (qkv, out, FFN in and out), the scores and the weighted sum
    over every key, and the gate's 2 x hd products a head and frame; the
    bytes: every matrix once at the table type, the vectors, gate and bias
    tables in f32, and the hidden states in and out in f32."""
    w = cfg["wav2vec"]
    e = _ESIZE[cfg["precision"]["face_tables"]]
    H, F, L, nh = w["hidden_size"], w["intermediate_size"], w["num_layers"], w["num_heads"]
    hd = H // nh
    per_layer = 2.0 * T * (4 * H * H + 2 * H * F) + 4.0 * T * T * H + 4.0 * T * nh * hd
    mats = L * (4 * H * H + 2 * H * F)
    vecs = L * (3 * H + H + F + H + 4 * H + 2 * hd + 2 + nh) + 2 * H
    table = nh * (2 * w["max_bucket_distance"] + 1)
    return L * per_layer, e * mats + 4.0 * (vecs + table) + 2 * 4.0 * T * H


def extractor_least_s(cfg: dict, wav_len: int) -> float:
    return counts.least_s(*reversed(extractor_work(cfg, wav_len)))


def encoder_least_s(cfg: dict, T: int) -> float:
    return counts.least_s(*reversed(encoder_work(cfg, T)))


@functools.lru_cache(maxsize=64)
def _face_flops(cfg_key: str, wav_len: int) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import wavlm
    cfg = json.loads(cfg_key)
    with torch.device("meta"):
        m = wavlm.build(cfg)["face"]
        with FlopCounterMode(display=False) as fc:
            m(torch.empty(1, wav_len), torch.empty(1, cfg["face"]["num_classes"]),
              frames(wav_len))
    return float(fc.get_total_flops())


def face_flops(cfg: dict, wav_len: int) -> float:
    """Model FLOPs of one `generate_face` call on `wav_len` samples,
    counted by FlopCounterMode over the reference on meta tensors."""
    return _face_flops(json.dumps(cfg, sort_keys=True), wav_len)
