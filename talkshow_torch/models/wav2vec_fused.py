"""The face stage through the hand-written wav2vec kernels
(port of talkshow_tpu/models/wav2vec_pallas.py:182-254).

`face_apply_fused` is `FaceGenerator.forward` with the conv extractor (K3,
`kernels/wav2vec_extractor.py`) and the transformer layer stack (K2,
`kernels/wav2vec_layers.py`) routed through the kernels; interpolation,
projection, positional conv and the conv heads stay plain PyTorch, as the
JAX package leaves them to flax.  Inference only.

As in the JAX package, the length-masked path (valid_samples given) runs
the masked extractor and `pre_layers` of the plain model (K3 computes
unmasked GroupNorm statistics only) and then K2 with the frame mask; it
adds one to ``counts["extractor_plain"]`` so that a run shows which route
it took.

A CUDA tensor launches the kernels (or raises); a CPU tensor runs their
plain versions.
"""
from __future__ import annotations

import torch

from talkshow_torch.kernels import counts
from talkshow_torch.kernels import wav2vec_extractor as k3
from talkshow_torch.kernels import wav2vec_layers as k2


def _route(t: torch.Tensor, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"the wav2vec kernels run on CUDA or CPU tensors, not {t.device}")


def pack_face_tables(face_model, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Both kernels' tables for a FaceGenerator (pack once per weight set):
    {'enc': K2 tables, 'ext': K3 tables}."""
    enc = face_model.audio_encoder
    return {"enc": k2.pack_encoder_tables(enc, dtype),
            "ext": k3.pack_extractor_tables(enc.feature_extractor, dtype)}


def encoder_layers_fused(encoder, x: torch.Tensor, valid_frames=None, *,
                         tables: dict | None = None,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The layer stack of `encoder` (a port Wav2Vec2Encoder) on (B, T, H)
    hidden states, keys at or beyond valid_frames[b] masked."""
    if tables is None:
        tables = k2.pack_encoder_tables(encoder, dtype)
    run = _route(x, k2.encoder_layers_kernel, k2.encoder_layers_plain)
    return run(tables, x.float().contiguous(), valid_frames)


def extractor_fused(encoder, waveform: torch.Tensor, *, tables: dict | None = None,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The conv feature extractor of `encoder` (unmasked): waveform (B, N)
    -> (B, T_out, C) f32."""
    if tables is None:
        tables = k3.pack_extractor_tables(encoder.feature_extractor, dtype)
    run = _route(waveform, k3.extractor_kernel, k3.extractor_plain)
    return run(tables, waveform.float().contiguous())


@torch.no_grad()
def face_apply_fused(face_model, waveform: torch.Tensor, id_onehot: torch.Tensor,
                     time_steps: int, valid_samples=None, valid_frames=None, *,
                     tables: dict | None = None,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """FaceGenerator.forward through K3 and K2: (B, N) waveform + (B, classes)
    one-hot -> (B, time_steps, 103).  valid_samples / valid_frames (B,)
    select the length-masked path (real frames equal the unpadded
    program's).  `tables` from `pack_face_tables` (bf16 is the production
    type, f32 the exact one)."""
    enc = face_model.audio_encoder
    if tables is None:
        tables = pack_face_tables(face_model, dtype)
    if valid_samples is None:
        feats = extractor_fused(enc, waveform, tables=tables["ext"])
        x = enc.mid_stack(feats, time_steps)
    else:
        counts["extractor_plain"] += 1
        x = enc.pre_layers(waveform, time_steps, valid_samples, valid_frames)
    hidden = encoder_layers_fused(enc, x, valid_frames, tables=tables["enc"])
    return face_model.from_features(hidden, id_onehot, valid_frames)
