"""Face generator: speech -> jaw pose (3) + expression (100)
(port of talkshow_tpu/models/face.py:24-114).

raw 16 kHz waveform -> wav2vec 2.0 (50 Hz -> 30 fps mid-stack) -> Linear
768->256 -> identity-conditioned conv middle -> jaw and expression conv
heads.  Output (B, T, 103) = [jaw3 | exp100] at 30 fps.

`forward` is the plain inference stage; `train_forward` is the face step's
forward from the frozen extractor's features, with SpecAugment's spans and
the middle's dropout (rate 0.1, JAX :34) given as masks.

`FaceGeneratorMeshtalk` (JAX :125-182) is the same middle and heads behind
the MeshTalk per-frame log-mel encoder; no CLI reaches it.

With `Wav2Vec2Config.dtype` bf16 (`--bf16` training) the 768 -> 256 feature
map computes in bf16, as flax's `Dense(dtype=...)` (JAX :75-77); the
middle and the heads stay f32 (their inputs are promoted, as flax
concatenates bf16 features with the f32 identity features).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from talkshow_torch.kernels import counts
from talkshow_torch.models.layers import CNR1d, SeqTranslator1D, dense, length_mask
from talkshow_torch.models.wav2vec import Wav2Vec2Config, Wav2Vec2Encoder


#: train-mode dropout rate at the conv middle's entry (talkshow_tpu/models/face.py:34)
FACE_DROPOUT = 0.1


def draw_drop_keep(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Bool keep mask of the middle's dropout, each element True with
    probability 1 - FACE_DROPOUT, drawn on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < 1.0 - FACE_DROPOUT).to(device)


class FaceAudioMiddle(nn.Module):
    """Identity-conditioned conv middle (s2g_face.py:107-139): a 1x1 conv of
    the speaker one-hot to 64 channels, concatenated, then 3 residual
    LayerNorm conv blocks."""

    def __init__(self, in_dim: int = 256, out_dim: int = 256, num_classes: int = 4):
        super().__init__()
        self.id_mlp = nn.Conv1d(num_classes, 64, 1)
        self.first_net = SeqTranslator1D(in_dim + 64, out_dim, min_layers_num=3,
                                         residual=True)

    def forward(self, x, id_onehot, frame_mask=None, drop_keep=None):
        """drop_keep (B, T, in_dim) bool: the train-mode dropout of x, kept
        elements scaled by 1 / (1 - FACE_DROPOUT), as flax's Dropout."""
        if drop_keep is not None:
            x = torch.where(drop_keep, x / (1.0 - FACE_DROPOUT), torch.zeros((), dtype=x.dtype,
                                                                             device=x.device))
        idf = id_onehot[:, None, :].float().expand(x.shape[0], x.shape[1], -1)
        idf = self.id_mlp(idf.transpose(1, 2)).transpose(1, 2)
        # a bf16 x is promoted to f32 here, as jnp.concatenate does
        return self.first_net(torch.cat([x.to(idf.dtype), idf], dim=-1), frame_mask)


class FaceDecoderHeads(nn.Module):
    """jaw: 3x CNR(->64, ln) + 1x1 -> 3; expression: 3x CNR(->256, ln) +
    1x1 -> 100 (s2g_face.py:179-194); returns [jaw | expression]."""

    def __init__(self, in_dim: int = 256, jaw_dim: int = 3, exp_dim: int = 100,
                 hidden: int = 256):
        super().__init__()
        self.jaw_cnr = nn.ModuleList(CNR1d(in_dim if i == 0 else 64, 64)
                                     for i in range(3))
        self.jaw_out = nn.Conv1d(64, jaw_dim, 1)
        self.exp_cnr = nn.ModuleList(CNR1d(in_dim if i == 0 else hidden, hidden)
                                     for i in range(3))
        self.exp_out = nn.Conv1d(hidden, exp_dim, 1)

    def forward(self, feature, frame_mask=None):
        h, g = feature, feature
        for layer in self.jaw_cnr:
            h = layer(h, frame_mask)
        for layer in self.exp_cnr:
            g = layer(g, frame_mask)
        jaw = self.jaw_out(h.transpose(1, 2)).transpose(1, 2)
        exp = self.exp_out(g.transpose(1, 2)).transpose(1, 2)
        return torch.cat([jaw, exp], dim=-1)


class FaceGenerator(nn.Module):
    """waveform (B, T_samples) + speaker one-hot -> (B, T_frames, 103)."""

    def __init__(self, wav2vec_cfg: Wav2Vec2Config | None = None,
                 num_classes: int = 4, jaw_dim: int = 3, exp_dim: int = 100):
        super().__init__()
        cfg = wav2vec_cfg or Wav2Vec2Config()
        self.num_classes = num_classes
        self.dtype = cfg.dtype
        self.audio_encoder = Wav2Vec2Encoder(cfg)
        self.audio_feature_map = nn.Linear(cfg.hidden_size, 256)
        self.audio_middle = FaceAudioMiddle(256, 256, num_classes)
        self.heads = FaceDecoderHeads(256, jaw_dim, exp_dim)

    def forward(self, waveform, id_onehot, time_steps: int,
                valid_samples=None, valid_frames=None):
        """valid_samples / valid_frames (B,) select the length-masked path:
        real frames equal the unpadded program's (Wav2Vec2Encoder).  This is
        the plain stage: each call adds one to counts["face_plain"]."""
        counts["face_plain"] += 1
        hidden = self.audio_encoder(waveform, time_steps, valid_samples, valid_frames)
        return self.from_features(hidden, id_onehot, valid_frames)

    def from_features(self, hidden, id_onehot, valid_frames=None, drop_keep=None):
        """Heads on precomputed wav2vec features (B, T, hidden); with
        valid_frames, padded frames are zeroed at every conv's entry through
        the middle and the heads; drop_keep as FaceAudioMiddle's."""
        frame_mask = None
        if valid_frames is not None:
            frame_mask = length_mask(valid_frames.to(hidden.device), hidden.shape[1])
        feature = self.audio_middle(dense(self.audio_feature_map, hidden, self.dtype), id_onehot,
                                    frame_mask, drop_keep)
        return self.heads(feature, frame_mask)

    def train_forward(self, feats, id_onehot, time_steps: int, valid_samples=None,
                      valid_frames=None, spec_starts=None, drop_keep=None):
        """The face step's forward (JAX `__call__` with train and
        freeze_extractor): `feats` (B, T50, C) are the frozen extractor's
        features of the waveform; spec_starts / drop_keep: SpecAugment's
        spans and the middle's dropout (None: that part is off)."""
        hidden = self.audio_encoder(None, time_steps, valid_samples, valid_frames, feats=feats,
                                    spec_starts=spec_starts)
        return self.from_features(hidden, id_onehot, valid_frames, drop_keep)


#: train-mode dropout rate after each MeshTalk dilated conv (talkshow_tpu/models/face.py:164)
MESHTALK_DROPOUT = 0.2


class MeshtalkEncoder(nn.Module):
    """Per-frame audio encoder from MeshTalk (s2g_face.py:41-104; JAX
    models/face.py:125-164): one second of 16 kHz audio per video frame ->
    log mel (n_fft 2048, hop 160, an 800-sample Hann window centred in the
    2048, 80 mels; `ops/audio.chunk_log_mel`) -> VALID conv k5 + leaky ReLU
    -> six VALID dilated k5 convs (dilation 2, 4, 6, 2, 4, 6) + leaky ReLU,
    each averaged with its input cropped to its length -> mean over time ->
    Linear to the latent code.  Train mode drops each dilated conv's output
    at MESHTALK_DROPOUT, masks drawn from `generator`."""

    def __init__(self, latent_dim: int = 128):
        super().__init__()
        self.convert_dimensions = nn.Conv1d(80, 128, 5)
        self.convs = nn.ModuleList(nn.Conv1d(128, 128, 5, dilation=2 * (i % 3 + 1))
                                   for i in range(6))
        self.code = nn.Linear(128, latent_dim)

    def forward(self, chunks: torch.Tensor, generator: torch.Generator | None = None):
        """chunks (B, T, 16000) -> (B, T, latent_dim)."""
        from talkshow_torch.ops.audio import chunk_log_mel
        B, T, N = chunks.shape
        x = chunk_log_mel(chunks.reshape(B * T, N), 16000, 800, 160, 80).transpose(1, 2)
        x = F.leaky_relu(self.convert_dimensions(x), 0.2)
        for conv in self.convs:
            h = F.leaky_relu(conv(x), 0.2)
            if self.training:
                if generator is None:
                    raise ValueError("a train-mode MeshtalkEncoder draws its dropout from a "
                                     "generator: pass one")
                keep = torch.rand(h.shape, generator=generator,
                                  device=generator.device).to(h.device) < 1.0 - MESHTALK_DROPOUT
                h = torch.where(keep, h / (1.0 - MESHTALK_DROPOUT), torch.zeros_like(h))
            crop = (x.shape[-1] - h.shape[-1]) // 2
            x = (x[..., crop:crop + h.shape[-1]] + h) / 2.0
        return self.code(x.mean(dim=-1)).reshape(B, T, -1)


class FaceGeneratorMeshtalk(nn.Module):
    """Face generator with the MeshTalk audio front end
    (encoder_choice='meshtalk', s2g_face.py:165-166, 201-203): per-frame
    chunks (B, T, 16000) + speaker one-hot -> (B, T, 103)."""

    def __init__(self, num_classes: int = 4, jaw_dim: int = 3, exp_dim: int = 100):
        super().__init__()
        self.audio_encoder = MeshtalkEncoder(latent_dim=256)
        self.audio_middle = FaceAudioMiddle(256, 256, num_classes)
        self.heads = FaceDecoderHeads(256, jaw_dim, exp_dim)

    def forward(self, chunks, id_onehot, generator: torch.Generator | None = None):
        feature = self.audio_encoder(chunks, generator)
        keep = None
        if self.training:
            keep = draw_drop_keep(feature.shape, generator, feature.device)
        return self.heads(self.audio_middle(feature, id_onehot, None, keep))
