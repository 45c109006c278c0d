"""Face generator: speech -> jaw pose (3) + expression (100)
(port of talkshow_tpu/models/face.py:24-114, inference path).

raw 16 kHz waveform -> wav2vec 2.0 (50 Hz -> 30 fps mid-stack) -> Linear
768->256 -> identity-conditioned conv middle -> jaw and expression conv
heads.  Output (B, T, 103) = [jaw3 | exp100] at 30 fps.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from talkshow_torch.models.layers import CNR1d, SeqTranslator1D, length_mask
from talkshow_torch.models.wav2vec import Wav2Vec2Config, Wav2Vec2Encoder


class FaceAudioMiddle(nn.Module):
    """Identity-conditioned conv middle (s2g_face.py:107-139): a 1x1 conv of
    the speaker one-hot to 64 channels, concatenated, then 3 residual
    LayerNorm conv blocks."""

    def __init__(self, in_dim: int = 256, out_dim: int = 256, num_classes: int = 4):
        super().__init__()
        self.id_mlp = nn.Conv1d(num_classes, 64, 1)
        self.first_net = SeqTranslator1D(in_dim + 64, out_dim, min_layers_num=3,
                                         residual=True)

    def forward(self, x, id_onehot, frame_mask=None):
        idf = id_onehot[:, None, :].float().expand(x.shape[0], x.shape[1], -1)
        idf = self.id_mlp(idf.transpose(1, 2)).transpose(1, 2)
        return self.first_net(torch.cat([x, idf], dim=-1), frame_mask)


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
        self.audio_encoder = Wav2Vec2Encoder(cfg)
        self.audio_feature_map = nn.Linear(cfg.hidden_size, 256)
        self.audio_middle = FaceAudioMiddle(256, 256, num_classes)
        self.heads = FaceDecoderHeads(256, jaw_dim, exp_dim)

    def forward(self, waveform, id_onehot, time_steps: int,
                valid_samples=None, valid_frames=None):
        """valid_samples / valid_frames (B,) select the length-masked path:
        real frames equal the unpadded program's (Wav2Vec2Encoder)."""
        hidden = self.audio_encoder(waveform, time_steps, valid_samples, valid_frames)
        return self.from_features(hidden, id_onehot, valid_frames)

    def from_features(self, hidden, id_onehot, valid_frames=None):
        """Heads on precomputed wav2vec features (B, T, hidden); with
        valid_frames, padded frames are zeroed at every conv's entry through
        the middle and the heads."""
        frame_mask = None
        if valid_frames is not None:
            frame_mask = length_mask(valid_frames.to(hidden.device), hidden.shape[1])
        feature = self.audio_middle(self.audio_feature_map(hidden), id_onehot, frame_mask)
        return self.heads(feature, frame_mask)
