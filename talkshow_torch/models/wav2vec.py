"""wav2vec 2.0 encoder, unmasked inference path
(port of talkshow_tpu/models/wav2vec.py:31-283).

CNN feature extractor (VALID convs, no bias, per-channel GroupNorm after
the first) -> linear interpolation 50 Hz -> 30 fps -> feature projection
-> grouped positional conv (even kernel: crop the last frame) -> encoder
LayerNorm -> post-norm transformer layers.  Parameter names follow
Hugging Face's Wav2Vec2Model, which talkshow_tpu/convert/wav2vec.py reads.
The attention is plain matmul + f32 softmax, as flax computes it.

The length-masked (bucketed) path and SpecAugment wait for the serving and
training slices (ROADMAP.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from talkshow_torch.models.layers import linear_interpolate


@dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, norm_eps: float | None):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, s, bias=False)
        # GroupNorm with one group per channel: statistics over time
        self.layer_norm = (nn.GroupNorm(cout, cout, eps=norm_eps)
                           if norm_eps is not None else None)

    def forward(self, x):
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    """Raw waveform (B, T) -> (B, T', conv_dim[-1])."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s,
                       cfg.layer_norm_eps if i == 0 else None)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, x):
        h = x[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.crop = k % 2 == 0

    def forward(self, x):
        h = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if self.crop:
            h = h[:, :-1]          # SamePad crop for even kernels
        return F.gelu(h)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        B, T, C = x.shape
        hd = C // self.heads

        def split(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)   # (B, h, T, hd)

        q = split(self.q_proj(x)) / math.sqrt(hd)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        w = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, T, C))


class FeedForward(nn.Module):
    def __init__(self, hidden: int, inter: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(hidden, inter)
        self.output_dense = nn.Linear(inter, hidden)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Post-norm transformer layer (do_stable_layer_norm=False)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.attention = Attention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.feed_forward = FeedForward(cfg.hidden_size, cfg.intermediate_size)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, x):
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x


class Wav2Vec2Encoder(nn.Module):
    """forward(waveform (B, T_samples), frame_num) -> (B, frame_num, hidden),
    with the reference's mid-stack 50 Hz -> 30 fps interpolation."""

    def __init__(self, cfg: Wav2Vec2Config | None = None):
        super().__init__()
        self.cfg = cfg or Wav2Vec2Config()
        self.feature_extractor = FeatureExtractor(self.cfg)
        self.feature_projection = FeatureProjection(self.cfg)
        self.encoder = Encoder(self.cfg)

    def forward(self, waveform: torch.Tensor, frame_num: int) -> torch.Tensor:
        feats = linear_interpolate(self.feature_extractor(waveform), frame_num)
        return self.encoder(self.feature_projection(feats))
