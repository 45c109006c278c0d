"""wav2vec 2.0 encoder, inference path
(port of talkshow_tpu/models/wav2vec.py:31-283).

CNN feature extractor (VALID convs, no bias, per-channel GroupNorm after
the first) -> linear interpolation 50 Hz -> 30 fps -> feature projection
-> grouped positional conv (even kernel: crop the last frame) -> encoder
LayerNorm -> post-norm transformer layers.  Parameter names follow
Hugging Face's Wav2Vec2Model, which talkshow_tpu/convert/wav2vec.py reads.
The attention is plain matmul + f32 softmax, as flax computes it.

`valid_samples` / `valid_frames` (B,) select the length-masked path for
batches padded to a length bucket: masked GroupNorm statistics, per-example
interpolation, zeroed padded frames before the positional conv and masked
attention keys keep every real frame equal to the unpadded program's.
`mid_stack` and `pre_layers` are the split points the fused face stage
(models/wav2vec_fused.py) hands over at.  SpecAugment and the frozen
extractor wait for the training slice (ROADMAP.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from talkshow_torch.models.layers import (length_mask, linear_interpolate,
                                          masked_linear_interpolate)


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


class ChannelGroupNorm(nn.Module):
    """GroupNorm with one group per channel (statistics over time) on
    (B, C, T), with optional per-example time masking (mask (B, 1, T)):
    masked sums divide by max(n_valid, 1), so padded frames change no real
    frame's normalisation.  Parameter names are nn.GroupNorm's."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, mask=None):
        if mask is None:
            mean = x.mean(-1, keepdim=True)
            var = ((x - mean) ** 2).mean(-1, keepdim=True)
        else:
            n = mask.sum(-1, keepdim=True).clamp_min(1.0)
            mean = (x * mask).sum(-1, keepdim=True) / n
            var = (((x - mean) ** 2) * mask).sum(-1, keepdim=True) / n
        h = (x - mean) * torch.rsqrt(var + self.eps)
        return h * self.weight[:, None] + self.bias[:, None]


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, norm_eps: float | None):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, s, bias=False)
        self.layer_norm = (ChannelGroupNorm(cout, norm_eps)
                           if norm_eps is not None else None)


def conv_valid_length(num_samples, cfg: Wav2Vec2Config):
    """Valid feature length after the VALID conv stack; python ints and
    integer tensors alike."""
    n = num_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n


class FeatureExtractor(nn.Module):
    """Raw waveform (B, T) -> (B, T', conv_dim[-1]).

    valid_samples (B,) masks the GroupNorm statistics: the convs are VALID,
    so feature frame j < valid length depends on real samples only."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s,
                       cfg.layer_norm_eps if i == 0 else None)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, x, valid_samples=None):
        h = x[:, None, :]
        n_valid = valid_samples
        for layer in self.conv_layers:
            h = layer.conv(h)
            k, s = layer.conv.kernel_size[0], layer.conv.stride[0]
            if n_valid is not None:
                n_valid = (n_valid - k) // s + 1
            if layer.layer_norm is not None:
                mask = (None if n_valid is None
                        else length_mask(n_valid, h.shape[-1], h.dtype).transpose(1, 2))
                h = layer.layer_norm(h, mask)
            h = F.gelu(h)
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

    def forward(self, x, key_valid=None):
        """key_valid (B, T) bool: keys that may be attended to."""
        B, T, C = x.shape
        hd = C // self.heads

        def split(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)   # (B, h, T, hd)

        q = split(self.q_proj(x)) / math.sqrt(hd)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        s = (q @ k.transpose(-1, -2)).float()
        if key_valid is not None:
            s = s.masked_fill(~key_valid[:, None, None, :], torch.finfo(s.dtype).min)
        w = torch.softmax(s, dim=-1).to(v.dtype)
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

    def forward(self, x, key_valid=None):
        x = self.layer_norm(x + self.attention(x, key_valid))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    """Positional conv, encoder LayerNorm and the layer stack (HF names);
    Wav2Vec2Encoder drives them."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))


class Wav2Vec2Encoder(nn.Module):
    """forward(waveform (B, T_samples), frame_num) -> (B, frame_num, hidden),
    with the reference's mid-stack 50 Hz -> 30 fps interpolation."""

    def __init__(self, cfg: Wav2Vec2Config | None = None):
        super().__init__()
        self.cfg = cfg or Wav2Vec2Config()
        self.feature_extractor = FeatureExtractor(self.cfg)
        self.feature_projection = FeatureProjection(self.cfg)
        self.encoder = Encoder(self.cfg)

    def _pos_and_norm(self, x):
        return self.encoder.layer_norm(x + self.encoder.pos_conv_embed(x))

    def mid_stack(self, feats: torch.Tensor, frame_num: int) -> torch.Tensor:
        """Extractor features (B, T50, C) -> pre-layer hidden states
        (interpolation, projection, positional conv, LayerNorm); unmasked."""
        return self._pos_and_norm(self.feature_projection(linear_interpolate(feats, frame_num)))

    def pre_layers(self, waveform: torch.Tensor, frame_num: int,
                   valid_samples=None, valid_frames=None) -> torch.Tensor:
        """Everything before the transformer layers (inference only)."""
        if valid_samples is None:
            return self.mid_stack(self.feature_extractor(waveform), frame_num)
        valid_samples = valid_samples.to(waveform.device)
        valid_frames = valid_frames.to(waveform.device)
        feats = self.feature_extractor(waveform, valid_samples)      # (B, T50, C)
        in_valid = conv_valid_length(valid_samples, self.cfg)
        feats = feats * length_mask(in_valid, feats.shape[1], feats.dtype)
        feats = masked_linear_interpolate(feats, frame_num, in_valid, valid_frames)
        # zero padded frames so the positional conv's reach into the pad
        # sees the zeros the unpadded program's SAME padding has
        x = self.feature_projection(feats) * length_mask(valid_frames, frame_num, feats.dtype)
        return self._pos_and_norm(x)

    def forward(self, waveform: torch.Tensor, frame_num: int,
                valid_samples=None, valid_frames=None) -> torch.Tensor:
        """valid_samples / valid_frames (B,) int tensors select the
        length-masked path (see the module docstring)."""
        x = self.pre_layers(waveform, frame_num, valid_samples, valid_frames)
        key_valid = None
        if valid_frames is not None:
            key_valid = (torch.arange(x.shape[1], device=x.device)[None]
                         < valid_frames.to(x.device)[:, None])
        for layer in self.encoder.layers:
            x = layer(x, key_valid)
        return x
