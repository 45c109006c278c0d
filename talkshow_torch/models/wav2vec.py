"""wav2vec 2.0 encoder, inference path
(port of talkshow_tpu/models/wav2vec.py:31-283).

CNN feature extractor (VALID convs, no bias, per-channel GroupNorm after
the first) -> linear interpolation 50 Hz -> 30 fps -> feature projection
-> grouped positional conv (even kernel: crop the last frame) -> encoder
LayerNorm -> post-norm transformer layers.  Parameter names follow
Hugging Face's Wav2Vec2Model, which talkshow_tpu/convert/wav2vec.py reads.
The attention is plain matmul + f32 softmax, as flax computes it.

`Wav2Vec2Config.dtype` (None = f32; bf16 for `--bf16` training) is flax's
compute dtype at the sites where the JAX module passes it
(talkshow_tpu/models/wav2vec.py:47,65-81,110,130,143,160,165,168): the
extractor convs (GroupNorm statistics in f32, its output cast back), the
feature projection, the positional conv, attention (q, k, v and the
output projection; softmax in f32, `force_fp32_for_softmax`, whose f32
weights promote the context to f32) and the FFN Dense layers.  Parameters
stay f32.  The LayerNorms have no dtype in JAX, so flax promotes a bf16
input with its f32 scale to an f32 output: here they take the input as f32.
The unmasked 50 -> 30 fps interpolation runs in the compute dtype (JAX's
grid is weakly typed), the masked one in f32 (JAX's is f32).

WavLM (`microsoft/wavlm-large`; Chen et al., arXiv:2110.13900) is the
same encoder in Hugging Face's stable order, set by five config keys
(`do_stable_layer_norm`, `feat_extract_norm`, `conv_bias`, `num_buckets`,
`max_bucket_distance`; the defaults are wav2vec 2.0 base's, whose
arithmetic they leave as it was):

- ``feat_extract_norm="layer"``: every conv is followed by a LayerNorm over
  its channels (per frame, so padded frames change no real one), then
  gelu; ``conv_bias`` must stay false (WavLM Large's and base's convs have
  no bias, and no configuration here gives them one);
- ``do_stable_layer_norm``: pre-norm layers, ``x + Attn(LN1(x))`` then
  ``x + FFN(LN2(x))``; the stack starts at ``x + posconv(x)`` and ends with
  the encoder's LayerNorm (post-norm base applies it before the layers);
- ``num_buckets`` > 0: T5's bidirectional relative-position buckets
  (`relative_buckets`), layer 0's table `rel_attn_embed` (buckets, heads)
  looked up once as ``bias[h, i, j] = E[bucket(j - i), h]`` and shared down
  the stack, and each layer's gate ``g[h, i] = a (b c_h - 1) + 2`` from
  (a, b) = sigmoid of the 8 outputs of ``gru_rel_pos_linear`` (64 -> 8,
  shared by the heads) on the head's slice of LN1's output, summed in two
  groups of 4, ``c`` = ``gru_rel_pos_const``; the scores are
  ``q k^T / sqrt(hd) + g[h, i] bias[h, i, j]``.  Hugging Face's names.

`valid_samples` / `valid_frames` (B,) select the length-masked path for
batches padded to a length bucket: masked GroupNorm statistics, per-example
interpolation, zeroed padded frames before the positional conv and masked
attention keys keep every real frame equal to the unpadded program's.
`mid_stack` and `pre_layers` are the split points the fused face stage
(models/wav2vec_fused.py) hands over at.

Training (the face step, train/steps.py) hands `pre_layers` / `forward`
the frozen extractor's features (`feats`, computed under no_grad, so the
extractor's backward never runs, as JAX's `freeze_extractor` stops the
gradient at its output) and, in stochastic mode, `spec_starts`: the
SpecAugment spans (JAX :192-211), whose frames are replaced by the learned
`masked_spec_embed` after the projection and before the padded frames are
zeroed.  `draw_spec_starts` draws them from a generator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from talkshow_torch.models.layers import (conv, dense, length_mask, linear_interpolate,
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
    #: pre-norm layers and a final LayerNorm (WavLM, wav2vec 2.0 large)
    do_stable_layer_norm: bool = False
    #: "group": a per-channel GroupNorm after conv 0 only; "layer": a
    #: LayerNorm over channels after every conv
    feat_extract_norm: str = "group"
    conv_bias: bool = False
    #: relative-position buckets (0: no relative bias) and the distance
    #: from which every bucket is the last
    num_buckets: int = 0
    max_bucket_distance: int = 0
    #: compute dtype of the conv / matmul sites (None = float32)
    dtype: torch.dtype | None = None


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
        """Statistics in f32 (the input's dtype comes back)."""
        dtype_in = x.dtype
        x = x.float()
        if mask is None:
            mean = x.mean(-1, keepdim=True)
            var = ((x - mean) ** 2).mean(-1, keepdim=True)
        else:
            n = mask.sum(-1, keepdim=True).clamp_min(1.0)
            mean = (x * mask).sum(-1, keepdim=True) / n
            var = (((x - mean) ** 2) * mask).sum(-1, keepdim=True) / n
        h = (x - mean) * torch.rsqrt(var + self.eps)
        return (h * self.weight[:, None] + self.bias[:, None]).to(dtype_in)


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, norm_eps: float | None,
                 norm: str = "group"):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, s, bias=False)
        self.layer_norm = None
        if norm_eps is not None:
            self.layer_norm = (nn.LayerNorm(cout, eps=norm_eps) if norm == "layer"
                               else ChannelGroupNorm(cout, norm_eps))


#: SpecAugment's time masking (talkshow_tpu/models/wav2vec.py:190-191)
MASK_TIME_PROB, MASK_TIME_LENGTH = 0.05, 10


def spec_mask_count(frames: int) -> int:
    """Spans a clip of `frames` frames gets: max(int(0.05 T / 10), 2)."""
    return max(int(MASK_TIME_PROB * frames / MASK_TIME_LENGTH), 2)


def draw_spec_starts(batch: int, frames: int, generator: torch.Generator,
                     device) -> torch.Tensor:
    """(batch, spec_mask_count(frames)) span starts, uniform on
    [0, max(frames - 10, 1)), drawn on the generator's device."""
    return torch.randint(0, max(frames - MASK_TIME_LENGTH, 1),
                         (batch, spec_mask_count(frames)), generator=generator,
                         device=generator.device).to(device)


def spec_augment(x: torch.Tensor, starts: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Frames of (B, T, C) x inside any span [start, start + 10) of its
    example's starts (B, num_masks) become `embed` (C,)."""
    pos = torch.arange(x.shape[1], device=x.device)[None, None, :]
    s = starts.to(x.device)[..., None]
    mask = ((pos >= s) & (pos < s + MASK_TIME_LENGTH)).any(dim=1)       # (B, T)
    return torch.where(mask[..., None], embed, x)     # f32 embed: promotes, as jnp.where


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
    so feature frame j < valid length depends on real samples only.  The
    "layer" norm is per frame and needs no mask."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        if cfg.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm must be 'group' or 'layer', "
                             f"not {cfg.feat_extract_norm!r}")
        if cfg.conv_bias:
            raise ValueError("conv_bias: the extractor's convs have no bias here")
        self.dtype = cfg.dtype
        self.layer_norm_all = cfg.feat_extract_norm == "layer"
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s,
                       cfg.layer_norm_eps if i == 0 or self.layer_norm_all else None,
                       cfg.feat_extract_norm)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, x, valid_samples=None):
        h = x[:, None, :]
        n_valid = valid_samples
        for layer in self.conv_layers:
            h = conv(layer.conv, h, self.dtype)
            k, s = layer.conv.kernel_size[0], layer.conv.stride[0]
            if n_valid is not None:
                n_valid = (n_valid - k) // s + 1
            if self.layer_norm_all:
                h = layer.layer_norm(h.transpose(1, 2).float()).transpose(1, 2).to(h.dtype)
            elif layer.layer_norm is not None:
                mask = (None if n_valid is None
                        else length_mask(n_valid, h.shape[-1], h.dtype).transpose(1, 2))
                h = layer.layer_norm(h, mask)
            h = F.gelu(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.dtype = cfg.dtype
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return dense(self.projection, self.layer_norm(x.float()), self.dtype)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.dtype = cfg.dtype
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.crop = k % 2 == 0

    def forward(self, x):
        h = conv(self.conv, x.transpose(1, 2), self.dtype).transpose(1, 2)
        if self.crop:
            h = h[:, :-1]          # SamePad crop for even kernels
        return F.gelu(h)


def relative_buckets(T: int, num_buckets: int = 320, max_distance: int = 800,
                     device=None) -> torch.Tensor:
    """(T, T) int64 bucket of the distance j - i (Hugging Face's
    `WavLMAttention._relative_positions_bucket`): half the buckets a side,
    the upper half for j > i; |d| below a quarter of the buckets maps to
    itself, beyond that to quarter + floor(ln(|d| / quarter) /
    ln(max_distance / quarter) * quarter) in float32, capped at half - 1."""
    pos = torch.arange(T, dtype=torch.long, device=device)
    return bucket_of(pos[None, :] - pos[:, None], num_buckets, max_distance)


def bucket_of(d: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """The bucket of each signed distance in `d` (int64), as `relative_buckets`."""
    half = num_buckets // 2
    exact = half // 2
    a = d.abs()
    large = torch.log(a.float() / exact) / math.log(max_distance / exact) * (half - exact)
    large = torch.clamp_max((exact + large).to(torch.long), half - 1)
    return (d > 0).to(torch.long) * half + torch.where(a < exact, a, large)


class Attention(nn.Module):
    """Self-attention; with `gated` (WavLM) the layer's gate of the shared
    relative-position bias, and with `buckets` > 0 (layer 0) its table."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype | None = None,
                 gated: bool = False, buckets: int = 0):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)
        if gated:
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))
            self.gru_rel_pos_linear = nn.Linear(hidden // heads, 8)
        if buckets:
            self.rel_attn_embed = nn.Embedding(buckets, heads)

    def gate(self, x: torch.Tensor) -> torch.Tensor:
        """The gate (B, heads, T) of the position bias from the layer's
        normalised input x (B, T, hidden), in f32."""
        B, T, C = x.shape
        proj = self.gru_rel_pos_linear(x.float().reshape(B, T, self.heads, C // self.heads))
        a, b = torch.sigmoid(proj.reshape(B, T, self.heads, 2, 4).sum(-1)).unbind(-1)
        g = a * (b * self.gru_rel_pos_const.reshape(self.heads) - 1.0) + 2.0
        return g.transpose(1, 2)

    def forward(self, x, key_valid=None, position_bias=None):
        """key_valid (B, T) bool: keys that may be attended to;
        position_bias (heads, T, T): the shared relative bias, gated here."""
        B, T, C = x.shape
        hd = C // self.heads

        def split(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)   # (B, h, T, hd)

        dt = self.dtype
        q = split(dense(self.q_proj, x, dt))
        # flax divides by sqrt(depth) in the compute dtype
        q = q / (math.sqrt(hd) if dt is None else torch.tensor(math.sqrt(hd), dtype=dt))
        k, v = split(dense(self.k_proj, x, dt)), split(dense(self.v_proj, x, dt))
        s = (q @ k.transpose(-1, -2)).float()
        if position_bias is not None:
            s = s + self.gate(x)[..., None] * position_bias
        if key_valid is not None:
            s = s.masked_fill(~key_valid[:, None, None, :], torch.finfo(s.dtype).min)
        w = torch.softmax(s, dim=-1)
        ctx = (w @ v.to(w.dtype)).transpose(1, 2).reshape(B, T, C)
        return dense(self.out_proj, ctx, dt)


class FeedForward(nn.Module):
    def __init__(self, hidden: int, inter: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.intermediate_dense = nn.Linear(hidden, inter)
        self.output_dense = nn.Linear(inter, hidden)

    def forward(self, x):
        h = F.gelu(dense(self.intermediate_dense, x, self.dtype))
        return dense(self.output_dense, h, self.dtype)


class EncoderLayer(nn.Module):
    """Post-norm transformer layer (do_stable_layer_norm=False), or pre-norm
    (True: WavLM's stable order)."""

    def __init__(self, cfg: Wav2Vec2Config, index: int = 0):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.stable = cfg.do_stable_layer_norm
        self.attention = Attention(cfg.hidden_size, cfg.num_heads, cfg.dtype,
                                   gated=cfg.num_buckets > 0,
                                   buckets=cfg.num_buckets if index == 0 else 0)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.feed_forward = FeedForward(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)

    def forward(self, x, key_valid=None, position_bias=None):
        if self.stable:
            x = x + self.attention(self.layer_norm(x.float()), key_valid, position_bias)
            return x + self.feed_forward(self.final_layer_norm(x.float()))
        x = self.layer_norm(x + self.attention(x, key_valid))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    """Positional conv, encoder LayerNorm and the layer stack (HF names);
    Wav2Vec2Encoder drives them."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg, i) for i in range(cfg.num_layers))


class Wav2Vec2Encoder(nn.Module):
    """forward(waveform (B, T_samples), frame_num) -> (B, frame_num, hidden),
    with the reference's mid-stack 50 Hz -> 30 fps interpolation.

    `masked_spec_embed` (hidden,) is the learned SpecAugment vector (HF's
    name); inference never reads it.  It starts uniform on [0, 1), as
    flax's `uniform(scale=1.0)`, from a fixed seed (init_weights_ leaves it
    be, so the other weights draw what they drew before it existed)."""

    def __init__(self, cfg: Wav2Vec2Config | None = None):
        super().__init__()
        self.cfg = cfg or Wav2Vec2Config()
        self.feature_extractor = FeatureExtractor(self.cfg)
        self.feature_projection = FeatureProjection(self.cfg)
        self.encoder = Encoder(self.cfg)
        self.masked_spec_embed = nn.Parameter(
            torch.rand(self.cfg.hidden_size, generator=torch.Generator().manual_seed(0)))

    def _pos_and_norm(self, x):
        """x + posconv(x), then the encoder's LayerNorm (post-norm) or not
        (the stable order applies it after the layers: `final_norm`)."""
        if self.cfg.do_stable_layer_norm:
            return (x + self.encoder.pos_conv_embed(x)).float()
        return self.encoder.layer_norm((x + self.encoder.pos_conv_embed(x)).float())

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        """The end of the layer stack: the encoder's LayerNorm in the stable
        order, nothing in the post-norm one."""
        return self.encoder.layer_norm(x.float()) if self.cfg.do_stable_layer_norm else x

    def position_bias(self, T: int, device) -> torch.Tensor | None:
        """Layer 0's relative-position bias (heads, T, T), shared by every
        layer; None without buckets."""
        if not self.cfg.num_buckets:
            return None
        table = self.encoder.layers[0].attention.rel_attn_embed.weight
        buckets = relative_buckets(T, self.cfg.num_buckets, self.cfg.max_bucket_distance,
                                   device)
        return table.float()[buckets].permute(2, 0, 1)

    def mid_stack(self, feats: torch.Tensor, frame_num: int) -> torch.Tensor:
        """Extractor features (B, T50, C) -> pre-layer hidden states
        (interpolation, projection, positional conv, LayerNorm in the
        post-norm order); unmasked."""
        feats = linear_interpolate(feats.to(self.cfg.dtype or torch.float32), frame_num)
        return self._pos_and_norm(self.feature_projection(feats))

    def pre_layers(self, waveform: torch.Tensor | None, frame_num: int,
                   valid_samples=None, valid_frames=None, *,
                   feats: torch.Tensor | None = None,
                   spec_starts: torch.Tensor | None = None) -> torch.Tensor:
        """Everything before the transformer layers.  `feats`: the
        extractor's output, computed by the caller (the waveform is then
        not read); `spec_starts` (B, num_masks): SpecAugment's spans."""
        masked = valid_samples is not None
        if feats is None:
            feats = self.feature_extractor(
                waveform, valid_samples.to(waveform.device) if masked else None)
        if masked:
            dev = feats.device
            valid_samples, valid_frames = valid_samples.to(dev), valid_frames.to(dev)
            in_valid = conv_valid_length(valid_samples, self.cfg)
            feats = feats * length_mask(in_valid, feats.shape[1], feats.dtype)
            # JAX's masked grid is f32 (talkshow_tpu/models/layers.py:217)
            feats = masked_linear_interpolate(feats.float(), frame_num, in_valid, valid_frames)
        else:
            # in the compute dtype: JAX's grid is weakly typed, so bf16
            # features interpolate in bf16
            feats = linear_interpolate(feats.to(self.cfg.dtype or torch.float32), frame_num)
        x = self.feature_projection(feats)
        if spec_starts is not None:
            x = spec_augment(x, spec_starts, self.masked_spec_embed)
        if masked:
            # zero padded frames so the positional conv's reach into the pad
            # sees the zeros the unpadded program's SAME padding has
            x = x * length_mask(valid_frames, frame_num, feats.dtype)
        return self._pos_and_norm(x)

    def forward(self, waveform: torch.Tensor | None, frame_num: int,
                valid_samples=None, valid_frames=None, *,
                feats: torch.Tensor | None = None,
                spec_starts: torch.Tensor | None = None) -> torch.Tensor:
        """valid_samples / valid_frames (B,) int tensors select the
        length-masked path (see the module docstring); `feats` and
        `spec_starts` as in `pre_layers`."""
        x = self.pre_layers(waveform, frame_num, valid_samples, valid_frames, feats=feats,
                            spec_starts=spec_starts)
        key_valid = None
        if valid_frames is not None:
            key_valid = (torch.arange(x.shape[1], device=x.device)[None]
                         < valid_frames.to(x.device)[:, None])
        bias = self.position_bias(x.shape[1], x.device)
        for layer in self.encoder.layers:
            x = layer(x, key_valid) if bias is None else layer(x, key_valid, bias)
        return self.final_norm(x)
