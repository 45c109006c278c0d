"""Shared conv building blocks (port of talkshow_tpu/models/layers.py:20-206).

Public layout is the JAX package's (B, T, C); each block transposes to
Conv1d's (B, C, T) inside.  Submodule names follow the reference torch
modules (`conv`, `norm`, `residual_layer`, `_layers`), the names that
talkshow_tpu/convert/talkshow.py reads.  BatchNorm (eps 1e-5) runs from its
running statistics in eval mode and from batch statistics in train mode,
updating the running ones the flax way (`FlaxBatchNorm1d`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _act(x: torch.Tensor, leaky: bool) -> torch.Tensor:
    return F.leaky_relu(x, 0.2) if leaky else F.relu(x)


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """`TorchBatchNorm` of talkshow_tpu/models/layers.py:24-32, i.e. flax
    `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`, under nn.BatchNorm1d's
    state-dict names.

    Train mode normalises with the batch statistics as flax computes them,
    var = max(0, E[x^2] - E[x]^2) over (B, T), and updates
    running = 0.9 * running + 0.1 * batch with that **biased** variance;
    torch's own update uses the unbiased one (n / (n - 1) larger).  Eval
    mode is nn.BatchNorm1d's.  `num_batches_tracked` is not advanced."""

    MOMENTUM = 0.9

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2))
        var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


_SAMPLE = {  # sample mode -> (kernel, stride, padding)
    "none": (3, 1, 1),
    "one": (1, 1, 0),
    "down": (4, 2, 1),
    "up": (4, 2, 1),    # ConvTranspose1d(k4, s2, p1): T -> 2T
}


class ConvNormRelu(nn.Module):
    """conv-BN-(+residual)-relu; vqvae_modules.py:87-172.

    sample: 'none' k3 s1 p1 | 'one' k1 | 'down' k4 s2 p1 |
            'up' ConvTranspose1d k4 s2 p1."""

    def __init__(self, in_channels: int, out_channels: int, leaky: bool = False,
                 sample: str = "none", residual: bool = False):
        super().__init__()
        if sample not in _SAMPLE:
            raise ValueError(sample)
        k, s, p = _SAMPLE[sample]
        conv = nn.ConvTranspose1d if sample == "up" else nn.Conv1d
        self.leaky = leaky
        self.conv = conv(in_channels, out_channels, k, s, p)
        self.norm = FlaxBatchNorm1d(out_channels)
        self.residual_layer = None
        self.residual = residual
        if residual and (sample in ("up", "down") or in_channels != out_channels):
            self.residual_layer = conv(in_channels, out_channels, k, s, p)

    def forward_nct(self, x: torch.Tensor) -> torch.Tensor:
        out = self.norm(self.conv(x))
        if self.residual:
            out = out + (x if self.residual_layer is None
                         else self.residual_layer(x))
        return _act(out, self.leaky)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_nct(x.transpose(1, 2)).transpose(1, 2)


class ResCNRStack(nn.Module):
    """N ConvNormRelu + conv-BN with a whole-stack residual
    (vqvae_modules.py:175-212)."""

    def __init__(self, channels: int, layers: int, leaky: bool = False):
        super().__init__()
        self._layers = nn.ModuleList(
            ConvNormRelu(channels, channels, leaky=leaky) for _ in range(layers))
        self.conv = nn.Conv1d(channels, channels, 3, 1, 1)
        self.norm = FlaxBatchNorm1d(channels)

    def forward_nct(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self._layers:
            h = layer.forward_nct(h)
        return F.relu(self.norm(self.conv(h)) + x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_nct(x.transpose(1, 2)).transpose(1, 2)


class CNR1d(nn.Module):
    """Generic ConvNormRelu (nets/layers.py:25-152) as the face stage uses
    it: k3 s1 SAME conv, LayerNorm over channels (eps 1e-5), ReLU, optional
    pre-activation residual (identity or projected)."""

    def __init__(self, in_channels: int, out_channels: int, residual: bool = False):
        super().__init__()
        self.residual = residual
        self.conv = nn.Conv1d(in_channels, out_channels, 3, 1, 1)
        self.norm = nn.LayerNorm(out_channels, eps=1e-5)
        self.residual_layer = None
        if residual and in_channels != out_channels:
            self.residual_layer = nn.Conv1d(in_channels, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        # frame_mask (B, T, 1): zero padded frames at conv entry, so the SAME
        # padding a real boundary frame reads is the unpadded program's zeros
        if frame_mask is not None:
            x = x * frame_mask
        xt = x.transpose(1, 2)
        out = self.norm(self.conv(xt).transpose(1, 2))
        if self.residual:
            out = out + (x if self.residual_layer is None
                         else self.residual_layer(xt).transpose(1, 2))
        return F.relu(out)


class SeqTranslator1D(nn.Module):
    """Stack of CNR1d blocks (nets/layers.py:799-841), LayerNorm mode."""

    def __init__(self, in_channels: int, out_channels: int,
                 min_layers_num: int = 1, residual: bool = True):
        super().__init__()
        n = max(1, min_layers_num)
        self.conv_layers = nn.ModuleList(
            CNR1d(in_channels if i == 0 else out_channels, out_channels,
                  residual=residual) for i in range(n))

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        for layer in self.conv_layers:
            x = layer(x, frame_mask)
        return x


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from `generator`, in parameter-name order: xavier-uniform
    matrices and conv kernels, normal(1) embeddings, zero biases, unit norm
    scales.  Running statistics keep their defaults (mean 0, var 1), and
    wav2vec's `masked_spec_embed` its own init (drawn from no generator
    here, so adding it moved no other weight)."""
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if leaf == "masked_spec_embed":
            continue
        if isinstance(module.get_submodule(owner), nn.Embedding):
            p.copy_(torch.randn(p.shape, generator=generator))
        elif p.dim() >= 2:
            fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(p)
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * limit)
        elif leaf == "bias":
            p.zero_()
        else:
            p.fill_(1.0)
    return module


def linear_interpolate(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) on axis 1 of
    (B, T, C), written with the same index arithmetic as the JAX twin."""
    in_len = x.shape[1]
    if in_len == out_len:
        return x
    scale = in_len / out_len
    pos = (torch.arange(out_len, device=x.device, dtype=torch.float32) + 0.5) * scale - 0.5
    pos = pos.clamp(0.0, in_len - 1)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=in_len - 1)
    w = (pos - lo)[None, :, None].to(x.dtype)
    return x[:, lo, :] * (1 - w) + x[:, hi, :] * w


def masked_linear_interpolate(x: torch.Tensor, out_len: int, in_valid: torch.Tensor,
                              out_valid: torch.Tensor) -> torch.Tensor:
    """`linear_interpolate` with per-example valid lengths (B,): the first
    out_valid[b] output frames equal linear_interpolate(x[b, :in_valid[b]],
    out_valid[b]), so padding a batch to a length bucket leaves real frames
    unchanged.  The grid uses each example's true ratio and clamps at
    in_valid - 1; a gather does the sampling."""
    in_len = x.shape[1]
    in_v = in_valid.to(device=x.device, dtype=torch.float32)[:, None]    # (B, 1)
    out_v = out_valid.to(device=x.device, dtype=torch.float32)[:, None]
    pos = (torch.arange(out_len, device=x.device, dtype=torch.float32)[None] + 0.5) \
        * (in_v / out_v) - 0.5
    pos = torch.minimum(pos.clamp_min(0.0), in_v - 1)
    lo = pos.floor().long()
    hi = torch.minimum(lo + 1, in_v.long() - 1).clamp_max(in_len - 1)
    w = (pos - lo)[..., None].to(x.dtype)

    def take(idx):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))

    return take(lo) * (1 - w) + take(hi) * w


def length_mask(valid: torch.Tensor, length: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) valid lengths -> (B, length, 1) mask, 1 on frames < valid[b]."""
    pos = torch.arange(length, device=valid.device)
    return (pos[None, :, None] < valid[:, None, None]).to(dtype)
