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


def leaky_relu02(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _act(x: torch.Tensor, leaky: bool) -> torch.Tensor:
    return leaky_relu02(x) if leaky else F.relu(x)


def dense(m: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """m(x); with a compute dtype, flax's `Dense(dtype=...)`: input, weight
    and bias cast to dtype, the product rounded to it, then the bias added
    (parameters stay f32).  A layer split over tp (`parallel.collectives`)
    computes through its `tp_forward`."""
    if dtype is None:
        return m(x)
    if hasattr(m, "tp_forward"):
        return m.tp_forward(x, dtype)
    y = F.linear(x.to(dtype), m.weight.to(dtype))
    return y if m.bias is None else y + m.bias.to(dtype)


def conv(m: nn.Conv1d | nn.Conv2d, x: torch.Tensor,
         dtype: torch.dtype | None = None) -> torch.Tensor:
    """m(x) on channels-first x; with a compute dtype, flax's
    `Conv(dtype=...)`, as `dense`."""
    if dtype is None:
        return m(x)
    if hasattr(m, "tp_forward"):
        return m.tp_forward(x, dtype)
    x, w = x.to(dtype), m.weight.to(dtype)
    if x.device.type == "cpu" and m.groups > 1:
        # PyTorch's CPU bf16 grouped convolution returns wrong sums at a few
        # channels a group (torch 2.13: 8 of 32, 4 of 64); the same
        # rounded operands summed in f32 and rounded once are what a bf16
        # convolution computes
        y = m._conv_forward(x.float(), w.float(), None).to(dtype)
    else:
        y = m._conv_forward(x, w, None)
    if m.bias is None:
        return y
    return y + m.bias.to(dtype).reshape((-1,) + (1,) * (y.dim() - 2))


def embed(m: nn.Embedding, idx: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Rows `idx` of the embedding table, in `dtype` (f32 by default); a
    table split over tp looks up its rows and sums over tp (`tp_lookup`)."""
    if hasattr(m, "tp_lookup"):
        return m.tp_lookup(idx).to(dtype or torch.float32)
    return m.weight.to(dtype or torch.float32)[idx]


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """`TorchBatchNorm` of talkshow_tpu/models/layers.py:24-32, i.e. flax
    `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`, under nn.BatchNorm1d's
    state-dict names.

    Train mode normalises with the batch statistics as flax computes them,
    var = max(0, E[x^2] - E[x]^2) over (B, T), and updates
    running = 0.9 * running + 0.1 * batch with that **biased** variance;
    torch's own update uses the unbiased one (n / (n - 1) larger).  Eval
    mode is nn.BatchNorm1d's.  `num_batches_tracked` is not advanced.

    On a mesh (`mesh`, set by `parallel.collectives.shard_state`) with dp >
    1 the train-mode statistics are the global batch's: the sums of x and
    x^2 over this rank's rows are summed over the dp ranks (their gradient
    too) and divided by every rank's count, so every rank updates its
    running statistics alike (none is broadcast from rank 0)."""

    MOMENTUM = 0.9
    mesh = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is None or self.mesh.dp == 1:
            mean, ex2 = x.mean(dim=(0, 2)), (x * x).mean(dim=(0, 2))
        else:
            n = x.shape[0] * x.shape[2] * self.mesh.dp
            sums = self.mesh.dp_sum(torch.cat([x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2))]))
            mean, ex2 = (sums / n).chunk(2)
        var = torch.clamp(ex2 - mean * mean, min=0.0)
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
    """Generic ConvNormRelu (nets/layers.py:25-152; JAX layers.py:124-158):
    a conv of `kernel` taps at `stride` padded (kernel - stride) // 2 on
    each side, then LayerNorm over channels (norm="ln", eps 1e-5; the face
    stage's) or BatchNorm (norm="bn", `FlaxBatchNorm1d`; the layer zoo and
    the legacy S2G family), an optional pre-activation residual (identity
    when the shape is kept, else a conv like the main one) and ReLU or
    leaky ReLU (0.2)."""

    def __init__(self, in_channels: int, out_channels: int, residual: bool = False,
                 kernel: int = 3, stride: int = 1, leaky: bool = False, norm: str = "ln"):
        super().__init__()
        if norm not in ("ln", "bn"):
            raise ValueError(f"norm must be 'ln' or 'bn', not {norm!r}")
        pad = (kernel - stride) // 2
        self.residual, self.leaky, self.bn = residual, leaky, norm == "bn"
        self.conv = nn.Conv1d(in_channels, out_channels, kernel, stride, pad)
        self.norm = (FlaxBatchNorm1d(out_channels) if self.bn
                     else nn.LayerNorm(out_channels, eps=1e-5))
        self.residual_layer = None
        if residual and (in_channels != out_channels or stride != 1):
            self.residual_layer = nn.Conv1d(in_channels, out_channels, kernel, stride, pad)

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        # frame_mask (B, T, 1): zero padded frames at conv entry, so the SAME
        # padding a real boundary frame reads is the unpadded program's zeros
        if frame_mask is not None:
            x = x * frame_mask
        xt = x.transpose(1, 2)
        if self.bn:
            out = self.norm(self.conv(xt)).transpose(1, 2)
        else:
            out = self.norm(self.conv(xt).transpose(1, 2))
        if self.residual:
            out = out + (x if self.residual_layer is None
                         else self.residual_layer(xt).transpose(1, 2))
        return _act(out, self.leaky)


class SeqTranslator1D(nn.Module):
    """Stack of CNR1d blocks (nets/layers.py:799-841); `norm` as CNR1d's
    (LayerNorm for the face stage, BatchNorm for the legacy S2G family)."""

    def __init__(self, in_channels: int, out_channels: int,
                 min_layers_num: int = 1, residual: bool = True, norm: str = "ln"):
        super().__init__()
        n = max(1, min_layers_num)
        self.conv_layers = nn.ModuleList(
            CNR1d(in_channels if i == 0 else out_channels, out_channels,
                  residual=residual, norm=norm) for i in range(n))

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        for layer in self.conv_layers:
            x = layer(x, frame_mask)
        return x


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from `generator`, in parameter-name order: xavier-uniform
    matrices and conv kernels, normal(1) embeddings, zero biases (a GRU's
    `bias_*` too), unit norm scales and WavLM gate constants.  Running statistics keep their defaults (mean 0, var 1), and
    wav2vec's `masked_spec_embed` its own init (drawn from no generator
    here, so adding it moved no other weight)."""
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if leaf == "masked_spec_embed":
            continue
        if leaf == "gru_rel_pos_const":        # WavLM's gate constant starts at 1
            p.fill_(1.0)
            continue
        if isinstance(module.get_submodule(owner), nn.Embedding):
            p.copy_(torch.randn(p.shape, generator=generator))
        elif p.dim() >= 2:
            fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(p)
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * limit)
        elif leaf.startswith("bias"):
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


# ---------------------------------------------------------------------------
# The layer zoo (JAX layers.py:209-284): BatchNorm CNR1d blocks, (B, T, C)
# ---------------------------------------------------------------------------

def _pool2(h: torch.Tensor) -> torch.Tensor:
    """flax max_pool (2,) stride 2 over time of (B, T, C): odd T floors."""
    return F.max_pool1d(h.transpose(1, 2), 2, 2).transpose(1, 2)


def conv_btc(m: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d on (B, T, C)."""
    return m(x.transpose(1, 2)).transpose(1, 2)


class UNet1D(nn.Module):
    """depth-down / depth-up conv U-Net over time (nets/layers.py:154-208
    family): leaky BatchNorm CNR1d blocks of channels * min(2^i, 8), max
    pools of 2 on the way down, on the way up a repeat of 2 (resized
    linearly to the skip's length where a pool floored an odd one), the
    skip concatenated, then a 1x1 conv to out_channels."""

    def __init__(self, in_channels: int, channels: int, out_channels: int, depth: int = 4):
        super().__init__()
        width = [channels * min(2 ** i, 8) for i in range(depth + 1)]
        self.down = nn.ModuleList(
            CNR1d(in_channels if i == 0 else width[i - 1], width[i], leaky=True, norm="bn")
            for i in range(depth))
        self.bottleneck = CNR1d(width[depth - 1], width[depth], leaky=True, norm="bn")
        self.up = nn.ModuleList(
            CNR1d(width[i + 1] + width[i], width[i], leaky=True, norm="bn")
            for i in range(depth))
        self.out = nn.Conv1d(width[0], out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips, h = [], x
        for layer in self.down:
            h = layer(h)
            skips.append(h)
            h = _pool2(h)
        h = self.bottleneck(h)
        for i in reversed(range(len(self.up))):
            h = h.repeat_interleave(2, dim=1)
            if h.shape[1] != skips[i].shape[1]:
                h = linear_interpolate(h, skips[i].shape[1])
            h = self.up[i](torch.cat([h, skips[i]], dim=-1))
        return conv_btc(self.out, h)


class SeqEncoder1D(nn.Module):
    """Sequence (B, T, C) -> one latent vector (B, out_dim): num_layers
    leaky BatchNorm CNR1d blocks each followed by a max pool of 2, the mean
    over time, a Linear (nets/layers.py:454-510 family)."""

    def __init__(self, in_channels: int, hidden: int, out_dim: int, num_layers: int = 4):
        super().__init__()
        self.convs = nn.ModuleList(
            CNR1d(in_channels if i == 0 else hidden, hidden, leaky=True, norm="bn")
            for i in range(num_layers))
        self.out = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.convs:
            h = _pool2(layer(h))
        return self.out(h.mean(dim=1))


class SeqDecoder1D(nn.Module):
    """Latent (B, in_dim) -> sequence (B, length, out_channels): a Linear
    named `in`, broadcast over time, num_layers residual leaky BatchNorm
    CNR1d blocks, a 1x1 conv (nets/layers.py SeqDecoder1D family)."""

    def __init__(self, in_dim: int, hidden: int, out_channels: int, length: int,
                 num_layers: int = 4):
        super().__init__()
        self.length = length
        self.add_module("in", nn.Linear(in_dim, hidden))
        self.convs = nn.ModuleList(CNR1d(hidden, hidden, residual=True, leaky=True, norm="bn")
                                   for _ in range(num_layers))
        self.out = nn.Conv1d(hidden, out_channels, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = getattr(self, "in")(z)
        h = h[:, None, :].expand(z.shape[0], self.length, h.shape[-1])
        for layer in self.convs:
            h = layer(h)
        return conv_btc(self.out, h)


class SeqTranslatorRNN(nn.Module):
    """GRU sequence translator (nets/layers.py SeqTranslatorRNN family): a
    leaky BatchNorm CNR1d front end, a one-layer unidirectional GRU from a
    zero state, a Linear head.

    flax's GRUCell has biases on the input projections of r, z and n and a
    hidden bias on n only; nn.GRU has both on all three, so `b_hh`'s r and
    z thirds stay zero (frozen by a gradient hook) and the converter writes
    only its n third."""

    def __init__(self, in_channels: int, hidden: int, out_channels: int):
        super().__init__()
        self.front = CNR1d(in_channels, hidden, leaky=True, norm="bn")
        self.gru = nn.GRU(hidden, hidden, batch_first=True)
        with torch.no_grad():
            self.gru.bias_hh_l0[: 2 * hidden].zero_()
        rz = torch.zeros(3 * hidden, dtype=torch.bool)
        rz[: 2 * hidden] = True
        self.gru.bias_hh_l0.register_hook(lambda g: g.masked_fill(rz.to(g.device), 0.0))
        self.out = nn.Linear(hidden, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.gru(self.front(x))[0])
