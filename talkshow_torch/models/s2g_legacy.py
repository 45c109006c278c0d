"""Legacy freeform S2G generator family (port of
talkshow_tpu/models/s2g_legacy.py; the reference's nets/spg/s2glayers.py).

The pre-VQ body generator the reference keeps beside TalkSHOW: a template
VAE over the ground-truth poses, two audio encoders (a VAE over audio
features fused with the template, and a plain conv + UNet feature
extractor) and one conv decoder per output part (:303-494), with its patch
discriminator (:497-512).  No CLI reaches it; it runs in PyTorch only, no
kernel.  Layout (B, T, C); BatchNorm blocks are `layers.CNR1d(norm="bn")`.

Randomness: the JAX package draws the template and VAE noise with
`jax.random` and the dropout masks from flax's 'dropout' stream.  Here a
forward takes `noise`: a torch.Generator to draw them from, or a dict of
the draws themselves (how the tests hand in JAX's):
  "template"   (B, T, template_length): the template's eps (train mode
               with poses) or the template itself (otherwise);
  "audio_eps"  (B, T, 128): the audio VAE's eps (train mode);
  "drop_audio", "drop_speech" (B, T, 256) bool: the two encoders' dropout
               keep masks (train mode; rate 0.1, kept values / 0.9).
With no noise, eval mode uses a zero template and the VAE means, as JAX
does without a key; train mode raises where it needs a draw.

TF-"SAME" padding (the discriminator's outer convs) pads the extra tap on
the right, as `same_pad` computes; PyTorch's padding="same" refuses
stride > 1.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from talkshow_torch.models.layers import (CNR1d, SeqTranslator1D, conv_btc, leaky_relu02,
                                          linear_interpolate)

#: train-mode dropout rate after each audio encoder's first_net (JAX :52)
S2G_DROPOUT = 0.1


def same_pad(length: int, kernel: int, stride: int) -> tuple[int, int]:
    """(left, right) padding of TF / flax "SAME": ceil(T / stride) outputs,
    the odd tap on the right."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def _conv_same(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A "SAME" conv of (B, T, C)."""
    pad = same_pad(x.shape[1], conv.kernel_size[0], conv.stride[0])
    return conv(F.pad(x.transpose(1, 2), pad)).transpose(1, 2)


def _draw(noise, key: str, shape, device, kind: str = "normal"):
    """The draw `key` from a dict, or a fresh one from a torch.Generator;
    None without noise."""
    if noise is None:
        return None
    if isinstance(noise, dict):
        t = noise.get(key)
        return None if t is None else t.to(device)
    if kind == "normal":
        return torch.randn(shape, generator=noise, device=noise.device).to(device)
    u = torch.rand(shape, generator=noise, device=noise.device)
    return (u < 1.0 - S2G_DROPOUT).to(device)


def _dropout(x: torch.Tensor, keep) -> torch.Tensor:
    if keep is None:
        raise ValueError("a train-mode S2G forward needs its dropout masks: pass noise= "
                         "(a torch.Generator or the drawn masks)")
    return torch.where(keep, x / (1.0 - S2G_DROPOUT), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))


class S2GUNet(nn.Module):
    """5-down / 5-up additive-skip UNet over time (s2glayers.py:169-212):
    downs are stride-2 CNRs (k4, padding 1), ups resize linearly to the
    skip's length, add it and conv.  Returns (out, the third block's
    output)."""

    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.down1_0 = CNR1d(in_channels, in_channels, norm="bn")
        self.down1_1 = CNR1d(in_channels, dim, norm="bn")
        self.down1_2 = CNR1d(dim, dim, norm="bn")
        for i in range(5):
            self.add_module(f"down{i + 2}", CNR1d(dim, dim, kernel=4, stride=2, norm="bn"))
        for i in range(5):
            self.add_module(f"up{i + 1}", CNR1d(dim, dim, norm="bn"))

    def forward(self, x: torch.Tensor):
        x2 = self.down1_2(self.down1_1(self.down1_0(x)))
        skips, h = [x2], x2
        for i in range(5):
            h = getattr(self, f"down{i + 2}")(h)
            skips.append(h)
        for i in range(5):
            target = skips[-2 - i]
            h = getattr(self, f"up{i + 1}")(linear_interpolate(h, target.shape[1]) + target)
        return h, x2


class S2GAudioEncoder(nn.Module):
    """Dual-mode audio encoder (s2glayers.py:215-300): pose=True is a VAE
    over the audio features (128 wide) fused with the template into a
    UNet of common_dim; pose=False a conv stack + a 256-wide UNet.
    forward -> (features, (mu, log_var) or (None, None), UNet skip x2)."""

    def __init__(self, in_channels: int, pose: bool, template_length: int = 0,
                 common_dim: int = 256):
        super().__init__()
        self.pose = pose
        self.first_net = SeqTranslator1D(in_channels, 256, min_layers_num=4, residual=True,
                                         norm="bn")
        if pose:
            self.mu_fc = nn.Conv1d(256, 128, 1)
            self.var_fc = nn.Conv1d(256, 128, 1)
            self.unet = S2GUNet(128 + template_length, common_dim)
        else:
            self.unet = S2GUNet(256, 256)

    def forward(self, spec, template=None, eps=None, drop_keep=None):
        """eps (B, T, 128): the VAE's noise in train mode (None: the mean,
        as JAX without a key); drop_keep: the dropout's keep mask (train
        mode)."""
        h = self.first_net(spec)
        if self.training:
            h = _dropout(h, drop_keep)
        if not self.pose:
            x1, x2 = self.unet(h)
            return x1, (None, None), x2
        mu, log_var = conv_btc(self.mu_fc, h), conv_btc(self.var_fc, h)
        audio = eps * torch.exp(0.5 * log_var) + mu if self.training and eps is not None else mu
        x1, x2 = self.unet(torch.cat([audio, template], dim=-1))
        return x1, (mu, log_var), x2


class FreeformS2G(nn.Module):
    """Template-VAE S2G generator (s2glayers.py:303-494, separate=True).

    Train mode with gt_poses: the template is drawn from a posterior over
    the poses (pose_encoder -> mu / var); otherwise the template is N(0, I)
    noise (zeros without noise).  The jaw and expression branches (0, 3)
    read the speech encoder, body and hands the audio + template encoder.
    forward -> (out (B, T, sum(each_dim)), template, mu, log_var)."""

    def __init__(self, in_channels: int, pose_dim: int, each_dim: tuple,
                 template_length: int = 64, common_dim: int = 256, expression: bool = True):
        super().__init__()
        self.template_length = template_length
        self.pose_encoder = SeqTranslator1D(pose_dim - 50, common_dim, min_layers_num=3,
                                            residual=True, norm="bn")
        self.mu_fc = nn.Conv1d(common_dim, template_length, 1)
        self.var_fc = nn.Conv1d(common_dim, template_length, 1)
        self.audio_encoder = S2GAudioEncoder(in_channels, True, template_length, common_dim)
        self.speech_encoder = S2GAudioEncoder(in_channels, False)
        self.n_branches = 4 if expression else 3
        for b in range(self.n_branches):
            width = 64 if b == 0 else common_dim
            src = 256 if b in (0, 3) else common_dim
            for i in range(3):
                self.add_module(f"dec{b}_{i}", CNR1d(src if i == 0 else width, width, norm="bn"))
            self.add_module(f"out{b}", nn.Conv1d(width, each_dim[b], 1))

    def forward(self, spec, gt_poses=None, *, noise=None):
        B, T, dev = spec.shape[0], spec.shape[1], spec.device
        tl = (B, T, self.template_length)
        if self.training and gt_poses is not None:
            enc = self.pose_encoder(gt_poses[..., :-50])
            mu, log_var = conv_btc(self.mu_fc, enc), conv_btc(self.var_fc, enc)
            eps = _draw(noise, "template", tl, dev)
            if eps is None:
                raise ValueError("a train-mode FreeformS2G forward with poses draws its "
                                 "template: pass noise=")
            template = eps * torch.exp(0.5 * log_var) + mu
        else:
            mu = log_var = None
            template = _draw(noise, "template", tl, dev)
            if template is None:
                template = spec.new_zeros(tl)
        a_t_f, _, _ = self.audio_encoder(
            spec, template, _draw(noise, "audio_eps", (B, T, 128), dev),
            _draw(noise, "drop_audio", (B, T, 256), dev, "keep") if self.training else None)
        s_f, _, _ = self.speech_encoder(
            spec, None, None,
            _draw(noise, "drop_speech", (B, T, 256), dev, "keep") if self.training else None)
        outs = []
        for b in range(self.n_branches):
            h = s_f if b in (0, 3) else a_t_f
            for i in range(3):
                h = getattr(self, f"dec{b}_{i}")(h)
            outs.append(conv_btc(getattr(self, f"out{b}"), h))
        return torch.cat(outs, dim=-1), template, mu, log_var


class S2GDiscriminator(nn.Module):
    """Patch discriminator on pose sequences (s2glayers.py:497-512): a
    "SAME" k4 s2 conv to 64 + leaky ReLU, BatchNorm CNRs k4 s2 -> 128 and
    k4 s1 -> 256 (padding 1 each side), a "SAME" k4 conv to 1."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, 64, 4, 2)
        self.c1 = CNR1d(64, 128, kernel=4, stride=2, norm="bn")
        self.c2 = CNR1d(128, 256, kernel=4, stride=1, norm="bn")
        self.out = nn.Conv1d(256, 1, 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c2(self.c1(leaky_relu02(_conv_same(self.conv, x))))
        return _conv_same(self.out, h)
