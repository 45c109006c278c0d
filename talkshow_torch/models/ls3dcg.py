"""The LS3DCG baseline: a joint face + body + hand GAN from speech (port of
talkshow_tpu/models/ls3dcg.py:20-169, a mirror of the reference's
nets/LS3DCG.py, its reimplementation of Habibie et al.).

The generator is a 1-D conv U-Net over the MFCC: four levels of two
conv-BatchNorm-LeakyReLU(0.2) blocks with max-pooling between them (64 ...
1024 channels; the pool floors odd lengths), then three skip-connected
decoder branches (face = jaw 3 + expression 100, body 39, hands 90) that
upsample by repeating frames and resizing to the skip's length (nearest
neighbour with the integer index (i * in) // out).  The discriminator is
an LSGAN conv stack on [conv poses 129 | MFCC 64] that pools three times
and ends in a sigmoid.

Public layout is (B, T, C); the modules run Conv1d's (B, C, T) inside.
Parameter names follow the JAX modules (`down1_0` .. `down4_1`,
`{face,body,hand}_decoder.up1_0` .. `up3_out`, `c0` .. `c5`, `out`), each
block holding `conv` and `norm` (`convert.convert_ls3dcg` maps flax's
trees onto them).  BatchNorm is `FlaxBatchNorm1d` (flax's update, with the
biased running variance).

Output layout of the generator: (B, T, 232) = [jaw 3 | exp 100 | body 39 |
hand 90], face first; `infer_on_audio` reorders it for SMPL-X.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from talkshow_torch.models.layers import FlaxBatchNorm1d
from talkshow_torch.ops import audio as audio_ops
from talkshow_torch.ops import pose as pose_ops

#: the discriminator's input: the 129 conv channels and the 64 MFCC
DISC_IN = 129 + 64


def nearest_resize(x: torch.Tensor, out_len: int, dim: int = 1) -> torch.Tensor:
    """F.interpolate(mode='nearest') along `dim` (the time axis; 1 for
    (B, T, C)): frame i of the output is frame (i * in) // out."""
    in_len = x.shape[dim]
    if in_len == out_len:
        return x
    idx = (torch.arange(out_len, device=x.device) * in_len) // out_len
    return x.index_select(dim, idx)


class TFConvNormRelu(nn.Module):
    """Conv1d (kernel 3, stride 1, TF 'SAME' padding: one frame each side)
    + BatchNorm + LeakyReLU(0.2) (nets/spg/s2glayers.py:116-154)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, 3, 1, 1)
        self.norm = FlaxBatchNorm1d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> (B, out, T)."""
        return F.leaky_relu(self.norm(self.conv(x)), 0.2)


def _up(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Resize x (B, C, T) to the skip's length and concatenate the skip."""
    return torch.cat([nearest_resize(x, skip.shape[2], dim=2), skip], dim=1)


class LSDecoder(nn.Module):
    """A skip-connected upsampling branch (nets/LS3DCG.py:99-128): resize to
    x3 and concat, two blocks, repeat every frame, resize to x2 and concat,
    two blocks, repeat, resize to x1 and concat, two blocks, a 1x1 conv."""

    def __init__(self, in_ch: int, out_ch: int, skips=(128, 256, 512)):
        super().__init__()
        c = in_ch
        s1, s2, s3 = skips
        self.up1_0 = TFConvNormRelu(c + s3, c // 2)
        self.up1_1 = TFConvNormRelu(c // 2, c // 2)
        self.up2_0 = TFConvNormRelu(c // 2 + s2, c // 4)
        self.up2_1 = TFConvNormRelu(c // 4, c // 4)
        self.up3_0 = TFConvNormRelu(c // 4 + s1, c // 8)
        self.up3_1 = TFConvNormRelu(c // 8, c // 8)
        self.up3_out = nn.Conv1d(c // 8, out_ch, 1)

    def forward(self, x, x1, x2, x3):
        """Everything (B, C, T)."""
        x = self.up1_1(self.up1_0(_up(x, x3)))
        x = self.up2_1(self.up2_0(_up(torch.repeat_interleave(x, 2, dim=2), x2)))
        x = self.up3_1(self.up3_0(_up(torch.repeat_interleave(x, 2, dim=2), x1)))
        return self.up3_out(x)


class LS3DCGGenerator(nn.Module):
    """MFCC (B, T, 64) -> (B, T, 232) [jaw 3 | exp 100 | body 39 | hand 90]
    (nets/LS3DCG.py:131-201).  Widths fixed, as in JAX."""

    def __init__(self, jaw_dim: int = 3, exp_dim: int = 100, body_dim: int = 39,
                 hand_dim: int = 90, aud_dim: int = 64):
        super().__init__()
        self.down1_0 = TFConvNormRelu(aud_dim, 64)
        self.down1_1 = TFConvNormRelu(64, 128)
        self.down2_0 = TFConvNormRelu(128, 128)
        self.down2_1 = TFConvNormRelu(128, 256)
        self.down3_0 = TFConvNormRelu(256, 256)
        self.down3_1 = TFConvNormRelu(256, 512)
        self.down4_0 = TFConvNormRelu(512, 512)
        self.down4_1 = TFConvNormRelu(512, 1024)
        self.face_decoder = LSDecoder(1024, jaw_dim + exp_dim)
        self.body_decoder = LSDecoder(1024, body_dim)
        self.hand_decoder = LSDecoder(1024, hand_dim)

    def forward(self, aud: torch.Tensor) -> torch.Tensor:
        x = aud.transpose(1, 2)
        x1 = self.down1_1(self.down1_0(x))
        x2 = self.down2_1(self.down2_0(F.max_pool1d(x1, 2, 2)))
        x3 = self.down3_1(self.down3_0(F.max_pool1d(x2, 2, 2)))
        x = self.down4_1(self.down4_0(F.max_pool1d(x3, 2, 2)))
        x = torch.repeat_interleave(x, 2, dim=2)
        out = torch.cat([self.face_decoder(x, x1, x2, x3), self.body_decoder(x, x1, x2, x3),
                         self.hand_decoder(x, x1, x2, x3)], dim=1)
        return out.transpose(1, 2)


class LS3DCGDiscriminator(nn.Module):
    """[poses 129 | aud 64] (B, T, 193) -> (B, T/8, 1) LSGAN scores in (0, 1)
    (nets/LS3DCG.py:204-225)."""

    def __init__(self, in_dim: int = DISC_IN):
        super().__init__()
        self.c0 = TFConvNormRelu(in_dim, 128)
        self.c1 = TFConvNormRelu(128, 256)
        self.c2 = TFConvNormRelu(256, 256)
        self.c3 = TFConvNormRelu(256, 512)
        self.c4 = TFConvNormRelu(512, 512)
        self.c5 = TFConvNormRelu(512, 1024)
        self.out = nn.Conv1d(1024, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c1(self.c0(x.transpose(1, 2)))
        h = self.c3(self.c2(F.max_pool1d(h, 2, 2)))
        h = self.c5(self.c4(F.max_pool1d(h, 2, 2)))
        h = self.out(F.max_pool1d(h, 2, 2))
        return torch.sigmoid(h).transpose(1, 2)


def to_smplx_order(pred: torch.Tensor) -> torch.Tensor:
    """The generator's [jaw | exp 100 | conv 129] -> [jaw | conv 129 | exp]
    (scripts/demo.py:221-222)."""
    return torch.cat([pred[..., :3], pred[..., 103:], pred[..., 3:103]], dim=-1)


@torch.no_grad()
def infer_on_audio(gen: LS3DCGGenerator, wav_file: str, num_samples: int = 1,
                   sr: int = 22000, fps: int = 30, stand: bool = False,
                   norm_stats=None) -> np.ndarray:
    """Speech wav -> (num_samples, T, 265) full SMPL-X motion (the reference
    chain, nets/LS3DCG.py:365-391): the MFCC (`ops/audio.get_mfcc`, on the
    generator's device), the generator in eval mode, the reorder to [jaw |
    conv | exp], the de-normalisation with `norm_stats` (mean, std) when
    given (stats over the 165 poses are padded to the 232 channels: the jaw
    and conv channels picked, the expression's mean 0 and std 1), and
    `part2full`'s lower-body re-insertion.  The generator is deterministic
    given the audio, so every sample is the same motion, as the reference
    repeats it."""
    dev = next(gen.parameters()).device
    feat = audio_ops.get_mfcc(wav_file, sr=sr, fps=fps, device=dev)      # (T, 64)
    pred = to_smplx_order(gen.eval()(feat[None].float())).cpu().numpy()
    if norm_stats is not None:
        mean, std = (np.asarray(a, np.float32) for a in norm_stats)
        if mean.shape[-1] != pred.shape[-1]:                              # stats over 165
            idx = np.concatenate([np.arange(3), pose_ops.C_INDEX_3D])
            mean = np.concatenate([mean[idx], np.zeros(100, np.float32)])
            std = np.concatenate([std[idx], np.ones(100, np.float32)])
        pred = pred * std + mean
    full = pose_ops.part2full(torch.as_tensor(pred[0]), stand).numpy()    # (T, 265)
    return np.broadcast_to(full[None], (num_samples,) + full.shape).copy()
