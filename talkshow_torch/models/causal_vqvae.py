"""Streaming (causal) VQ-VAE with explicit carried state (port of
talkshow_tpu/models/causal_vqvae.py).

Every temporal conv is a kernel-2 look-back (out[t] = f(x[t-1], x[t])) whose
one frame of left context is carried between chunks; the stride-2 down and
up blocks are kernel-2 aligned, so a chunk that is a multiple of 4 frames
(the VQ stride) never straddles a stride window.  Decoding chunk by chunk
with the carried state therefore equals slicing a full-clip decode.

The state is a list per residual stack of (B, 1, C) tensors, one per causal
conv, as JAX carries it.  Public tensors are (B, T, C); each conv transposes
to Conv1d's (B, C, T).  BatchNorm is `FlaxBatchNorm1d` (JAX's
`TorchBatchNorm`, with flax's running-variance rule): batch statistics in
train mode, running ones in eval mode.

`encode_chunk` and the train forward quantize through `ops/vq.quantize` /
`quantize_train`, so a CUDA tensor runs the nearest-code kernel (K4);
`decode_chunk` uses the plain codebook lookup.  Submodule names follow the
flax tree (`encoder.enc_1.layers.0.conv`, ...), which
`convert.convert_causal_vqvae` maps.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from talkshow_torch.models.layers import FlaxBatchNorm1d
from talkshow_torch.ops import vq as vq_ops


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d / ConvTranspose1d on (B, T, C)."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def _norm(norm: FlaxBatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    return norm(x.transpose(1, 2)).transpose(1, 2)


class CausalConvBlock(nn.Module):
    """k2 look-back conv + BN + leaky relu; the state is the previous
    chunk's last input frame (zeros at the start)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, 2)
        self.norm = FlaxBatchNorm1d(out_channels)

    def forward(self, x, state=None):
        if state is None:
            state = x.new_zeros((x.shape[0], 1, x.shape[2]))
        h = _norm(self.norm, _conv(self.conv, torch.cat([state, x], dim=1)))
        return F.leaky_relu(h, 0.2), x[:, -1:]


class CausalDownBlock(nn.Module):
    """k2 s2 downsample: no context crosses a chunk of even length."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, 2, 2)
        self.norm = FlaxBatchNorm1d(out_channels)

    def forward(self, x):
        return F.leaky_relu(_norm(self.norm, _conv(self.conv, x)), 0.2)


class CausalUpBlock(nn.Module):
    """k2 s2 transposed upsample (flax ConvTranspose, transpose_kernel)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(in_channels, out_channels, 2, 2)
        self.norm = FlaxBatchNorm1d(out_channels)

    def forward(self, x):
        return F.leaky_relu(_norm(self.norm, _conv(self.conv, x)), 0.2)


class CausalResStack(nn.Module):
    """`layers` causal conv blocks + a 1x1 conv-BN, with a whole-stack
    residual."""

    def __init__(self, channels: int, layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(CausalConvBlock(channels, channels) for _ in range(layers))
        self.conv = nn.Conv1d(channels, channels, 1)
        self.norm = FlaxBatchNorm1d(channels)

    def forward(self, x, states=None):
        if states is None:
            states = [None] * len(self.layers)
        new_states = []
        h = x
        for layer, state in zip(self.layers, states):
            h, s = layer(h, state)
            new_states.append(s)
        h = _norm(self.norm, _conv(self.conv, h))
        return F.relu(h + x), new_states


class CausalEncoder(nn.Module):
    """Poses (B, T, in_dim) -> latents (B, T/4, embedding_dim); causal."""

    def __init__(self, in_dim: int, embedding_dim: int = 64, num_hiddens: int = 1024,
                 num_residual_layers: int = 2):
        super().__init__()
        nh, r = num_hiddens, num_residual_layers
        self.project = nn.Conv1d(in_dim, nh // 4, 1)
        self.enc_1 = CausalResStack(nh // 4, r)
        self.down_1 = CausalDownBlock(nh // 4, nh // 2)
        self.enc_2 = CausalResStack(nh // 2, r)
        self.down_2 = CausalDownBlock(nh // 2, nh)
        self.enc_3 = CausalResStack(nh, r)
        self.pre_vq_conv = nn.Conv1d(nh, embedding_dim, 1)

    def forward(self, x, states=None):
        if states is None:
            states = [None] * 3
        h = _conv(self.project, x)
        h, s1 = self.enc_1(h, states[0])
        h, s2 = self.enc_2(self.down_1(h), states[1])
        h, s3 = self.enc_3(self.down_2(h), states[2])
        return _conv(self.pre_vq_conv, h), [s1, s2, s3]


class CausalDecoder(nn.Module):
    """Latents (B, W, embedding_dim) -> poses (B, 4W, out_dim); causal, so a
    chunked decode with carried state equals the full decode."""

    def __init__(self, out_dim: int, embedding_dim: int = 64, num_hiddens: int = 1024,
                 num_residual_layers: int = 2):
        super().__init__()
        nh, r = num_hiddens, num_residual_layers
        self.aft_vq_conv = nn.Conv1d(embedding_dim, nh, 1)
        self.dec_1 = CausalResStack(nh, r)
        self.up_2 = CausalUpBlock(nh, nh // 2)
        self.dec_2 = CausalResStack(nh // 2, r)
        self.up_3 = CausalUpBlock(nh // 2, nh // 4)
        self.dec_3 = CausalResStack(nh // 4, r)
        self.project = nn.Conv1d(nh // 4, out_dim, 1)

    def forward(self, e, states=None):
        if states is None:
            states = [None] * 3
        h, s1 = self.dec_1(_conv(self.aft_vq_conv, e), states[0])
        h, s2 = self.dec_2(self.up_2(h), states[1])
        h, s3 = self.dec_3(self.up_3(h), states[2])
        return _conv(self.project, h), [s1, s2, s3]


class CausalVQVAE(nn.Module):
    """Streaming VQ-VAE over the batch model's quantizer state (`VQState`)."""

    def __init__(self, in_dim: int, embedding_dim: int = 64, num_hiddens: int = 1024,
                 num_residual_layers: int = 2):
        super().__init__()
        self.encoder = CausalEncoder(in_dim, embedding_dim, num_hiddens, num_residual_layers)
        self.decoder = CausalDecoder(in_dim, embedding_dim, num_hiddens, num_residual_layers)

    def encode_latents(self, poses, enc_states=None):
        """Raw (pre-quantization) causal latents and the new states."""
        return self.encoder(poses, enc_states)

    def encode_chunk(self, poses, vq_state: vq_ops.VQState, enc_states=None):
        """-> (quantized latents, indices (B, T/4), new states); K4 on the card."""
        z, new_states = self.encoder(poses, enc_states)
        quant, idx = vq_ops.quantize(vq_state, z)
        return quant, idx, new_states

    def decode_chunk(self, indices, vq_state: vq_ops.VQState, dec_states=None):
        """Indices (B, W) -> (poses (B, 4W, in_dim), new states)."""
        return self.decoder(vq_ops.lookup(vq_state, indices), dec_states)

    def forward(self, poses, vq_state: vq_ops.VQState):
        """Whole clip -> (recon, commit loss, new VQState, indices).  In train
        mode the quantizer is `quantize_train` (EMA update, straight-through
        estimator) and BatchNorm uses batch statistics; in eval mode the
        commit loss is 0 and the state is returned unchanged."""
        z, _ = self.encoder(poses)
        if self.training:
            quant, commit, new_state, idx = vq_ops.quantize_train(vq_state, z)
        else:
            quant, idx = vq_ops.quantize(vq_state, z)
            commit, new_state = z.new_zeros(()), vq_state
        recon, _ = self.decoder(quant)
        return recon, commit, new_state, idx
