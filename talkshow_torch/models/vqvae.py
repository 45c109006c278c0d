"""1-D conv VQ-VAE for body/hand motion tokens and the MFCC audio encoder
(port of talkshow_tpu/models/vqvae.py:28-107,131-150).

Inference needs only the decode half: tokens -> codebook lookup -> Decoder
(T/4 -> T).  Training (stage 1) runs the whole VQ-VAE: Encoder (T -> T/4)
-> EMA quantizer (`ops/vq.quantize_train`, K4 on the card) -> Decoder; the
prior's token encode runs Encoder -> `ops/vq.quantize`.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from talkshow_torch.models.layers import ConvNormRelu, ResCNRStack
from talkshow_torch.ops import vq as vq_ops


class Encoder(nn.Module):
    """(B, T, in_dim) -> (B, T/4, embedding_dim) (vqvae_1d.py:66-92)."""

    def __init__(self, in_dim: int, embedding_dim: int = 64,
                 num_hiddens: int = 1024, num_residual_layers: int = 2):
        super().__init__()
        nh, r = num_hiddens, num_residual_layers
        self.project = ConvNormRelu(in_dim, nh // 4, leaky=True)
        self._enc_1 = ResCNRStack(nh // 4, r, leaky=True)
        self._down_1 = ConvNormRelu(nh // 4, nh // 2, leaky=True, residual=True,
                                    sample="down")
        self._enc_2 = ResCNRStack(nh // 2, r, leaky=True)
        self._down_2 = ConvNormRelu(nh // 2, nh, leaky=True, residual=True,
                                    sample="down")
        self._enc_3 = ResCNRStack(nh, r, leaky=True)
        self.pre_vq_conv = nn.Conv1d(nh, embedding_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        for block in (self.project, self._enc_1, self._down_1, self._enc_2,
                      self._down_2, self._enc_3):
            h = block.forward_nct(h)
        return self.pre_vq_conv(h).transpose(1, 2)


class Decoder(nn.Module):
    """(B, T/4, embedding_dim) -> (B, T, out_dim) (vqvae_1d.py:116-149)."""

    def __init__(self, out_dim: int, embedding_dim: int = 64,
                 num_hiddens: int = 1024, num_residual_layers: int = 2):
        super().__init__()
        nh, r = num_hiddens, num_residual_layers
        self.aft_vq_conv = nn.Conv1d(embedding_dim, nh, 1)
        self._dec_1 = ResCNRStack(nh, r, leaky=True)
        self._up_2 = ConvNormRelu(nh, nh // 2, leaky=True, residual=True, sample="up")
        self._dec_2 = ResCNRStack(nh // 2, r, leaky=True)
        self._up_3 = ConvNormRelu(nh // 2, nh // 4, leaky=True, residual=True,
                                  sample="up")
        self._dec_3 = ResCNRStack(nh // 4, r, leaky=True)
        self.project = nn.Conv1d(nh // 4, out_dim, 1)

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        h = self.aft_vq_conv(e.transpose(1, 2))
        for block in (self._dec_1, self._up_2, self._dec_2, self._up_3, self._dec_3):
            h = block.forward_nct(h)
        return self.project(h).transpose(1, 2)


class VQVAE(nn.Module):
    """vqvae_1d.VQVAE (:168-208): poses (B, T, in_dim) <-> codebook indices
    (B, T/4).  The quantizer state is the functional `vq_state` argument.
    `encoder` is registered after `decoder`, so `init_weights_` draws the
    decoder's weights first, as it did before the encoder was ported
    (`body.create_body_models` draws both encoders last)."""

    def __init__(self, in_dim: int, embedding_dim: int = 64,
                 num_hiddens: int = 1024, num_residual_layers: int = 2):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.decoder = Decoder(in_dim, embedding_dim, num_hiddens,
                               num_residual_layers)
        self.encoder = Encoder(in_dim, embedding_dim, num_hiddens,
                               num_residual_layers)

    def forward(self, poses: torch.Tensor, vq_state: vq_ops.VQState):
        """-> (recon, commit_loss, new_vq_state, indices).  The module's mode
        selects the EMA update and batch-statistics BatchNorm, as the JAX
        `train` flag does."""
        z = self.encoder(poses)
        if self.training:
            quant, commit, new_state, idx = vq_ops.quantize_train(vq_state, z)
        else:
            quant, idx = vq_ops.quantize(vq_state, z)
            commit, new_state = z.new_zeros(()), vq_state
        return self.decoder(quant), commit, new_state, idx

    def encode(self, poses: torch.Tensor, vq_state: vq_ops.VQState):
        """(B, T, C) -> (quantized (B, T/4, D), indices (B, T/4))."""
        return vq_ops.quantize(vq_state, self.encoder(poses))

    def decode_latents(self, indices: torch.Tensor,
                       vq_state: vq_ops.VQState) -> torch.Tensor:
        """(B, W) int tokens -> (B, W*4, C) poses."""
        return self.decoder(vq_ops.lookup(vq_state, indices))


class AudioEncoder(nn.Module):
    """MFCC (B, T, in_dim) -> (B, T/4, num_hiddens) (vqvae_1d.py:11-34)."""

    def __init__(self, in_dim: int = 64, num_hiddens: int = 256,
                 num_residual_layers: int = 2):
        super().__init__()
        nh, r = num_hiddens, num_residual_layers
        self.project = ConvNormRelu(in_dim, nh // 4, leaky=True)
        self._enc_1 = ResCNRStack(nh // 4, r, leaky=True)
        self._down_1 = ConvNormRelu(nh // 4, nh // 2, leaky=True, residual=True,
                                    sample="down")
        self._enc_2 = ResCNRStack(nh // 2, r, leaky=True)
        self._down_2 = ConvNormRelu(nh // 2, nh, leaky=True, residual=True,
                                    sample="down")
        self._enc_3 = ResCNRStack(nh, r, leaky=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        for block in (self.project, self._enc_1, self._down_1, self._enc_2,
                      self._down_2, self._enc_3):
            h = block.forward_nct(h)
        return h.transpose(1, 2)
