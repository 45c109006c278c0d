"""1-D conv VQ-VAE for body/hand motion tokens, the plain body
autoencoder and the MFCC audio encoder (port of
talkshow_tpu/models/vqvae.py:28-150).

Inference needs only the decode half: tokens -> codebook lookup -> Decoder
(T/4 -> T).  Training (stage 1) runs the whole VQ-VAE: Encoder (T -> T/4)
-> EMA quantizer (`ops/vq.quantize_train`, K4 on the card) -> Decoder; the
prior's token encode and the VQ capacity eval run Encoder ->
`ops/vq.quantize`.  `AE` is the same trunk without the quantizer: the FGD
feature net (nets/body_ae.py), trained by `train.steps.make_body_ae_step`.
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
    (`body.create_body_models` draws both encoders last).  `mesh`: set by
    `parallel.collectives.shard_state` for training over dp ranks (the
    EMA update's sums over the global batch)."""

    mesh = None

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
            quant, commit, new_state, idx = vq_ops.quantize_train(vq_state, z, mesh=self.mesh)
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


class AE(nn.Module):
    """Plain autoencoder over the conv channels, the FGD feature net
    (vqvae_1d.py:211-235, nets/body_ae.py): poses (B, T, in_dim) -> encode
    (B, T/4, embedding_dim) -> decode (B, T, in_dim).  The module's mode
    selects batch-statistics BatchNorm, as the JAX `train` flag does.
    Registered as VQVAE (decoder first), so `init_weights_` draws alike."""

    def __init__(self, in_dim: int, embedding_dim: int = 64,
                 num_hiddens: int = 1024, num_residual_layers: int = 2):
        super().__init__()
        self.decoder = Decoder(in_dim, embedding_dim, num_hiddens, num_residual_layers)
        self.encoder = Encoder(in_dim, embedding_dim, num_hiddens, num_residual_layers)

    def forward(self, poses: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(poses))

    def encode(self, poses: torch.Tensor) -> torch.Tensor:
        return self.encoder(poses)


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


class Wav2VecVQEncoder(nn.Module):
    """Wav2vec-fronted VQ encoder variant (vqvae_1d.py:37-63; JAX
    models/vqvae.py:152-179): wav2vec 2.0 features (B, frame_num, hidden)
    -> project -> res / down stacks -> (B, frame_num / 4, num_hiddens).
    Kept for surface parity; the released models use the MFCC encoder.

    Train mode runs the plain encoder (the extractor's backward included,
    as JAX's) and batch-statistics BatchNorm.  Eval mode on a CUDA
    waveform runs the unmasked face route: K3 (`wav2vec_fused.
    extractor_fused`) -> `mid_stack` -> K2 (`encoder_layers_fused`) on
    `tables` (`pack_tables`; packed per call when not given), one launch of
    each; on a CPU waveform the plain encoder."""

    def __init__(self, num_hiddens: int = 1024, num_residual_layers: int = 2,
                 wav2vec_cfg=None):
        super().__init__()
        from talkshow_torch.models.wav2vec import Wav2Vec2Config, Wav2Vec2Encoder
        cfg = wav2vec_cfg or Wav2Vec2Config()
        nh, r = num_hiddens, num_residual_layers
        self.audio_encoder = Wav2Vec2Encoder(cfg)
        self.project = ConvNormRelu(cfg.hidden_size, nh, leaky=True)
        self._enc_1 = ResCNRStack(nh, r, leaky=True)
        self._down_1 = ConvNormRelu(nh, nh, leaky=True, residual=True, sample="down")
        self._enc_2 = ResCNRStack(nh, r, leaky=True)
        self._down_2 = ConvNormRelu(nh, nh, leaky=True, residual=True, sample="down")
        self._enc_3 = ResCNRStack(nh, r, leaky=True)

    def pack_tables(self, dtype: torch.dtype = torch.bfloat16) -> dict:
        """K2's and K3's tables of the wav2vec encoder: {'enc', 'ext'}."""
        from talkshow_torch.models.wav2vec_fused import pack_face_tables
        return pack_face_tables(self, dtype)

    def forward(self, waveform: torch.Tensor, frame_num: int, *,
                tables: dict | None = None) -> torch.Tensor:
        enc = self.audio_encoder
        if not self.training and waveform.device.type == "cuda":
            from talkshow_torch.models.wav2vec_fused import encoder_layers_fused, extractor_fused
            with torch.no_grad():
                tables = tables or self.pack_tables()
                feats = extractor_fused(enc, waveform, tables=tables["ext"])
                h = encoder_layers_fused(enc, enc.mid_stack(feats, frame_num),
                                         tables=tables["enc"])
        else:
            h = enc(waveform, frame_num)
        return self.head(h)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """wav2vec features (B, T, hidden) -> project and the res / down
        stacks -> (B, T / 4, num_hiddens)."""
        h = h.transpose(1, 2)
        for block in (self.project, self._enc_1, self._down_1, self._enc_2,
                      self._down_2, self._enc_3):
            h = block.forward_nct(h)
        return h.transpose(1, 2)
