"""Body/hand stage: two frozen VQ-VAE decoders, the MFCC audio encoder and
the audio-conditioned PixelCNN prior (port of talkshow_tpu/models/body.py:25-188).

`generate_conv_poses` is the inference path: audio encode -> AR token
decode -> VQ decode -> [body | hand].  The decode goes through
`kernels.ar_decode.sample_tokens_fused`, which launches the CUDA kernel for
CUDA tensors and runs the plain sampler for CPU tensors.  The 6-D variant
(`create_body_models(rep6d=True)`: VQ-VAEs of 78 and 180 channels, the
prior of dim 512 x 10 layers) decodes through the same kernel and gives
(B, T, 258) conv poses.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from talkshow_torch.kernels.ar_decode import model_max_batch, sample_tokens_fused
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.pixelcnn import GatedPixelCNN
from talkshow_torch.models.vqvae import VQVAE, AudioEncoder
from talkshow_torch.ops import vq as vq_ops
from talkshow_torch.ops.pose import BODY_DIM, HAND_DIM


class BodyModels(NamedTuple):
    """Modules (eval mode) + codebooks of the complete body stage."""
    vq_body: VQVAE
    vq_hand: VQVAE
    vq_body_state: vq_ops.VQState
    vq_hand_state: vq_ops.VQState
    audio_enc: AudioEncoder
    prior: GatedPixelCNN


def create_body_models(generator: torch.Generator, code_num: int = 2048,
                       embedding_dim: int = 64, num_hiddens: int = 1024,
                       pixel_dim: int = 256, pixel_layers: int = 15,
                       num_classes: int = 4, audio_channels: int = 256,
                       device="cuda", rep6d: bool = False) -> BodyModels:
    """Random-init every body-stage module from `generator` (shapes per the
    reference config/body_pixel.json; `audio_channels` is the audio
    encoder's width, JAX's `AudioEncoder(num_hiddens=)`, which the prior
    reads; `rep6d`: VQ-VAEs over the 6-D variant's 78 / 180 channels, the
    prior's width as given).  The VQ encoders, which inference
    does not run, draw their weights last, so every other module gets the
    draws it got before they were ported."""
    st_b = vq_ops.init_vq_state(generator, code_num, embedding_dim, device)
    st_h = vq_ops.init_vq_state(generator, code_num, embedding_dim, device)
    scale = 2 if rep6d else 1
    vq_body = VQVAE(BODY_DIM * scale, embedding_dim, num_hiddens)
    vq_hand = VQVAE(HAND_DIM * scale, embedding_dim, num_hiddens)
    audio_enc = AudioEncoder(64, num_hiddens=audio_channels)
    prior = GatedPixelCNN(input_dim=code_num, dim=pixel_dim, n_layers=pixel_layers,
                          n_classes=num_classes, audio_channels=audio_channels)
    for m in (vq_body.decoder, vq_hand.decoder, audio_enc, prior,
              vq_body.encoder, vq_hand.encoder):
        init_weights_(m, generator)
    vq_body, vq_hand, audio_enc, prior = (
        m.to(device).eval() for m in (vq_body, vq_hand, audio_enc, prior))
    return BodyModels(vq_body, vq_hand, st_b, st_h, audio_enc, prior)


@torch.no_grad()
def generate_conv_poses(models: BodyModels, mfcc_feat: torch.Tensor,
                        speaker_id: torch.Tensor, *,
                        generator: torch.Generator | None = None,
                        noise: torch.Tensor | None = None, tables=None,
                        prefix_tokens=None, prefix_len: int = 0):
    """MFCC (B, T, 64) + speaker ids (B,) -> (conv poses (B, 4*(T//4), 129),
    or 258 from the 6-D VQ-VAEs, tokens (B, T//4, 2)).

    Batches over the largest one kernel launch takes at the prior's shape
    (`ar_decode.model_max_batch`: 32 at dim 256, 23 at the 6-D prior's 512)
    decode as sequential chunks, each with its own slice of `noise` (H, 2,
    B, K) or its own draw from `generator`.
    `tables`: packed decode weights (kernels.ar_decode.pack_decode_tables),
    packed once per weight set by the caller."""
    audio = models.audio_enc(mfcc_feat)                      # (B, H, 256)
    B = audio.shape[0]
    chunk = model_max_batch(models.prior,
                            torch.bfloat16 if tables is None else tables["emb"].dtype)
    parts = []
    for i in range(0, B, chunk):
        sl = slice(i, i + chunk)
        parts.append(sample_tokens_fused(
            models.prior, speaker_id[sl], audio[sl], tables=tables,
            noise=None if noise is None else noise[:, :, sl].contiguous(),
            generator=generator,
            prefix_tokens=None if prefix_tokens is None else prefix_tokens[sl],
            prefix_len=prefix_len))
    tokens = torch.cat(parts, dim=0)                         # (B, H, 2)
    body = models.vq_body.decode_latents(tokens[..., 0], models.vq_body_state)
    hand = models.vq_hand.decode_latents(tokens[..., 1], models.vq_hand_state)
    return torch.cat([body, hand], dim=-1), tokens


@torch.no_grad()
def encode_gt_tokens(models: BodyModels, conv_poses: torch.Tensor) -> torch.Tensor:
    """GT conv poses (B, T, 129) -> token grid (B, T/4, 2) int64 through the
    frozen VQs (eval mode); the encode of prior training
    (smplx_body_pixel.py:193-203).  K4 runs twice on a CUDA tensor."""
    _, tb = models.vq_body.encode(conv_poses[..., :BODY_DIM], models.vq_body_state)
    _, th = models.vq_hand.encode(conv_poses[..., BODY_DIM:], models.vq_hand_state)
    return torch.stack([tb, th], dim=-1)
