"""End-to-end speech -> SMPL-X motion pipeline (port of
talkshow_tpu/pipeline.py:43-100,150-159,255-288,334-391).

The face generator gives jaw + expression for every frame; the body stage
samples `num_samples` body+hand sequences from the PixelCNN prior (the AR
decode is the CUDA kernel on a CUDA device) and decodes them with the
frozen VQ-VAEs; `part2full` re-inserts the canned lower body.  Everything
runs on `self.device`; results come back as numpy arrays, as the JAX
pipeline returns them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from talkshow_torch.kernels.ar_decode import pack_decode_tables
from talkshow_torch.models.body import (BodyModels, create_body_models,
                                        generate_conv_poses)
from talkshow_torch.models.face import FaceGenerator
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.ops import audio as audio_ops
from talkshow_torch.ops import pose as pose_ops
from talkshow_torch.ops.pose import SPEAKER_ID, SPEAKER_OFFSET


@dataclass
class Pipeline:
    face_model: FaceGenerator
    body: BodyModels
    device: torch.device
    num_classes: int = 4
    #: decode-table type for the CUDA kernel (bf16 in production)
    table_dtype: torch.dtype = torch.bfloat16
    #: optional (mean, std) over the full pose channels; body outputs are
    #: denormalized with the conv-channel slice
    norm_stats: tuple | None = None

    @classmethod
    def create(cls, seed: int = 0, device="cuda",
               wav2vec_cfg: Wav2Vec2Config | None = None,
               **body_kwargs) -> "Pipeline":
        """Random-init pipeline, weights drawn from torch.Generator(seed), on
        `device` (the card unless the caller asks for the CPU; raises where
        the device is missing)."""
        device = torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        face = init_weights_(FaceGenerator(wav2vec_cfg), gen).to(device).eval()
        body = create_body_models(gen, device=device, **body_kwargs)
        return cls(face, body, device)

    def load_converted(self, weights: dict) -> "Pipeline":
        """Load the output of `talkshow_torch.convert.from_jax` in place."""
        self.face_model.load_state_dict(weights["face"])
        self.body.vq_body.load_state_dict(weights["vq_body"])
        self.body.vq_hand.load_state_dict(weights["vq_hand"])
        self.body.audio_enc.load_state_dict(weights["audio_enc"])
        self.body.prior.load_state_dict(weights["prior"])
        self.body = self.body._replace(
            vq_body_state=weights["vq_body_state"].to(self.device),
            vq_hand_state=weights["vq_hand_state"].to(self.device))
        self.__dict__.pop("_decode_tables", None)
        return self

    @functools.cached_property
    def _decode_tables(self):
        """Packed AR-decode tables, built once per pipeline (CUDA only: the
        CPU path runs the plain sampler on the model's own weights)."""
        if self.device.type != "cuda":
            return None
        return pack_decode_tables(self.body.prior, self.table_dtype)

    def _denorm_conv(self, conv: np.ndarray) -> np.ndarray:
        """Denormalize generated conv-channel poses when stats are set."""
        if self.norm_stats is None:
            return conv
        mean, std = (np.asarray(a, np.float32) for a in self.norm_stats)
        if mean.shape[-1] != conv.shape[-1]:
            idx = pose_ops.C_INDEX_6D if mean.shape[-1] == 330 else pose_ops.C_INDEX_3D
            mean, std = mean[idx], std[idx]
        return conv * std + mean

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate_face(self, wav16k: np.ndarray, frame: int | None = None) -> np.ndarray:
        """Raw 16 kHz waveform (T,) -> (T_frames, 103) jaw+expression."""
        wav16k = np.asarray(wav16k, np.float32).reshape(-1)
        if frame is None:
            frame = int(len(wav16k) * 30 // 16000)
        # demo path uses a zero one-hot id (smplx_face.py:205-206)
        id_onehot = torch.zeros((1, self.num_classes), device=self.device)
        wav = torch.as_tensor(wav16k, device=self.device)[None]
        return self.face_model(wav, id_onehot, frame)[0].cpu().numpy()

    def generate_conv(self, mfcc_feat, speaker: int, num_samples: int = 1,
                      seed: int = 0, noise: torch.Tensor | None = None):
        """MFCC (T, 64) -> (conv poses (S, 4*(T//4), 129), tokens (S, T//4, 2))
        as tensors on the device.  Noise: gumbel (H, 2, S, K) to add to the
        logits as given, else drawn from torch.Generator(seed) (Philox in
        the kernel on CUDA)."""
        feat = torch.as_tensor(np.asarray(mfcc_feat, np.float32), device=self.device)
        feat = feat[None].expand(num_samples, -1, -1).contiguous()
        ids = torch.full((num_samples,), speaker, dtype=torch.long, device=self.device)
        gen = torch.Generator().manual_seed(seed)
        if noise is not None:
            noise = noise.to(self.device, torch.float32).contiguous()
        return generate_conv_poses(self.body, feat, ids, generator=gen,
                                   noise=noise, tables=self._decode_tables)

    def generate_body(self, mfcc_feat, speaker: int, num_samples: int = 1,
                      seed: int = 0, noise: torch.Tensor | None = None) -> np.ndarray:
        """MFCC (T, 64) -> conv poses (num_samples, 4*(T//4), 129)."""
        conv, _ = self.generate_conv(mfcc_feat, speaker, num_samples, seed, noise)
        return self._denorm_conv(conv.cpu().numpy())

    def generate(self, wav_file: str, speaker: int | str = 0,
                 num_samples: int = 1, only_face: bool = False,
                 stand: bool = False, seed: int = 0, sr_body: int = 22000,
                 noise: torch.Tensor | None = None) -> np.ndarray:
        """wav file -> (num_samples, T, 265) SMPL-X parameters @30fps.

        speaker: dataset id int (0-3) or name ('oliver', ...).  noise: see
        `generate_conv`."""
        if isinstance(speaker, str):
            speaker = SPEAKER_ID[speaker] - SPEAKER_OFFSET
        wav, sr0 = audio_ops.load_wav(wav_file)
        if sr0 != 16000:
            wav = audio_ops.resample(torch.as_tensor(wav), sr0, 16000).numpy()
        face_out = self.generate_face(wav)                    # (T, 103)
        T = face_out.shape[0]
        if only_face:
            base = np.zeros((T, 232), np.float32)
            base[:, :3] = face_out[:, :3]
            base[:, -100:] = face_out[:, 3:]
            return pose_ops.part2full(torch.as_tensor(base), stand=True).numpy()[None]
        with torch.no_grad():
            feat = audio_ops.get_mfcc(wav_file, sr=sr_body, fps=30, device=self.device)
        conv = self.generate_body(feat.cpu().numpy(), speaker, num_samples, seed, noise)
        return self.assemble_full(face_out, conv, stand)

    @staticmethod
    def assemble_full(face_out: np.ndarray, conv: np.ndarray,
                      stand: bool = False) -> np.ndarray:
        """Face (T, 103) + conv poses (S, Tb, 129) -> (S, T, 265): length-match
        the body to the face, splice jaw+conv+expression, part2full."""
        face_out = np.asarray(face_out, np.float32)
        jaw, exp = face_out[:, :3], face_out[:, 3:]
        T = face_out.shape[0]
        S, Tb, _ = conv.shape
        if Tb < T:
            conv = np.concatenate([conv, np.repeat(conv[:, -1:], T - Tb, axis=1)], axis=1)
        else:
            conv = conv[:, :T]
        pred = np.concatenate([np.broadcast_to(jaw[None], (S, T, 3)), conv,
                               np.broadcast_to(exp[None], (S, T, 100))], axis=-1)
        full = pose_ops.part2full(torch.as_tensor(pred.reshape(S * T, -1)), stand)
        return full.numpy().reshape(S, T, 265)
