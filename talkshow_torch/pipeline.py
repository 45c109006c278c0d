"""End-to-end speech -> SMPL-X motion pipeline (port of
talkshow_tpu/pipeline.py:43-159,221-288,334-430).

The face generator gives jaw + expression for every frame; the body stage
samples `num_samples` body+hand sequences from the PixelCNN prior (the AR
decode is the CUDA kernel on a CUDA device) and decodes them with the
frozen VQ-VAEs; `part2full` re-inserts the canned lower body.  Everything
runs on `self.device`; results come back as numpy arrays, as the JAX
pipeline returns them.

On the card the face stage runs through the wav2vec kernels (K3, the conv
extractor, and K2, the encoder layers: `models/wav2vec_fused.face_apply_fused`)
on tables packed once per pipeline (`_face_tables`, bf16 unless
`with_face_dtype` asks for f32).  That is the port's own choice: the JAX
package leaves its wav2vec kernels unwired because they lost to XLA on the
TPU, and on the H100 they are faster than the plain stage.  A pipeline on
the CPU runs the plain face stage (`FaceGenerator.forward`).

`generate_body_sharded` splits the samples over a mesh axis
(`parallel.mesh.Mesh`, JAX's shard_map at pipeline.py:290-332): each
shard decodes its rows on its own device (one K1 launch per shard on the
card), on a copy of the weights and decode tables made once per device
(`replica`).

Traced (`talkshow_torch.tracing`): `generate` is the root span
``generate`` (samples, wav_len) over ``wav_read`` and ``resample``
(`ops/audio`), ``face_stage``, ``mfcc``, ``body_stage`` (``ar_decode``
under it) and ``assembly``; called alone, `generate_body` is a root
``body_stage``.  Every read from the device (`tracing.to_host`) and copy to
it (`tracing.to_device`) on the way is a ``device_wait`` span and one
``host_sync``.

Weights come from `create` (random, seeded), `load_converted` (the JAX
package's, through `talkshow_torch.convert.from_jax`),
`from_torch_checkpoints` (the reference trainer's `.pth` files) or
`load_pipeline` (this port's own file, written by `save_pipeline`).
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from talkshow_torch import convert
from talkshow_torch.kernels.ar_decode import pack_decode_tables
from talkshow_torch.models.body import (BodyModels, create_body_models,
                                        generate_conv_poses)
from talkshow_torch.models.face import FaceGenerator
from talkshow_torch.models.layers import init_weights_
from talkshow_torch.models.wav2vec import Wav2Vec2Config
from talkshow_torch.models.wav2vec_fused import face_apply_fused, pack_face_tables
from talkshow_torch.ops import audio as audio_ops
from talkshow_torch.ops import pose as pose_ops
from talkshow_torch.ops.pose import SPEAKER_ID, SPEAKER_OFFSET
from talkshow_torch.ops.vq import VQState
from talkshow_torch.tracing import span, to_device, to_host

_VQ_STATES = ("vq_body_state", "vq_hand_state")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _resolve(device) -> torch.device:
    """A device with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_seed(seed: int, shard: int) -> int:
    """The seed of shard `shard`'s generator in a sharded call seeded
    `seed` (numpy's SeedSequence; 63 bits)."""
    state = np.random.SeedSequence([seed, shard]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


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
    #: face-table type for K3 and K2 on the card (bf16 in production, f32
    #: the exact one)
    face_dtype: torch.dtype = torch.bfloat16

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

    @classmethod
    def from_torch_checkpoints(cls, face_ckpt: str | None = None,
                               body_ckpt: str | None = None,
                               vq_ckpt: str | None = None, device="cuda",
                               wav2vec_cfg: Wav2Vec2Config | None = None,
                               **body_kwargs) -> "Pipeline":
        """Build from the reference TalkSHOW trainer's .pth checkpoints
        (converted on load by `talkshow_torch.convert.reference_*`).

        body_ckpt: the s2g_body_pixel checkpoint (the prior and the audio
        encoder).  vq_ckpt: the s2g_body_vq checkpoint (codebooks and
        decoders); when omitted, the VQ weights are looked up in body_ckpt.
        The modules are built by `create(0, device, wav2vec_cfg,
        **body_kwargs)`, so the widths must be the checkpoints' (the
        defaults are the released models'); loading is strict."""
        pipe = cls.create(0, device, wav2vec_cfg, **body_kwargs)

        def load(path):
            return torch.load(path, map_location="cpu", weights_only=True)

        weights = {}
        if face_ckpt:
            weights["face"] = convert.reference_face(load(face_ckpt))
        body = load(body_ckpt) if body_ckpt else None
        vq = load(vq_ckpt) if vq_ckpt else body
        if vq is not None and "g_body" in vq.get("generator", vq):
            weights.update(convert.reference_body_vq(vq))
        if body is not None:
            weights.update(convert.reference_body_pixel(body, body_kwargs.get("bh_model", True)))
        return pipe.load_converted(weights)

    def _modules(self) -> dict:
        return {"face": self.face_model, "vq_body": self.body.vq_body,
                "vq_hand": self.body.vq_hand, "audio_enc": self.body.audio_enc,
                "prior": self.body.prior}

    def load_converted(self, weights: dict) -> "Pipeline":
        """Load weights in place: the output of `convert.from_jax`, or any
        subset of its keys ("face", "vq_body", "vq_hand", "audio_enc",
        "prior": state dicts, loaded strictly; "vq_body_state",
        "vq_hand_state": VQState).  Drops the packed kernel tables."""
        for name, module in self._modules().items():
            if name in weights:
                module.load_state_dict(weights[name])
        states = {k: weights[k].to(self.device) for k in _VQ_STATES if k in weights}
        self.body = self.body._replace(**states)
        self.__dict__.pop("_decode_tables", None)
        self.__dict__.pop("_face_tables", None)
        self.__dict__.pop("_replicas", None)
        return self

    def replica(self, device) -> "Pipeline":
        """This pipeline on `device`: itself on its own device, else a copy
        of its weights there, made once per device and kept (its decode
        and face tables are packed there on first use)."""
        device = _resolve(device)
        if device == _resolve(self.device):
            return self
        replicas = self.__dict__.setdefault("_replicas", {})
        if device not in replicas:
            body = BodyModels(*(copy.deepcopy(m).to(device) if isinstance(m, torch.nn.Module)
                                else m.to(device) for m in self.body))
            replicas[device] = dataclasses.replace(
                self, face_model=copy.deepcopy(self.face_model).to(device), body=body,
                device=device)
        return replicas[device]

    def with_face_dtype(self, dtype: torch.dtype) -> "Pipeline":
        """A pipeline on the same modules whose face stage runs on `dtype`
        tables on the card (torch.bfloat16 or torch.float32).  JAX's
        `with_face_dtype` sets the face stage's compute type; here the type
        is that of the kernels' tables, packed anew on first use."""
        return dataclasses.replace(self, face_dtype=dtype)

    def with_norm_stats(self, stats) -> "Pipeline":
        """A pipeline on the same modules with normalization stats: a (mean,
        std) tuple over the full pose channels or a path to a
        norm_stats.npy (as the reference Trainer saves it)."""
        if isinstance(stats, str):
            arr = np.load(stats)
            stats = (np.asarray(arr[0], np.float32), np.asarray(arr[1], np.float32))
        return dataclasses.replace(self, norm_stats=stats)

    @functools.cached_property
    def _decode_tables(self):
        """Packed AR-decode tables, built once per pipeline (CUDA only: the
        CPU path runs the plain sampler on the model's own weights)."""
        if self.device.type != "cuda":
            return None
        return pack_decode_tables(self.body.prior, self.table_dtype)

    @functools.cached_property
    def _face_tables(self):
        """K3's and K2's tables, packed once per pipeline in `face_dtype`
        (CUDA only: the CPU path runs the plain face stage)."""
        if self.device.type != "cuda":
            return None
        return pack_face_tables(self.face_model, self.face_dtype)

    def conv_norm(self):
        """(mean, std) over the 129 conv channels as float32 arrays, or
        None without stats."""
        if self.norm_stats is None:
            return None
        mean, std = (np.asarray(a, np.float32) for a in self.norm_stats)
        if mean.shape[-1] not in (129, 258):
            idx = pose_ops.C_INDEX_6D if mean.shape[-1] == 330 else pose_ops.C_INDEX_3D
            mean, std = mean[idx], std[idx]
        return mean, std

    def _denorm_conv(self, conv: np.ndarray) -> np.ndarray:
        """Denormalize generated conv-channel poses when stats are set."""
        norm = self.conv_norm()
        return conv if norm is None else conv * norm[1] + norm[0]

    # ------------------------------------------------------------------
    def face_stage(self, wav: torch.Tensor, id_onehot: torch.Tensor, frames: int,
                   valid_samples=None, valid_frames=None) -> torch.Tensor:
        """(B, N) 16 kHz waveforms on the device -> (B, frames, 103).  On the
        card: K3 + K2 (unmasked) or the plain masked extractor + K2 masked
        (valid_samples / valid_frames given); on the CPU the plain stage."""
        if self.device.type == "cuda":
            return face_apply_fused(self.face_model, wav, id_onehot, frames, valid_samples,
                                    valid_frames, tables=self._face_tables)
        with torch.no_grad():
            return self.face_model(wav, id_onehot, frames, valid_samples, valid_frames)

    def generate_face(self, wav16k: np.ndarray, frame: int | None = None) -> np.ndarray:
        """Raw 16 kHz waveform (T,) -> (T_frames, 103) jaw+expression."""
        wav16k = np.asarray(wav16k, np.float32).reshape(-1)
        if frame is None:
            frame = int(len(wav16k) * 30 // 16000)
        with span("face_stage", frames=frame):
            # demo path uses a zero one-hot id (smplx_face.py:205-206)
            id_onehot = torch.zeros((1, self.num_classes), device=self.device)
            wav = to_device(wav16k, self.device)[None]
            return to_host(self.face_stage(wav, id_onehot, frame)[0])

    def _batch(self, mfcc_feat, speaker: int, num_samples: int):
        feat = to_device(mfcc_feat, self.device, torch.float32)
        feat = feat[None].expand(num_samples, -1, -1).contiguous()
        ids = torch.full((num_samples,), speaker, dtype=torch.long, device=self.device)
        return feat, ids

    def _noise(self, noise):
        return None if noise is None else noise.to(self.device, torch.float32).contiguous()

    def generate_conv(self, mfcc_feat, speaker: int, num_samples: int = 1,
                      seed: int = 0, noise: torch.Tensor | None = None):
        """MFCC (T, 64) -> (conv poses (S, 4*(T//4), 129), tokens (S, T//4, 2))
        as tensors on the device.  Noise: gumbel (H, 2, S, K) to add to the
        logits as given, else drawn from torch.Generator(seed) (Philox in
        the kernel on CUDA)."""
        feat, ids = self._batch(mfcc_feat, speaker, num_samples)
        gen = torch.Generator().manual_seed(seed)
        return generate_conv_poses(self.body, feat, ids, generator=gen,
                                   noise=self._noise(noise), tables=self._decode_tables)

    def generate_conv_continuity(self, mfcc_feat, gap: int, speaker: int,
                                 num_samples: int = 1, seed: int = 0, noise=None):
        """The continuity decode (smplx_body_pixel.infer_on_audio
        continuity=True, :245-269): sample the first `gap` feature frames'
        tokens, then sample the whole grid with them teacher-forced as a
        prefix.  Two decodes, each drawing its own noise from
        torch.Generator(seed) in turn (JAX splits its key in two), or
        `noise` = (block of the first, block of the second).  Returns
        (conv poses (S, 4*(T//4), 129), the first decode's tokens
        (S, gap//4, 2), the second's (S, T//4, 2)) on the device."""
        feat, ids = self._batch(mfcc_feat, speaker, num_samples)
        gen = torch.Generator().manual_seed(seed)
        n0, n1 = (None, None) if noise is None else (self._noise(n) for n in noise)
        _, tokens0 = generate_conv_poses(self.body, feat[:, :gap], ids, generator=gen,
                                         noise=n0, tables=self._decode_tables)
        h0 = tokens0.shape[1]
        prefix = torch.zeros((num_samples, feat.shape[1] // 4, 2), dtype=torch.long,
                             device=self.device)
        prefix[:, :h0] = tokens0
        conv, tokens = generate_conv_poses(self.body, feat, ids, generator=gen, noise=n1,
                                           tables=self._decode_tables,
                                           prefix_tokens=prefix, prefix_len=h0)
        return conv, tokens0, tokens

    def generate_body(self, mfcc_feat, speaker: int, num_samples: int = 1,
                      seed: int = 0, noise: torch.Tensor | None = None,
                      pad_to_bucket: int | None = None) -> np.ndarray:
        """MFCC (T, 64) -> conv poses (num_samples, 4*(T//4), 129).

        pad_to_bucket: serving mode, the frame axis padded with zeros to a
        multiple of 4 * pad_to_bucket (one decode shape per bucket).  The AR
        decode is causal, so padded tail rows cannot change real ones; only
        the VQ decoder's local receptive field sees the boundary, and the
        padded tail is cropped off.  A `noise` block then covers the padded
        rows."""
        mfcc_feat = np.asarray(mfcc_feat, np.float32)
        T = mfcc_feat.shape[0]
        with span("body_stage", samples=num_samples, frames=T):
            if pad_to_bucket:
                Tp = _round_up(max(T, 4), pad_to_bucket * 4)
                mfcc_feat = np.pad(mfcc_feat, [[0, Tp - T], [0, 0]])
            conv, _ = self.generate_conv(mfcc_feat, speaker, num_samples, seed, noise)
            if pad_to_bucket:
                conv = conv[:, : (T // 4) * 4]
            return self._denorm_conv(to_host(conv))

    def generate_conv_sharded(self, mfcc_feat, speaker: int, num_samples: int, mesh,
                              seed: int = 0, axis: str = "dp", noise=None) -> list:
        """The sample batch split over the mesh's `axis`: shard i decodes
        num_samples / n rows on its device (`Mesh.axis_devices`), from its
        own noise: `noise[i]`, a gumbel block (H, 2, num_samples / n, K),
        or torch.Generator(shard_seed(seed, i)).  Every shard is launched
        before any is read.  Returns [(conv poses, tokens)] per shard, on
        the shard's device.  Raises ValueError unless the axis divides
        num_samples."""
        devices = mesh.axis_devices(axis)
        n = len(devices)
        if num_samples % n:
            raise ValueError(f"num_samples={num_samples} not divisible by mesh axis "
                             f"'{axis}' size {n}")
        if noise is not None and len(noise) != n:
            raise ValueError(f"noise: {len(noise)} blocks for {n} shards")
        out = []
        for i, dev in enumerate(devices):
            shard = self.replica(dev)
            out.append(shard.generate_conv(mfcc_feat, speaker, num_samples // n,
                                           shard_seed(seed, i),
                                           None if noise is None else noise[i]))
        return out

    def generate_body_sharded(self, mfcc_feat, speaker: int, num_samples: int, mesh,
                              seed: int = 0, axis: str = "dp", noise=None) -> np.ndarray:
        """Diversity sampling sharded over a device mesh (JAX
        pipeline.py:290-332): MFCC (T, 64) -> conv poses (num_samples,
        4*(T//4), 129), shard i's rows from its own noise
        (`generate_conv_sharded`; JAX gives shard i the key
        split(PRNGKey(seed), n)[i], which `noise` can carry)."""
        parts = self.generate_conv_sharded(mfcc_feat, speaker, num_samples, mesh, seed, axis,
                                           noise)
        conv = np.concatenate([c.cpu().numpy() for c, _ in parts])
        return self._denorm_conv(conv)

    def generate_body_continuity(self, wav_file: str, speaker: int,
                                 num_samples: int = 1, seed: int = 0,
                                 sr_body: int = 22000, noise=None) -> np.ndarray:
        """Chunked long-audio generation: featurize the first 2 s and the
        rest apart (`get_mfcc_sepa`), then `generate_conv_continuity`.
        sr_body defaults to 22 kHz like the reference (the fps=30 MFCC hop
        of 734 samples is tuned for it)."""
        feat, gap = audio_ops.get_mfcc_sepa(wav_file, sr=sr_body, fps=30, device=self.device)
        conv, _, _ = self.generate_conv_continuity(feat, gap, speaker, num_samples, seed,
                                                   noise)
        return self._denorm_conv(conv.cpu().numpy())

    def generate(self, wav_file: str, speaker: int | str = 0,
                 num_samples: int = 1, only_face: bool = False,
                 stand: bool = False, seed: int = 0, sr_body: int = 22000,
                 noise=None, continuity: bool = False) -> np.ndarray:
        """wav file -> (num_samples, T, 265) SMPL-X parameters @30fps.

        speaker: dataset id int (0-3) or name ('oliver', ...).  noise: see
        `generate_conv`; with continuity=True, the pair of blocks of
        `generate_conv_continuity`."""
        with span("generate", samples=num_samples) as sp:
            if isinstance(speaker, str):
                speaker = SPEAKER_ID[speaker] - SPEAKER_OFFSET
            wav, sr0 = audio_ops.load_wav(wav_file)
            sp.set(wav_len=len(wav))
            if sr0 != 16000:
                wav = audio_ops.resample(torch.as_tensor(wav), sr0, 16000).numpy()
            face_out = self.generate_face(wav)                    # (T, 103)
            T = face_out.shape[0]
            if only_face:
                base = np.zeros((T, 232), np.float32)
                base[:, :3] = face_out[:, :3]
                base[:, -100:] = face_out[:, 3:]
                return pose_ops.part2full(torch.as_tensor(base), stand=True).numpy()[None]
            if continuity:
                conv = self.generate_body_continuity(wav_file, speaker, num_samples, seed,
                                                     sr_body, noise)
            else:
                with torch.no_grad():
                    feat = audio_ops.get_mfcc(wav_file, sr=sr_body, fps=30, device=self.device)
                conv = self.generate_body(to_host(feat), speaker, num_samples, seed, noise)
            return self.assemble_full(face_out, conv, stand)

    @staticmethod
    def assemble_full(face_out: np.ndarray, conv: np.ndarray,
                      stand: bool = False) -> np.ndarray:
        """Face (T, 103) + conv poses (S, Tb, 129) -> (S, T, 265): length-match
        the body to the face, splice jaw+conv+expression, part2full."""
        face_out = np.asarray(face_out, np.float32)
        T = face_out.shape[0]
        S, Tb, _ = conv.shape
        with span("assembly", samples=S, frames=T):
            jaw, exp = face_out[:, :3], face_out[:, 3:]
            if Tb < T:
                conv = np.concatenate([conv, np.repeat(conv[:, -1:], T - Tb, axis=1)], axis=1)
            else:
                conv = conv[:, :T]
            pred = np.concatenate([np.broadcast_to(jaw[None], (S, T, 3)), conv,
                                   np.broadcast_to(exp[None], (S, T, 100))], axis=-1)
            full = pose_ops.part2full(torch.as_tensor(pred.reshape(S * T, -1)), stand)
            return full.numpy().reshape(S, T, 265)


# ---------------------------------------------------------------------------
# the port's own weights file
# ---------------------------------------------------------------------------

def save_pipeline(pipe: Pipeline, path: str) -> None:
    """Write every weight of the pipeline (face and body stages, VQ states)
    to one `torch.save` file of state dicts, `load_converted`'s layout.
    (The JAX package writes an orbax tree, which the port does not read.)"""
    weights = {name: m.state_dict() for name, m in pipe._modules().items()}
    weights.update({k: getattr(pipe.body, k)._asdict() for k in _VQ_STATES})
    torch.save(weights, path)


def load_pipeline(path: str, template: Pipeline | None = None,
                  device="cuda") -> Pipeline:
    """Restore a file written by `save_pipeline`, or by
    `python -m talkshow_torch.convert_checkpoints` (any subset of its keys),
    into `template` (in place; default a full-size `Pipeline.create(0,
    device)`) and return it.  A file
    written before the face stage carried wav2vec's SpecAugment vector
    (`masked_spec_embed`, read only in training) gets the one
    `convert.reference_face` gives a checkpoint without it: zeros."""
    pipe = template if template is not None else Pipeline.create(0, device)
    weights = torch.load(path, map_location=pipe.device, weights_only=True)
    for k in _VQ_STATES:
        if k in weights:
            weights[k] = VQState(**weights[k])
    face = weights.get("face")
    if face is not None and convert.MASKED_SPEC_EMBED not in face:
        face[convert.MASKED_SPEC_EMBED] = convert.masked_spec_embed_default(face)
    return pipe.load_converted(weights)
