"""Bucketed batch serving over the pipeline (port of
talkshow_tpu/serving.py:62-316).

Requests are padded to multiples of `bucket_frames`, grouped by bucket and
served `max_batch` at a time, one pass over the whole group per (bucket,
group): int16 PCM dequantized on the device, the length-masked face stage
(on the card the plain masked extractor and K2 with its frame mask, as the
JAX package runs it; a WavLM face runs K3, whose per-frame LayerNorm needs
no mask), the 16 -> 22 kHz resample and MFCC of every row at
once, ONE AR decode of the group (K1 at B = max_batch), denormalization,
length matching and `part2full`.  A partial group runs at max_batch with
zero rows, so traffic only ever meets (bucket, max_batch) shapes, and
`warmup()` runs each of them once (it builds the kernels and packs the
tables).  The AR decode is causal, so padded tail rows cannot change real
frames; the masked face stage keeps every real frame equal to the
unpadded clip's.

Determinism: a group samples with one noise draw, so a request's tokens
depend on its place in the batch; `flush(seed=...)` with the same queue
reproduces.  A CUDA graph per (bucket, batch) is not built: the decode's
Philox seed is read on the host per call and would be frozen into a graph.

`mesh` (a `parallel.mesh.Mesh`, JAX serving.py:65-66,104-108,154-166):
each group's rows split over the devices of `mesh_axis`; every shard runs
the whole group pass on its rows on its own device (the masked face stage,
MFCC, one AR decode, assembly), on the pipeline's copy there
(`Pipeline.replica`), and the rows are read back in request order.
`max_batch` must be a multiple of the axis size.

Usage:
    server = MotionServer(pipe, bucket_frames=32, max_batch=8)
    server.warmup(max_clip_seconds=12)
    rid = server.submit(wav16k, speaker=0)
    motions = server.flush()         # {rid: (T, 265) float32}
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from talkshow_torch.models.body import generate_conv_poses
from talkshow_torch.ops import audio as audio_ops
from talkshow_torch.ops import pose as pose_ops
from talkshow_torch.pipeline import _round_up

#: 16 kHz samples per 30 fps frame, rounded up (a row buffer always fits)
_SPF = -(-16000 // 30)


def group_seed(*key: int) -> int:
    """A 63-bit seed mixed from a tuple of ints (numpy's SeedSequence)."""
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class _Request:
    rid: int
    wav16: np.ndarray       # (N,) int16 or float32 @ 16 kHz
    speaker: int
    frames: int             # true output frames (N * 30 // 16000)
    bucket: int             # padded frame count


@dataclass
class MotionServer:
    """Bucketed batch server over a `Pipeline` (speech -> (T, 265)).

    Bandwidth note: requests carry 16 kHz audio, and the body MFCCs are
    computed from a 16->22 kHz sinc upsample, so spectral content above
    8 kHz is absent.  `Pipeline.generate` loads the wav natively at
    22 kHz; the same clip therefore yields slightly different body
    features on the serving path.  Parity-critical callers should use
    the offline path (or submit audio captured at >=22 kHz downsampled
    to 16 kHz, where the difference is only the 8-11 kHz band — far
    above the speech energy that drives the MFCC features).

    transfer_dtype: "int16" (default) holds and uploads PCM samples and
    dequantizes them on the device (half the bytes of f32; float input is
    rounded to the int16 grid), "float32" keeps the submitted samples.

    noise: for parity with the JAX server, a callable
    (base, bucket, index, rows) -> gumbel block (rows, 2, max_batch, K)
    for the group starting at `index` of `bucket`'s requests, where base is
    the flush's seed or counter (on a mesh, shard i decodes with its rows'
    slice of the block); None draws from
    torch.Generator(group_seed(base, bucket, index)), on a mesh shard i's
    from torch.Generator(group_seed(base, bucket, index, i)) (Philox on the
    card).

    mesh / mesh_axis: shard each group's rows over the axis' devices (see
    the module docstring).
    """
    pipe: object
    bucket_frames: int = 32
    max_batch: int = 8
    stand: bool = False
    transfer_dtype: str = "int16"
    noise: Callable | None = None
    mesh: Any = None
    mesh_axis: str = "dp"
    _queue: list = field(default_factory=list)
    _next_id: int = 0
    _flush_count: int = 0

    def __post_init__(self):
        if self.transfer_dtype not in ("int16", "float32"):
            raise ValueError(f"transfer_dtype must be 'int16' or 'float32', "
                             f"got {self.transfer_dtype!r}")
        if self.mesh is not None:
            n = self.mesh.shape[self.mesh_axis]
            if self.max_batch % n:
                raise ValueError(f"max_batch={self.max_batch} not divisible by mesh axis "
                                 f"'{self.mesh_axis}' size {n}")

    # ------------------------------------------------------------------
    def submit(self, wav16: np.ndarray, speaker: int = 0) -> int:
        """Queue one request; returns its id (resolved by `flush`).

        Accepts float32 samples in [-1, 1] or int16 PCM."""
        wav16 = np.asarray(wav16).reshape(-1)
        if self.transfer_dtype == "int16":
            if wav16.dtype != np.int16:
                wav16 = np.clip(np.round(wav16.astype(np.float32) * 32768.0),
                                -32768, 32767).astype(np.int16)
        else:
            wav16 = (wav16.astype(np.float32) / 32768.0 if wav16.dtype == np.int16
                     else wav16.astype(np.float32))
        frames = int(len(wav16) * 30 // 16000)
        if frames < 1:
            raise ValueError("audio shorter than one frame")
        bucket = _round_up(frames, self.bucket_frames)
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Request(rid, wav16, speaker, frames, bucket))
        return rid

    def pending(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------------
    def warmup(self, max_clip_seconds: float = 12.0) -> int:
        """Run the group pass once for every bucket a clip of up to
        `max_clip_seconds` can land in (a clip near the limit rounds UP to
        the next bucket), at max_batch; returns the number of buckets."""
        top = _round_up(int(max_clip_seconds * 30) + 1, self.bucket_frames)
        n = 0
        for frames in range(self.bucket_frames, top + 1, self.bucket_frames):
            for part in self._run_group(frames, self.max_batch, None):
                part.cpu()
            n += 1
        return n

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _run_group(self, bucket: int, B: int, requests, base: int = 0,
                   index: int = 0) -> list:
        """Launch the pass over a (bucket, B) group, one per shard on a
        mesh; returns the motion of each shard's rows ((B / shards, bucket,
        265) each, in row order) on its device without waiting for it.
        With requests=None the rows are zeros (warmup)."""
        pipe = self.pipe
        # +1 frame of slack: a wav whose floor(len*30/16000) == bucket can
        # still hold up to ~_SPF more samples than bucket*_SPF
        nb = (bucket + 1) * _SPF
        wav = np.zeros((B, nb), np.int16 if self.transfer_dtype == "int16" else np.float32)
        ids = np.zeros((B,), np.int64)
        vs = np.full((B,), nb, np.int32)
        vf = np.full((B,), bucket, np.int32)
        for j, r in enumerate(requests or ()):
            n = len(r.wav16)
            wav[j, :n] = r.wav16
            ids[j] = r.speaker
            vs[j], vf[j] = n, r.frames
        if self.mesh is None:
            shards = [(pipe, slice(0, B), (base, bucket, index))]
        else:
            devices = self.mesh.axis_devices(self.mesh_axis)
            b = B // len(devices)
            shards = [(pipe.replica(dev), slice(i * b, (i + 1) * b), (base, bucket, index, i))
                      for i, dev in enumerate(devices)]
        # one noise block a group (its rows sliced per shard)
        block = functools.cache(lambda h: self.noise(base, bucket, index, h))
        return [self._pass(shard, bucket, wav[rows], ids[rows], vs[rows], vf[rows],
                           None if self.noise is None else (lambda h, r=rows: block(h)[:, :, r]),
                           group_seed(*key))
                for shard, rows, key in shards]

    def _pass(self, pipe, bucket: int, wav, ids, vs, vf, noise, seed: int) -> torch.Tensor:
        """The whole group pass over these rows on the pipeline's device:
        the masked face stage, MFCC, one AR decode (noise(rows) -> its
        gumbel block, or a generator seeded `seed`), denormalization,
        length matching and part2full -> (rows, bucket, 265)."""
        dev = pipe.device
        B = wav.shape[0]
        wav = torch.as_tensor(wav).to(dev)
        if wav.dtype == torch.int16:            # PCM transfer: dequantize here
            wav = wav.float() * (1.0 / 32768.0)
        vs, vf = torch.as_tensor(vs).to(dev), torch.as_tensor(vf).to(dev)
        # demo face path uses a zero one-hot id (smplx_face.py:205)
        onehot = torch.zeros((B, pipe.num_classes), device=dev)
        face = pipe.face_stage(wav, onehot, bucket, valid_samples=vs, valid_frames=vf)

        feat = audio_ops.mfcc(audio_ops.resample(wav, 16000, 22000), 22000, fps=30)
        Tp = _round_up(max(feat.shape[1], 4), 4)
        feat = torch.nn.functional.pad(feat, (0, 0, 0, Tp - feat.shape[1]))
        if noise is not None:
            noise, gen = noise(Tp // 4).to(dev, torch.float32).contiguous(), None
        else:
            gen = torch.Generator().manual_seed(seed)
        conv, _ = generate_conv_poses(pipe.body, feat, torch.as_tensor(ids).to(dev),
                                      generator=gen, noise=noise, tables=pipe._decode_tables)
        norm = pipe.conv_norm()
        if norm is not None:
            conv = conv * torch.as_tensor(norm[1], device=dev) + torch.as_tensor(norm[0],
                                                                                 device=dev)
        # length-match the body to the face bucket (demo.py:207-211)
        Tb = conv.shape[1]
        if Tb < bucket:
            conv = torch.cat([conv, conv[:, -1:].expand(-1, bucket - Tb, -1)], dim=1)
        else:
            conv = conv[:, :bucket]
        pred = torch.cat([face[..., :3], conv, face[..., 3:]], dim=-1)
        return pose_ops.part2full(pred.reshape(B * bucket, -1), self.stand).reshape(
            B, bucket, 265)

    # ------------------------------------------------------------------
    def flush(self, seed: int | None = None) -> dict[int, np.ndarray]:
        """Serve every queued request; returns {rid: (T, 265)}.

        seed=None (default) mixes an internal flush counter into the noise
        so repeated flushes sample fresh noise; a seed reproduces (same
        seed + same queue -> same motion).  Every group is launched first
        (the device works on group N while the host packs group N+1), then
        all are read back.  Requests leave the queue only after their
        group's readback succeeds, so a failure mid-flush keeps the
        unserved remainder queued for retry."""
        groups: dict[int, list] = {}
        for r in self._queue:
            groups.setdefault(r.bucket, []).append(r)
        base = self._flush_count if seed is None else seed
        self._flush_count += 1
        launched: list = []
        err: Exception | None = None
        for bucket in sorted(groups):
            reqs = groups[bucket]
            for i in range(0, len(reqs), self.max_batch):
                chunk = reqs[i:i + self.max_batch]
                try:
                    fut = self._run_group(bucket, self.max_batch, chunk, base, i)
                except Exception as e:         # keep the groups already launched
                    err = e
                    break
                launched.append((chunk, fut))
            if err is not None:
                break

        out: dict[int, np.ndarray] = {}
        for chunk, fut in launched:
            full = torch.cat([part.cpu() for part in fut]).numpy()   # readback (synchronizes)
            served = set()
            for j, r in enumerate(chunk):
                out[r.rid] = full[j, :r.frames]
                served.add(r.rid)
            self._queue = [q for q in self._queue if q.rid not in served]
        if err is not None:
            raise err
        return out
