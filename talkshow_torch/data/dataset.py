"""SHOW-dataset loading, windowing and pose normalisation, host-side.

Copies of talkshow_tpu/data/dataset.py:34-318: `Clip`,
`ShowDataset.from_root` / `load_clip` / `train_windows` / `batches` /
`face_batches` / `whole_clips`, `synthetic_dataset`, `compute_norm_stats`,
`normalize_poses` and `denormalize_poses`; and `synthetic_face_dataset`,
the raw-waveform clips that scripts/train.py:79-99 makes for the face
stage.  For the same seed the windows and batches equal the JAX package's
bit for bit (tests/test_torch_train.py, tests/test_torch_train_face.py).

`from_root` walks `data_root/<speaker>/<video>/<split>/<clip>/` for a
`<clip>.pkl` (SMPL-X parameters) and a `<clip>.wav`, as the JAX loader:
99-D packed pose -> hand PCA expanded -> 165-D (-> 330-D 6-D with
`convert_to_6d`), expression, betas, and the audio feature, computed once
per clip: the MFCC of `ops/audio.get_mfcc` on `device` (the JAX loader's
native C++ featurizer is not ported) or the raw 16 kHz waveform.  The
preprocessed split may be pickled to `cache_pkl`, keyed by the JAX
loader's signature of the clip tree and the featurization; a cache the
JAX package wrote (its `Clip` class) reads as stale and is rebuilt.

Arrays are channels-last: poses (T, 165), expression (T, 100), aud_feat
(T, 64), or (N, 1) raw 16 kHz samples for the face stage.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from talkshow_torch.ops import audio as audio_ops
from talkshow_torch.ops.pose import SPEAKER_ID, axis_angle_poses_to_6d, hand_pca_to_full


@dataclass
class Clip:
    speaker: str
    poses: np.ndarray        # (T, 165) axis-angle
    expression: np.ndarray   # (T, 100)
    aud_feat: np.ndarray     # (T_a, F) mfcc, or (N, 1) raw wave
    betas: np.ndarray        # (300,)
    audio_path: str = ""


#: training windows start every STRIDE frames, each moved by 0 or JITTER
#: frames per epoch (mesh_dataset.py:240-252,337-340)
STRIDE, JITTER = 6, 3


@dataclass
class ShowDataset:
    clips: list = field(default_factory=list)
    generate_length: int = 88
    pre_length: int = 0
    seed: int = 0

    @classmethod
    def from_root(cls, data_root: str, speakers, split: str = "train", feat: str = "mfcc",
                  cache_pkl: str | None = None, generate_length: int = 88, fps: int = 30,
                  audio_sr: int = 22000, limit: int | None = None,
                  convert_to_6d: bool = False, device="cuda") -> "ShowDataset":
        """Walk the SHOW layout and preprocess every clip of `split` (eight
        threads).  The pickle cache is keyed by a signature of the clip tree
        found and the featurization, so a grown split or another feature
        rebuilds it."""
        jobs = []
        for speaker in speakers:
            sp_dir = os.path.join(data_root, speaker)
            if not os.path.isdir(sp_dir):
                continue
            for vid in sorted(os.listdir(sp_dir)):
                split_dir = os.path.join(sp_dir, vid, split)
                if not os.path.isdir(split_dir):
                    continue
                for clip_name in sorted(os.listdir(split_dir)):
                    cdir = os.path.join(split_dir, clip_name)
                    pkls = [f for f in os.listdir(cdir) if f.endswith(".pkl")]
                    wavs = [f for f in os.listdir(cdir) if f.endswith(".wav")]
                    if pkls and wavs:
                        jobs.append((speaker, os.path.join(cdir, pkls[0]),
                                     os.path.join(cdir, wavs[0])))
        if limit:
            jobs = jobs[:limit]

        sig = hashlib.sha1(repr((sorted(j[1] for j in jobs), feat, fps, audio_sr,
                                 convert_to_6d)).encode()).hexdigest()
        if cache_pkl and os.path.isfile(cache_pkl):
            cached = _load_cache(cache_pkl)
            if isinstance(cached, dict) and cached.get("sig") == sig:
                return cls(cached["clips"], generate_length)
            print(f"[dataset] cache {cache_pkl} is stale (tree/featurization changed, or "
                  "not written by this package) — rebuilding")

        with ThreadPoolExecutor(max_workers=min(8, max(1, len(jobs)))) as ex:
            clips = list(ex.map(
                lambda j: cls.load_clip(j[1], j[2], j[0], feat=feat, fps=fps,
                                        audio_sr=audio_sr, convert_to_6d=convert_to_6d,
                                        device=device), jobs))
        clips = [c for c in clips if c is not None]
        if cache_pkl:
            with open(cache_pkl, "wb") as f:
                pickle.dump({"sig": sig, "clips": clips}, f)
        return cls(clips, generate_length)

    @staticmethod
    def load_clip(pkl_path: str, wav_path: str, speaker: str, feat: str = "mfcc",
                  fps: int = 30, audio_sr: int = 22000, convert_to_6d: bool = False,
                  device="cuda") -> Clip | None:
        """One clip's pkl + wav -> Clip (mesh_dataset._load_them_all
        :166-222), or None when the pkl lacks a key or holds a non-finite
        or mis-sized pose."""
        with open(pkl_path, "rb") as f:
            data = pickle.load(f)
        try:
            jaw = np.asarray(data["jaw_pose"])
            leye = np.asarray(data["leye_pose"])
            reye = np.asarray(data["reye_pose"])
            orient = np.asarray(data["global_orient"]).squeeze()
            body = np.asarray(data["body_pose_axis"])
            lh = np.asarray(data["left_hand_pose"])
            rh = np.asarray(data["right_hand_pose"])
            expression = np.asarray(data["expression"])
            betas = np.asarray(data["betas"]).reshape(-1)
        except KeyError:
            return None
        packed = np.concatenate([jaw, leye, reye, orient.reshape(len(jaw), 3),
                                 body, lh[:, :12], rh[:, :12]], axis=1)
        if packed.shape[1] != 99 or not np.isfinite(packed).all():
            return None
        poses = hand_pca_to_full(packed).astype(np.float32)
        if convert_to_6d:
            poses = axis_angle_poses_to_6d(torch.as_tensor(poses, device=device)).cpu().numpy()
        if feat == "mfcc":
            with torch.no_grad():
                aud = audio_ops.get_mfcc(wav_path, sr=audio_sr, fps=fps,
                                         device=device).cpu().numpy()
        elif feat == "raw":
            aud = audio_ops.get_raw_16k(wav_path)
        else:
            raise ValueError(feat)
        return Clip(speaker, poses, expression.astype(np.float32),
                    np.asarray(aud, np.float32), betas.astype(np.float32), wav_path)

    def train_windows(self, rng: np.random.Generator):
        """Yield per-window samples: stride-6 start indices with the
        reference's 0/3-frame jitter (mesh_dataset.py:240-252,337-340)."""
        L = self.generate_length + self.pre_length
        for ci, clip in enumerate(self.clips):
            T = min(clip.poses.shape[0], clip.aud_feat.shape[0])
            for start in range(0, T - L, STRIDE):
                s = start + rng.choice([0, JITTER])
                if s + L > clip.poses.shape[0]:
                    s = start
                aud = clip.aud_feat[s:s + L]
                if aud.shape[0] < L:
                    aud = np.pad(aud, [[0, L - aud.shape[0]], [0, 0]], mode="reflect")
                yield {
                    "poses": clip.poses[s:s + L],
                    "expression": clip.expression[s:s + L],
                    "aud_feat": aud,
                    "speaker": np.int32(SPEAKER_ID[clip.speaker] - 20),
                    "betas": clip.betas,
                    # identifies the window for trainer-side caches; popped
                    # before the train step
                    "window_key": np.asarray([ci, s], np.int64),
                }

    def window_keys(self) -> list:
        """Every (clip, start) `train_windows` can give, in any epoch: each
        stride slot at offset 0, and at JITTER where the window fits."""
        L = self.generate_length + self.pre_length
        keys = []
        for ci, clip in enumerate(self.clips):
            T = min(clip.poses.shape[0], clip.aud_feat.shape[0])
            for start in range(0, T - L, STRIDE):
                keys.append((ci, start))
                if start + JITTER + L <= clip.poses.shape[0]:
                    keys.append((ci, start + JITTER))
        return keys

    def window_poses(self, key) -> np.ndarray:
        """(L, 165) poses of the training window key = (clip, start)."""
        ci, s = key
        return self.clips[ci].poses[s:s + self.generate_length + self.pre_length]

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True):
        """Stacked numpy batches of train windows (drop ragged tail)."""
        samples = list(self.train_windows(rng))
        order = rng.permutation(len(samples)) if shuffle else np.arange(len(samples))
        for i in range(0, len(samples) - batch_size + 1, batch_size):
            group = [samples[j] for j in order[i:i + batch_size]]
            yield {k: np.stack([g[k] for g in group]) for k in group[0]}

    def face_batches(self, num_classes: int = 4, bucket_frames: int = 0, batch_size: int = 1):
        """Whole-clip batches for face training (raw 16 kHz clips, aud_feat
        (N, 1)): {'waveform' (B, N), 'id_onehot' (B, C), 'gt' (B, T, 265)}.
        Without bucket_frames, one clip a batch.  With it, frame counts
        (and the audio's length) round up to a multiple of bucket_frames,
        clips of one bucket are grouped into batches of up to batch_size,
        padded with zeros, and the batches carry 'valid_samples' and
        'valid_frames' (B,) int32."""
        def onehot_for(clip):
            onehot = np.zeros((num_classes,), np.float32)
            onehot[SPEAKER_ID[clip.speaker] - 20] = 1.0
            return onehot

        for clip in self.clips:
            if clip.aud_feat.shape[-1] != 1:
                raise ValueError("face_batches needs raw-waveform clips (aud_feat (N, 1))")

        if not bucket_frames:
            for clip in self.clips:
                gt = np.concatenate([clip.poses, clip.expression], axis=-1)[None]
                yield {"waveform": clip.aud_feat.reshape(1, -1),
                       "id_onehot": onehot_for(clip)[None],
                       "gt": gt.astype(np.float32)}
            return

        # samples per frame rounded up, so padded buffers always fit; the
        # bucket also covers the audio's own length
        spf = -(-16000 // 30)
        buckets: dict[int, list] = {}
        for clip in self.clips:
            t = clip.poses.shape[0]
            t_aud = -(-clip.aud_feat.shape[0] // spf)
            tb = -(-max(t, t_aud) // bucket_frames) * bucket_frames
            buckets.setdefault(tb, []).append(clip)
        for tb in sorted(buckets):
            group = buckets[tb]
            nb = tb * spf
            for i in range(0, len(group), batch_size):
                chunk = group[i:i + batch_size]
                B = len(chunk)
                wav = np.zeros((B, nb), np.float32)
                gt = np.zeros((B, tb, chunk[0].poses.shape[1] + chunk[0].expression.shape[1]),
                              np.float32)
                vs = np.zeros((B,), np.int32)
                vf = np.zeros((B,), np.int32)
                ids = np.zeros((B, num_classes), np.float32)
                for j, clip in enumerate(chunk):
                    n = min(clip.aud_feat.shape[0], nb)
                    t = clip.poses.shape[0]
                    wav[j, :n] = clip.aud_feat.reshape(-1)[:n]
                    gt[j, :t] = np.concatenate([clip.poses, clip.expression], axis=-1)
                    vs[j], vf[j] = n, t
                    ids[j] = onehot_for(clip)
                yield {"waveform": wav, "id_onehot": ids, "gt": gt,
                       "valid_samples": vs, "valid_frames": vf}

    def whole_clips(self):
        """Eval mode: full clips (mesh_dataset.py:246-248)."""
        for clip in self.clips:
            yield {
                "poses": clip.poses,
                "expression": clip.expression,
                "aud_feat": clip.aud_feat,
                "speaker": np.int32(SPEAKER_ID[clip.speaker] - 20),
                "betas": clip.betas,
                "audio_path": clip.audio_path,
            }


class _CacheUnpickler(pickle.Unpickler):
    """Reads this package's classes and numpy's only: a cache another
    package wrote (the JAX loader pickles its own `Clip`) is refused before
    anything of that package is imported."""
    ALLOWED = ("talkshow_torch", "numpy")

    def find_class(self, module, name):
        if module.split(".")[0] not in self.ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not a class of this cache")
        return super().find_class(module, name)


def _load_cache(path: str):
    with open(path, "rb") as f:
        try:
            return _CacheUnpickler(f).load()
        except pickle.UnpicklingError:
            return None


def synthetic_dataset(num_clips: int = 4, frames: int = 240, seed: int = 0,
                      speakers=("oliver", "chemistry")) -> ShowDataset:
    """Random dataset with the real layout: for tests and smoke training."""
    rng = np.random.default_rng(seed)
    clips = []
    for i in range(num_clips):
        t = frames + int(rng.integers(0, 30))
        clips.append(Clip(
            speaker=speakers[i % len(speakers)],
            poses=rng.standard_normal((t, 165)).astype(np.float32) * 0.2,
            expression=rng.standard_normal((t, 100)).astype(np.float32) * 0.3,
            aud_feat=rng.standard_normal((t, 64)).astype(np.float32),
            betas=np.zeros(300, np.float32),
        ))
    return ShowDataset(clips)


def synthetic_face_dataset(num_clips: int = 4, frames: int = 240, bucketed: bool = False,
                           seed: int = 0) -> ShowDataset:
    """`synthetic_dataset` with raw-waveform audio for the face stage, as
    scripts/train.py:79-99 makes it: without bucketing every clip is cut
    to the shortest one's frames (one program shape for whole clips); with
    it clip i loses 7 i frames (lengths a bucket must absorb).  The audio
    is frames * 16000 // 30 standard-normal samples from
    np.random.default_rng(0)."""
    ds = synthetic_dataset(num_clips=num_clips, frames=frames, seed=seed)
    rng0 = np.random.default_rng(0)
    tmin = min(c.poses.shape[0] for c in ds.clips)
    for i, c in enumerate(ds.clips):
        t = c.poses.shape[0] - 7 * i if bucketed else tmin
        c.poses, c.expression = c.poses[:t], c.expression[:t]
        c.aud_feat = rng0.standard_normal((t * 16000 // 30, 1)).astype(np.float32)
    return ds


def compute_norm_stats(dataset: ShowDataset) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel mean/std over all clips' poses (norm_method='all',
    mesh_dataset.py:280-283)."""
    allp = np.concatenate([c.poses for c in dataset.clips], axis=0)
    mean = allp.mean(axis=0)
    std = allp.std(axis=0)
    std = np.where(std < 1e-6, 1.0, std)
    return mean.astype(np.float32), std.astype(np.float32)


def normalize_poses(poses: np.ndarray, stats) -> np.ndarray:
    mean, std = stats
    return (poses - mean) / std


def denormalize_poses(poses: np.ndarray, stats) -> np.ndarray:
    """nets/utils.denormalize equivalent."""
    mean, std = stats
    return poses * std + mean
