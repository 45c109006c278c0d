"""SHOW-dataset windowing and pose normalisation, host-side, numpy only.

Copies of talkshow_tpu/data/dataset.py:34-49,158-190,265-318: `Clip`,
`ShowDataset.train_windows` / `batches` / `whole_clips`,
`synthetic_dataset`, `compute_norm_stats`, `normalize_poses` and
`denormalize_poses`.  For the same seed the windows and batches equal the
JAX package's bit for bit (tests/test_torch_train.py).  Loading the real
SHOW layout (`ShowDataset.from_root`) waits until that dataset is in the
repository (ROADMAP.md).

Arrays are channels-last: poses (T, 165), expression (T, 100), aud_feat
(T, 64).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from talkshow_torch.ops.pose import SPEAKER_ID


@dataclass
class Clip:
    speaker: str
    poses: np.ndarray        # (T, 165) axis-angle
    expression: np.ndarray   # (T, 100)
    aud_feat: np.ndarray     # (T_a, F) mfcc, or (N, 1) raw wave
    betas: np.ndarray        # (300,)
    audio_path: str = ""


@dataclass
class ShowDataset:
    clips: list = field(default_factory=list)
    generate_length: int = 88
    pre_length: int = 0
    seed: int = 0

    def train_windows(self, rng: np.random.Generator):
        """Yield per-window samples: stride-6 start indices with the
        reference's 0/3-frame jitter (mesh_dataset.py:240-252,337-340)."""
        L = self.generate_length + self.pre_length
        for ci, clip in enumerate(self.clips):
            T = min(clip.poses.shape[0], clip.aud_feat.shape[0])
            for start in range(0, T - L, 6):
                s = start + rng.choice([0, 3])
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

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True):
        """Stacked numpy batches of train windows (drop ragged tail)."""
        samples = list(self.train_windows(rng))
        order = rng.permutation(len(samples)) if shuffle else np.arange(len(samples))
        for i in range(0, len(samples) - batch_size + 1, batch_size):
            group = [samples[j] for j in order[i:i + batch_size]]
            yield {k: np.stack([g[k] for g in group]) for k in group[0]}

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
