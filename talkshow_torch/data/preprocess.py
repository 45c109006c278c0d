"""Dataset preprocessing: the quality filter and the train / val / test split
(copy of talkshow_tpu/data/preprocess.py:1-117, a mirror of the reference's
data_utils/dataset_preprocess.py:46-169 and data_utils/apply_split.py).

A clip is kept when its wav reads (`ops/audio.load_wav`), its pose holds at
least MIN_FRAMES frames and every pose key is finite; the kept clips are
shuffled into 80 / 10 / 10 by `random.Random(seed)`, or assigned by a
published split.  For the same tree and seed the kept clips and the split
equal the JAX package's (tests/test_torch_train_show.py).
"""
from __future__ import annotations

import json
import os
import pickle
import random

import numpy as np

from talkshow_torch.ops.audio import load_wav

MIN_FRAMES = 90
POSE_KEYS = ("jaw_pose", "leye_pose", "reye_pose", "global_orient", "body_pose_axis",
             "left_hand_pose", "right_hand_pose", "expression")


def check_clip(pkl_path: str, wav_path: str) -> bool:
    """The quality gate (dataset_preprocess.py:104-137): a readable wav, at
    least MIN_FRAMES frames of body pose, every pose key finite."""
    try:
        load_wav(wav_path)
    except Exception:   # noqa: BLE001 -- any unreadable wav drops the clip
        return False
    try:
        with open(pkl_path, "rb") as f:
            data = pickle.load(f)
        if np.asarray(data["body_pose_axis"]).shape[0] < MIN_FRAMES:
            return False
        return all(np.isfinite(np.asarray(data[key])).all() for key in POSE_KEYS)
    except Exception:   # noqa: BLE001 -- a missing key or an unreadable pkl drops it
        return False


def scan_clips(data_root: str, speakers) -> list[tuple[str, str, str]]:
    """-> [(speaker, pkl_path, wav_path)] over every clip directory (one
    holding a .pkl and a .wav) under data_root/<speaker>, in os.walk order."""
    out = []
    for speaker in speakers:
        sp = os.path.join(data_root, speaker)
        if not os.path.isdir(sp):
            continue
        for dirpath, _, files in os.walk(sp):
            pkls = [f for f in files if f.endswith(".pkl")]
            wavs = [f for f in files if f.endswith(".wav")]
            if pkls and wavs:
                out.append((speaker, os.path.join(dirpath, pkls[0]),
                            os.path.join(dirpath, wavs[0])))
    return out


def random_split(clips: list, train: float = 0.8, val: float = 0.1,
                 seed: int = 0) -> dict[str, list]:
    """The seeded random 80 / 10 / 10 split (dataset_preprocess.py:141-169)."""
    rng = random.Random(seed)
    clips = list(clips)
    rng.shuffle(clips)
    n = len(clips)
    n_train, n_val = int(n * train), int(n * val)
    return {"train": clips[:n_train], "val": clips[n_train:n_train + n_val],
            "test": clips[n_train + n_val:]}


def load_published_split(pkl_path: str) -> dict[str, str]:
    """The reference's published split pkl ({speaker: {video: {split:
    [sequence path, ..]}}}, Windows-style paths; apply_split.py:10-27 moves
    the files) -> {clip directory basename: 'train' | 'val' | 'test'} for
    `apply_split`, no file moved."""
    with open(pkl_path, "rb") as f:
        nested = pickle.load(f)
    split_map: dict[str, str] = {}
    for vids in nested.values():
        for splits in vids.values():
            for split, seqs in splits.items():
                for seq in seqs:
                    split_map[os.path.basename(str(seq).replace("\\", "/"))] = split
    return split_map


def apply_split(clips: list, split_map: dict[str, str]) -> dict[str, list]:
    """Assign scanned clips by their directory basename (data_utils/
    apply_split.py); a clip the map does not name is left out."""
    out = {"train": [], "val": [], "test": []}
    for item in clips:
        split = split_map.get(os.path.basename(os.path.dirname(item[1])))
        if split in out:
            out[split].append(item)
    return out


def preprocess(data_root: str, speakers, out_json: str | None = None,
               seed: int = 0) -> dict[str, list]:
    """Scan, filter and split; with `out_json`, also write the split there
    ({split: [[speaker, pkl, wav], ..]})."""
    clips = [c for c in scan_clips(data_root, speakers) if check_clip(c[1], c[2])]
    splits = random_split(clips, seed=seed)
    if out_json:
        with open(out_json, "w") as f:
            json.dump({k: [list(c) for c in v] for k, v in splits.items()}, f)
    return splits
