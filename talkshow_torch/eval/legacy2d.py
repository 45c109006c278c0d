"""Legacy 2D-keypoint evaluation (Freeform-era suite): a numpy copy of
talkshow_tpu/eval/legacy2d.py, held equal to it by
tests/test_torch_eval.py.

Two halves:

* **Ingestion** — OpenPose-json loading and the `pose_dataset/` walk of the
  reference's `evaluation/util.py` (`get_gts`, `get_full_path`, `cvt25`,
  `hand_points`, `valid_points`, `smooth`), driven by
  `scripts/legacy_eval.py` which mirrors `evaluation/diversity_LVD.py`.
* **Metrics** — the math of evaluation/diversity_LVD.py, peak_velocity.py
  and mode_transition.py over (T, K, 2) keypoints.  Note the reference's
  `peak_velocity.py` and `mode_transition.py` import `velocity_consistency`
  / `mode_transition_seq` / `mode_transition_consistency` from
  `evaluation.metrics`, where they are NOT defined — those scripts are
  dead code upstream.  The equivalents here are working re-derivations of
  the intended measures, documented as such.
"""
from __future__ import annotations

import json
import os
from glob import glob

import numpy as np

#: OpenPose BODY_25 layout: first 25 pose points; 0 = nose, 1 = neck.
UPPER_BODY_POINTS = 25

#: pred layout (54 pts = 12 upper-body + 21 lhand + 21 rhand) -> gt 135-pt
#: layout slots, reference evaluation/util.py:89-108 (cvt25).
_PRED_BODY_SRC = slice(1, 8)        # pred points 1..7 -> gt points 1..7
_PRED_HANDS_SRC = 12                # pred points 12.. -> gt points 25..67


def load_openpose_clip(clip_dir: str):
    """OpenPose-json clip -> (unlocalized, localized, (scale, mean_pos)).

    Mirror of `get_gts` (reference evaluation/util.py:7-57): reads
    `keypoints_new/person_1/*.json` in sorted order; per frame stacks
    pose(25) + left-hand(21) + right-hand(21) + face keypoint (x, y)
    columns, keeps the 25 upper-body pose points plus everything after;
    localizes by subtracting the neck (point 1) and dividing by the mean
    neck-to-nose |y| offset.

    Returns unlocalized (T, K, 2), localized (T, K*2), and the
    (scale_factor, mean neck position) normalization constants.
    """
    files = sorted(glob(os.path.join(clip_dir, "keypoints_new", "person_1",
                                     "*.json")))
    if not files:
        raise FileNotFoundError(
            f"no OpenPose json under {clip_dir}/keypoints_new/person_1")
    poses, neck_to_nose, neck_xy = [], [], []
    for fp in files:
        with open(fp) as f:
            person = json.load(f)["people"][0]
        pose = np.asarray(person["pose_keypoints_2d"],
                          np.float64).reshape(-1, 3)
        parts = [person["hand_left_keypoints_2d"],
                 person["hand_right_keypoints_2d"],
                 person["face_keypoints_2d"]]
        rest = np.concatenate(
            [np.asarray(p, np.float64).reshape(-1, 3) for p in parts])
        neck, nose = pose[1], pose[0]
        neck_to_nose.append(abs(neck[1] - nose[1]))
        neck_xy.append(neck[:2])
        kps = np.concatenate([pose[:UPPER_BODY_POINTS], rest])[:, :2]
        poses.append(kps)
    scale = float(np.mean(neck_to_nose))
    if scale <= 0:
        raise ValueError(f"degenerate neck-to-nose scale in {clip_dir}")
    mean_pos = np.mean(np.asarray(neck_xy), axis=0)
    unlocalized = np.asarray(poses)
    localized = (unlocalized - unlocalized[:, 1:2]) / scale
    return unlocalized, localized.reshape(len(poses), -1), (scale, mean_pos)


def clip_path_for_wav(wav_path: str, speaker: str, split: str,
                      root: str = "pose_dataset/videos") -> str:
    """`<clip>_<vid>.wav` -> `<root>/<speaker>/clips/<vid>/images/half/
    <split>/<clip>` (reference evaluation/util.py:59-71)."""
    stem = os.path.splitext(os.path.basename(wav_path))[0]
    clip_name, vid_name = stem[:10], stem[11:]
    path = os.path.join(root, speaker, "clips", vid_name, "images", "half",
                        split, clip_name)
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    return path


def cvt25(pred: np.ndarray, gt: np.ndarray | None = None) -> np.ndarray:
    """Splice 108-D predictions (54 pts: 12 body + 2x21 hands) into the
    135-pt GT frame layout (reference evaluation/util.py:89-108): pred
    points 1..7 overwrite gt pose points 1..7 and pred points 12.. the
    42 hand points; all other gt points pass through.

    pred: (B, T, 108); gt: (1, T_gt, 270) or None (zeros).
    Returns (B, min(T, T_gt), 270).
    """
    pred = np.asarray(pred, np.float64)
    if gt is None:
        gt = np.zeros((1, pred.shape[1], 270))
    gt = np.repeat(np.asarray(gt, np.float64), pred.shape[0], axis=0)
    T = min(pred.shape[1], gt.shape[1])
    pred = pred[:, :T].reshape(pred.shape[0], T, -1, 2)
    out = gt[:, :T].reshape(gt.shape[0], T, -1, 2).copy()
    out[:, :, 1:8] = pred[:, :, _PRED_BODY_SRC]
    out[:, :, 25:25 + 42] = pred[:, :, _PRED_HANDS_SRC:]
    return out.reshape(out.shape[0], T, -1)


def hand_points(seq: np.ndarray) -> np.ndarray:
    """Arm + hand columns of a 135-pt sequence (util.py:110-117)."""
    idx = [1, 2, 3, 4, 5, 6, 7] + list(range(25, 25 + 42))
    seq = np.asarray(seq)
    seq = seq.reshape(seq.shape[0], seq.shape[1], -1, 2)
    return seq[:, :, idx].reshape(seq.shape[0], seq.shape[1], -1)


def valid_points(seq: np.ndarray) -> np.ndarray:
    """Arm + hand + head columns -> (B, T, 108) (util.py:119-128)."""
    idx = list(range(12)) + list(range(25, 25 + 42))
    seq = np.asarray(seq)
    seq = seq.reshape(seq.shape[0], seq.shape[1], -1, 2)
    out = seq[:, :, idx].reshape(seq.shape[0], seq.shape[1], -1)
    assert out.shape[-1] == 108, out.shape
    return out


def smooth_chunk_boundaries(res: np.ndarray, chunk: int = 25,
                            w_size: int = 7) -> np.ndarray:
    """Sliding-window smoothing of frames near generation-chunk boundaries
    (frames with t % chunk in {22, 23, 24, 0, 1, 2, 3}), mirror of
    `smooth` (util.py:73-87) — legacy models generated 25-frame chunks and
    seams were averaged over a 7-frame window."""
    res = np.asarray(res, np.float64).copy()
    boundary = {chunk - 3, chunk - 2, chunk - 1, 0, 1, 2, 3}
    for t in range(10, res.shape[1] - 3):
        if t % chunk in boundary:
            lo = max(t + 3 - w_size + 1, 0)
            res[:, t] = res[:, lo:t + 4].mean(axis=1)
    return res


def lvd_2d(gt_kps: np.ndarray, pr_kps: np.ndarray) -> float:
    """Velocity-difference on 2D keypoints (diversity_LVD.py semantics)."""
    T = min(gt_kps.shape[0], pr_kps.shape[0])
    gt_v = np.linalg.norm(np.diff(gt_kps[:T], axis=0), axis=-1)
    pr_v = np.linalg.norm(np.diff(pr_kps[:T], axis=0), axis=-1)
    return float(np.mean(np.abs(gt_v - pr_v).sum(-1)))


def diversity_2d(samples: np.ndarray) -> float:
    """Pairwise L1 over generated 2D-keypoint samples (B, T, K, 2)."""
    b = samples.shape[0]
    vals = [np.mean(np.abs(samples[i] - samples[j]))
            for i in range(b) for j in range(i + 1, b)]
    return float(np.mean(vals)) if vals else 0.0


def peak_velocity(kps: np.ndarray, order: int = 2) -> np.ndarray:
    """Per-joint local velocity maxima (peak_velocity.py): returns the mean
    of velocity peaks — a measure of gesture sharpness."""
    vel = np.linalg.norm(np.diff(kps, axis=0), axis=-1)   # (T-1, K)
    peaks = []
    for t in range(order, vel.shape[0] - order):
        window = vel[t - order:t + order + 1]
        is_peak = (vel[t] == window.max(axis=0)) & (vel[t] > 0)
        if is_peak.any():
            peaks.append(vel[t][is_peak].mean())
    return np.asarray(peaks)


def mode_transition_ratio(kps: np.ndarray, threshold: float | None = None) -> float:
    """Fraction of frames where motion switches between 'hold' and 'move'
    modes (mode_transition.py): velocity thresholded at its median by
    default; transitions = sign changes of the binarized velocity."""
    vel = np.linalg.norm(np.diff(kps, axis=0), axis=-1).mean(-1)  # (T-1,)
    thr = threshold if threshold is not None else float(np.median(vel))
    modes = vel > thr
    transitions = np.sum(modes[1:] != modes[:-1])
    return float(transitions) / max(len(modes) - 1, 1)


def velocity_consistency(peaks_a: np.ndarray,
                         peaks_b: np.ndarray) -> np.ndarray:
    """Per-peak agreement between two peak-velocity profiles, in percent.

    Re-derivation: the reference's peak_velocity.py calls an undefined
    `velocity_consistency` and histograms the result over [0, 100]
    (evaluation/peak_velocity.py:40-58).  Here: for each peak magnitude in
    `peaks_a`, the relative distance to the closest peak in `peaks_b`,
    clipped to [0, 100] — 0 = a matching peak exists, 100 = none close.
    """
    peaks_a = np.atleast_1d(np.asarray(peaks_a, np.float64))
    peaks_b = np.atleast_1d(np.asarray(peaks_b, np.float64))
    if peaks_a.size == 0:
        return np.zeros(0)
    if peaks_b.size == 0:
        return np.full(peaks_a.size, 100.0)
    d = np.abs(peaks_a[:, None] - peaks_b[None, :]).min(axis=1)
    return np.clip(100.0 * d / np.maximum(np.abs(peaks_a), 1e-8), 0, 100)


def mode_transition_seq(kps: np.ndarray, window: int = 10,
                        threshold: float | None = None) -> np.ndarray:
    """Binary move/hold mode per window -> (B, N).

    Re-derivation of the undefined `mode_transition_seq` the reference's
    mode_transition.py calls (evaluation/mode_transition.py:44-47): mean
    keypoint speed per non-overlapping `window`-frame block, thresholded
    (median across the clip by default) into move(1)/hold(0).

    kps: (B, T, D) flattened 2D keypoints.
    """
    kps = np.asarray(kps, np.float64)
    vel = np.abs(np.diff(kps, axis=1)).mean(-1)          # (B, T-1)
    n = vel.shape[1] // window
    if n == 0:
        raise ValueError(f"clip shorter than one window ({window} frames)")
    blocks = vel[:, :n * window].reshape(vel.shape[0], n, window).mean(-1)
    thr = float(np.median(blocks)) if threshold is None else threshold
    return (blocks > thr).astype(np.int32)


def mode_transition_consistency(pred_seq: np.ndarray, gt_seq: np.ndarray):
    """(precision, recall, accuracy) of predicted mode *transitions*
    against GT transitions (mode_transition.py:49-52 usage)."""
    pred_tr = pred_seq[:, 1:] != pred_seq[:, :-1]
    gt_tr = gt_seq[:, 1:] != gt_seq[:, :-1]
    # a (1, N) GT row against (B, N) predicted samples: count the GT
    # transitions once PER SAMPLE, else tp (which broadcasts in the &)
    # outgrows the recall denominator and recall exceeds 1
    gt_tr = np.broadcast_to(gt_tr, pred_tr.shape)
    tp = float(np.sum(pred_tr & gt_tr))
    precision = tp / max(float(np.sum(pred_tr)), 1.0)
    recall = tp / max(float(np.sum(gt_tr)), 1.0)
    accuracy = float(np.mean(pred_tr == gt_tr))
    return precision, recall, accuracy


def select_quality_samples(kps: np.ndarray, window: int = 60,
                           vel_lo: float = 20.0, vel_hi: float = 80.0,
                           stride: int = 30) -> list[tuple[int, int]]:
    """Extract 'quality' sample windows (get_quality_samples.py semantics):
    windows whose mean keypoint velocity falls between the lo/hi
    percentiles of the clip — i.e. neither frozen nor erratic.

    kps: (T, K, D). Returns [(start, end)] window indices."""
    vel = np.linalg.norm(np.diff(kps, axis=0), axis=-1).mean(-1)  # (T-1,)
    out = []
    if len(vel) < window:
        return out
    means = np.asarray([vel[s:s + window].mean()
                        for s in range(0, len(vel) - window + 1, stride)])
    lo, hi = np.percentile(means, vel_lo), np.percentile(means, vel_hi)
    for i, s in enumerate(range(0, len(vel) - window + 1, stride)):
        if lo <= means[i] <= hi:
            out.append((s, s + window))
    return out
