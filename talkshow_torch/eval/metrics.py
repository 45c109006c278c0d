"""Motion metrics: LVD, diversity, beat consistency, MAAC, and the clip
bootstrap (port of talkshow_tpu/eval/metrics.py, mirrors of the
reference's evaluation/metrics.py and the joint-space metrics of
evaluation/FGD.py: BC :79-114, MAAC :65-77).

`lvd` and `batch_lvd` take tensors and run on their device (joints or
vertices from `ops/smplx_lbs.py`); the rest are the JAX module's numpy
code, copied.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from talkshow_torch.ops.pose import CHANGE_ANGLE

# LVD joint subset (evaluation/metrics.py rearrange/symmetry, lower_body.py:136-143)
REARRANGE = list(range(22))
SYMMETRY = np.asarray([0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1,
                       1, 1, 1, 1], bool)


def lvd(gt_kps: torch.Tensor, pr_kps: torch.Tensor) -> torch.Tensor:
    """Landmark velocity difference (evaluation/metrics.py:79-94): gt, pr
    (T, J, 3) -> 0-dim tensor."""
    gt_v = torch.linalg.norm(gt_kps[1:] - gt_kps[:-1], dim=-1)
    pr_v = torch.linalg.norm(pr_kps[1:] - pr_kps[:-1], dim=-1)
    return (pr_v - gt_v).abs().sum(-1).mean()


def batch_lvd(gt_kps: torch.Tensor, pr_kps: torch.Tensor,
              symmetrical: bool = False) -> torch.Tensor:
    """Batched LVD (evaluation/metrics.py:26-76): gt (T, J, 3), pr
    (B, T, J, 3).  With symmetrical=True a left/right joint pair counts
    only the side whose pairs move more in that frame (the reference's
    move_side, as the JAX code computes it)."""
    T = min(gt_kps.shape[0], pr_kps.shape[1])
    gt_kps, pr_kps = gt_kps[:T], pr_kps[:, :T]
    if not symmetrical:
        gt_v = torch.linalg.norm(gt_kps[1:] - gt_kps[:-1], dim=-1)
        pr_v = torch.linalg.norm(pr_kps[:, 1:] - pr_kps[:, :-1], dim=-1)
        w = 1.0 / gt_v.shape[0]
        return ((pr_v - gt_v[None]).abs().sum(-1) * w).sum(-1).mean()

    sym = torch.as_tensor(SYMMETRY, device=gt_kps.device)

    def side_vel(x, axis):
        d = torch.linalg.norm(torch.diff(x, dim=axis), dim=-1)
        ys = x[..., sym, :]
        ys = ys.reshape(ys.shape[:-2] + (-1, 2, 3))
        ys_v = torch.linalg.norm(torch.diff(ys, dim=axis), dim=-1)
        left, right = ys_v[..., 0].sum(-1), ys_v[..., 1].sum(-1)
        side = (left > right).unsqueeze(-1)
        return torch.cat([d[..., ~sym], torch.where(side, ys_v[..., 0], ys_v[..., 1])], dim=-1)

    gt_v = side_vel(gt_kps[:, REARRANGE], 0)
    pr_v = side_vel(pr_kps[:, :, REARRANGE], 1)
    w = 1.0 / gt_v.shape[0]
    return ((pr_v - gt_v[None]).abs().sum(-1) * w).sum(-1).mean()


def clip_ci(vals, n_boot: int = 200, seed: int = 0, return_draws: bool = False) -> dict:
    """Bootstrap CI of a per-clip scalar metric's mean (clips are the
    independent unit).  `return_draws` adds the bootstrap means under
    "draws", so that `paired_clip_gap` reads the same resamples."""
    vals = np.asarray(vals, dtype=float)
    if vals.size < 2:
        raise ValueError("clip_ci needs >= 2 per-clip values")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, vals.size, size=(n_boot, vals.size))
    draws = vals[idx].mean(axis=1)
    lo, hi = np.percentile(draws, [2.5, 97.5])
    out = {"mean": float(draws.mean()), "std": float(draws.std()),
           "p2_5": float(lo), "p97_5": float(hi),
           "n_boot": n_boot, "n_clips": int(vals.size)}
    if return_draws:
        out["draws"] = draws
    return out


def paired_clip_gap(vals_a, vals_b, n_boot: int = 200, seed: int = 0) -> dict:
    """Paired bootstrap of the gap between two arms' per-clip values on the
    SAME clips in the same order: the per-clip differences are resampled,
    so the shared clip difficulty cancels."""
    vals_a, vals_b = np.asarray(vals_a, float), np.asarray(vals_b, float)
    if vals_a.shape != vals_b.shape:
        raise ValueError(f"arms differ in clip count: {vals_a.shape} vs "
                         f"{vals_b.shape} — not the same clip walk")
    diff = vals_a - vals_b
    out = clip_ci(diff, n_boot=n_boot, seed=seed, return_draws=True)
    draws = out.pop("draws")
    out["frac_a_lt_b"] = float(np.mean(draws < 0))
    out["clip_win_rate_a"] = float(np.mean(diff < 0))
    return out


def diversity(samples: np.ndarray) -> float:
    """Mean pairwise L1 between samples (B, T, D) (evaluation/metrics.py:96-109)."""
    b = samples.shape[0]
    dists = []
    for i in range(b):
        for j in range(i + 1, b):
            dists.append(np.mean(np.abs(samples[i] - samples[j])))
    return float(np.mean(dists)) if dists else 0.0


def _wrist_angle_velocity(joints: np.ndarray) -> np.ndarray:
    """Arm-angle angular velocity of the reference's BC / MAAC (FGD.py:84-95)."""
    j = np.array(joints, copy=True)
    j[:, 15:21] = j[:, 16:22]
    vec = j[:, 15:21] - j[:, 13:19]
    inner = np.einsum("kij,kij->ki", vec[:, 2:], vec[:, :-2])
    inner = np.clip(inner, -1.0, 1.0)
    angle = np.arccos(inner) / math.pi
    return np.abs(angle[1:] - angle[:-1])        # (T-1, 4)


def maac(joints_list: list[np.ndarray]) -> np.ndarray:
    """Mean absolute angle change (FGD.py:65-77)."""
    vels = [np.mean(_wrist_angle_velocity(j), axis=0) for j in joints_list]
    return np.mean(np.stack(vels), axis=0)


def beat_consistency(joints_list: list[np.ndarray], audio_beats_list: list[np.ndarray],
                     thres: float = 0.01, sigma: float = 0.1) -> float:
    """Beat consistency (FGD.py:79-114): motion beats are local minima of
    the normalized arm angular velocity; the score is the mean gaussian
    proximity of each audio onset to its nearest motion beat."""
    sum_1 = 0.0
    total_beat = 0
    for joints, audio_beats in zip(joints_list, audio_beats_list):
        if joints.ndim == 4:
            joints = joints[0]
        ang_vel = _wrist_angle_velocity(joints) / CHANGE_ANGLE / len(CHANGE_ANGLE)
        angle_diff = np.concatenate([np.zeros((1, 4)), ang_vel], axis=0)
        T = joints.shape[0]
        for i in range(angle_diff.shape[1]):
            motion_beats = []
            for t in range(1, T - 1):
                if (angle_diff[t, i] < angle_diff[t - 1, i]
                        and angle_diff[t, i] < angle_diff[t + 1, i]
                        and (angle_diff[t - 1, i] - angle_diff[t, i] >= thres
                             or angle_diff[t + 1, i] - angle_diff[t, i] >= thres)):
                    motion_beats.append(t / 30.0)
            if not motion_beats:
                continue
            mb = np.asarray(motion_beats)
            for a in np.asarray(audio_beats).reshape(-1):
                sum_1 += math.exp(-np.min((a - mb) ** 2) / (2 * sigma * sigma))
            total_beat += len(np.asarray(audio_beats).reshape(-1))
    return sum_1 / total_beat if total_beat else 0.0
