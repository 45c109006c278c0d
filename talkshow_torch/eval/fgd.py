"""Fréchet Gesture Distance over the body AE (port of
talkshow_tpu/eval/fgd.py, a mirror of the reference's evaluation/FGD.py:15-199).

Motion clips are embedded with the body AE's encoder (`models/vqvae.AE`,
nets/body_ae.py), and FGD is the Fréchet distance between gaussians fit to
the real and the generated features; feature MAE beside it.

`frechet_distance` runs on the features' device in their dtype (f32 on the
card) with the JAX module's identity
    tr sqrtm(S1 S2) = sum_i sqrt(lambda_i(S1^(1/2) S2 S1^(1/2))),
so the matrix square root is two symmetric eigendecompositions
(`torch.linalg.eigh`, `eigvalsh`).  `frechet_distance_np` (the same identity
in numpy, f64 for f64 input) serves the clip bootstrap, whose draws follow
`np.random.default_rng(seed)` in the JAX module's order, so that
`paired_fgd_gap` pairs draws across arms and across the two packages.
"""
from __future__ import annotations

import numpy as np
import torch

from talkshow_torch.eval.metrics import beat_consistency, maac
from talkshow_torch.models.vqvae import AE
from talkshow_torch.ops.pose import C_INDEX_3D, C_INDEX_6D


def frechet_distance(feats_a: torch.Tensor, feats_b: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """FGD between two feature sets (N, D), (M, D) -> 0-dim tensor."""
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    eye = torch.eye(feats_a.shape[1], dtype=feats_a.dtype, device=feats_a.device) * eps
    s1 = torch.cov(feats_a.T) + eye
    s2 = torch.cov(feats_b.T) + eye
    w1, v1 = torch.linalg.eigh(s1)
    sq1 = (v1 * torch.sqrt(torch.clamp(w1, min=0.0))) @ v1.T
    wm = torch.linalg.eigvalsh(sq1 @ s2 @ sq1)
    tr_covmean = torch.sqrt(torch.clamp(wm, min=0.0)).sum()
    diff = mu1 - mu2
    return diff @ diff + torch.trace(s1) + torch.trace(s2) - 2.0 * tr_covmean


def frechet_distance_np(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """Numpy mirror of `frechet_distance` (the same eigh identity)."""
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False) + np.eye(feats_a.shape[1]) * eps
    s2 = np.cov(feats_b, rowvar=False) + np.eye(feats_b.shape[1]) * eps
    w1, v1 = np.linalg.eigh(s1)
    sq1 = (v1 * np.sqrt(np.maximum(w1, 0.0))) @ v1.T
    wm = np.linalg.eigvalsh(sq1 @ s2 @ sq1)
    tr_covmean = np.sum(np.sqrt(np.maximum(wm, 0.0)))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_covmean)


def paired_fgd_gap(ci_a: dict, ci_b: dict) -> dict:
    """Paired bootstrap distribution of the FGD gap (arm a - arm b), valid
    when both arms' `bootstrap_fgd(return_draws=True)` ran with the same
    seed and n_boot over the same number of clips walked in the same order:
    the resample indices are then equal draw for draw."""
    for ci in (ci_a, ci_b):
        if "draws" not in ci:
            raise ValueError("paired_fgd_gap needs bootstrap_fgd(return_draws=True) outputs")
    if any(ci_a[k] != ci_b[k] for k in ("n_boot", "n_clips", "seed")):
        raise ValueError(
            "paired_fgd_gap arms are not paired: n_boot/n_clips/seed differ "
            f"({ci_a['n_boot']}/{ci_a['n_clips']}/{ci_a['seed']} vs "
            f"{ci_b['n_boot']}/{ci_b['n_clips']}/{ci_b['seed']})")
    gap = np.asarray(ci_a["draws"]) - np.asarray(ci_b["draws"])
    lo, hi = np.percentile(gap, [2.5, 97.5])
    return {"mean": float(gap.mean()), "std": float(gap.std()),
            "p2_5": float(lo), "p97_5": float(hi),
            "frac_a_lt_b": float(np.mean(gap < 0)),
            "n_boot": int(ci_a["n_boot"]), "n_clips": int(ci_a["n_clips"])}


class FGDEvaluator:
    """Accumulates real / generated features, joints and audio beats per
    clip (the reference's EmbeddingSpaceEvaluator push_* :38-63).  The AE
    runs in eval mode on its own device; features are kept on the host as
    f32 numpy, one array per clip."""

    def __init__(self, ae: AE):
        self.ae = ae
        self.reset()

    @property
    def device(self) -> torch.device:
        return next(self.ae.parameters()).device

    def reset(self):
        self.real_feats = []
        self.gen_feats = []
        self.real_joints = []
        self.gen_joints = []
        self.audio_beats = []

    @torch.no_grad()
    def extract(self, poses) -> torch.Tensor:
        """Poses (B, T, C) -> features (B, T/4, embed) on the AE's device.
        Widths are matched exactly: 330 -> the 6-D conv channels, 165 -> the
        3-D ones; any other width is taken as already conv-channel (129,
        258) or feature input."""
        poses = torch.as_tensor(poses, dtype=torch.float32, device=self.device)
        c = poses.shape[-1]
        if c == 330:
            poses = poses[..., torch.as_tensor(C_INDEX_6D, device=self.device)]
        elif c == 165:
            poses = poses[..., torch.as_tensor(C_INDEX_3D, device=self.device)]
        return self.ae.eval().encode(poses)

    def push_samples(self, generated, real):
        rf = self.extract(real)
        gf = self.extract(generated)
        self.real_feats.append(rf.reshape(-1, rf.shape[-1]).cpu().numpy())
        self.gen_feats.append(gf.reshape(-1, gf.shape[-1]).cpu().numpy())

    def push_joints(self, generated: np.ndarray, real: np.ndarray):
        self.real_joints.append(np.asarray(real))
        self.gen_joints.append(np.asarray(generated).squeeze())

    def push_aud(self, beats: np.ndarray):
        self.audio_beats.append(np.asarray(beats))

    def get_scores(self):
        """-> (fgd, feature MAE) (reference get_scores :117-144); FGD on the
        AE's device."""
        gen = np.vstack(self.gen_feats)
        real = np.vstack(self.real_feats)
        fgd = float(frechet_distance(torch.as_tensor(gen, device=self.device),
                                     torch.as_tensor(real, device=self.device)))
        n = min(len(gen), len(real))
        feat_mae = float(np.mean(np.sum(np.abs(real[:n] - gen[:n]), axis=1)))
        return fgd, feat_mae

    def bootstrap_fgd(self, n_boot: int = 200, seed: int = 0,
                      return_draws: bool = False) -> dict:
        """Clip-level bootstrap CI of FGD: clip indices resampled with
        replacement, generated and real features of a clip kept paired
        (frames within a clip are correlated; clips are the independent
        unit).  `return_draws` includes the draws for `paired_fgd_gap`."""
        n_clips = len(self.gen_feats)
        if n_clips < 2:
            raise ValueError("bootstrap_fgd needs >= 2 pushed clips")
        rng = np.random.default_rng(seed)
        draws = np.empty(n_boot)
        for b in range(n_boot):
            idx = rng.integers(0, n_clips, size=n_clips)
            gen = np.vstack([self.gen_feats[i] for i in idx])
            real = np.vstack([self.real_feats[i] for i in idx])
            draws[b] = frechet_distance_np(gen, real)
        lo, hi = np.percentile(draws, [2.5, 97.5])
        out = {"mean": float(draws.mean()), "std": float(draws.std()),
               "p2_5": float(lo), "p97_5": float(hi),
               "n_boot": n_boot, "n_clips": n_clips, "seed": seed}
        if return_draws:
            out["draws"] = draws.tolist()
        return out

    def get_bc_score(self) -> float:
        return beat_consistency(self.gen_joints, self.audio_beats)

    def get_maac(self):
        return maac(self.real_joints)
