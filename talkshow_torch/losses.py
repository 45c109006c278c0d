"""Loss library of the port (copy of talkshow_tpu/losses.py:1-65, a mirror
of the reference's losses/losses.py:11-91), plain tensor functions.

Each keeps the JAX function's operations in their order, so a step that
calls it computes what the JAX step computes.
"""
from __future__ import annotations

import torch


def keypoint_loss(pred: torch.Tensor, gt: torch.Tensor,
                  conf: torch.Tensor | None = None) -> torch.Tensor:
    """Squared error averaged over every element, or, with `conf`, over the
    elements whose confidence is >= 0.01 only (the reference SELECTS them
    by boolean indexing; it does not weight by conf)."""
    se = (pred - gt) ** 2
    if conf is not None:
        sel = (conf >= 0.01).to(se.dtype)
        return torch.sum(se * sel) / torch.clamp(torch.sum(sel), min=1.0)
    return torch.mean(se)


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor, tolerance: float | None = None,
            mul: float = 1.0) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, 1)) of (B, D) inputs: summed over D, floored
    elementwise at tolerance * mul * D / 64 (free bits), batch-meaned."""
    if mu.dim() != 2:
        raise ValueError(f"kl_loss expects (B, D) inputs (the reference sums over axis 1), "
                         f"got shape {tuple(mu.shape)}")
    kld = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=1)
    if tolerance is not None:
        floor = tolerance * mul * mu.shape[1] / 64.0
        kld = torch.clamp(kld, min=floor)
    return torch.mean(kld)


def l2_reg_loss(params) -> torch.Tensor:
    """Sum of squared parameters."""
    return sum(torch.sum(p ** 2) for p in params)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def audio_loss(dynamics: torch.Tensor, gt_poses: torch.Tensor) -> torch.Tensor:
    """MSE of `dynamics` against the target centred on its last axis's mean."""
    gt = gt_poses - torch.mean(gt_poses, dim=-1, keepdim=True)
    return torch.mean((dynamics - gt) ** 2)


def velocity_loss(pred: torch.Tensor, gt: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """L1 between first-order differences along `dim` (the velocity term of
    the VQ losses, smplx_body_vq.py:186-189)."""
    return torch.mean(torch.abs(torch.diff(pred, dim=dim) - torch.diff(gt, dim=dim)))
