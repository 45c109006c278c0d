"""Quantitative evaluation runners (port of talkshow_tpu/eval/runners.py,
mirrors of the reference's scripts/test_vq.py, test_body.py and
test_face.py).

Each runner walks the whole clips of a ShowDataset on its models' device
and returns the JAX runner's keys, `per_clip` lists and bootstrap CIs:

  * `eval_vq_capacity`: the VQ round trip's L1 ("capacity",
    test_vq.py:54); the VQ-VAEs run in eval mode, so each quantizer's
    nearest-code search is K4 on the card (two launches a clip);
  * `eval_body`: FGD + feature MAE (`FGDEvaluator`), L2 error, sample
    diversity, and with an SMPL-X model LVD over the joints and beat
    consistency (test_body.py:98-194); the token decode is K1 (one launch
    a clip of up to 32 samples, its tables packed once);
  * `eval_face`: jaw L1 + expression MSE, and with an SMPL-X model the
    face-vertex LVD (test_face.py:93-111); on the card each whole clip runs
    through `face_apply_fused` on f32 tables (K3 + K2), on the CPU through
    the plain FaceGenerator, with a zero identity as JAX passes.

The plain versions of the kernels never run on the card here: a CUDA
tensor launches its kernel or raises.  SMPL-X metrics run only when a
loaded `SmplxModel` is passed (the licensed npz is not in the repository).
The LS3DCG runner waits for the LS3DCG model.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from talkshow_torch.eval.fgd import FGDEvaluator
from talkshow_torch.eval.metrics import clip_ci, diversity, lvd
from talkshow_torch.kernels.ar_decode import pack_decode_tables
from talkshow_torch.models.body import BodyModels, generate_conv_poses
from talkshow_torch.models.vqvae import AE, VQVAE
from talkshow_torch.models.wav2vec_fused import face_apply_fused, pack_face_tables
from talkshow_torch.ops import audio as audio_ops
from talkshow_torch.ops import pose as pose_ops
from talkshow_torch.ops import smplx_lbs
from talkshow_torch.ops.pose import C_INDEX_3D, C_INDEX_6D


def _conv_channels(poses: np.ndarray) -> np.ndarray:
    if poses.shape[-1] >= 330:          # convert_to_6d layout
        return poses[..., C_INDEX_6D]
    return poses[..., C_INDEX_3D] if poses.shape[-1] >= 165 else poses


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


@torch.no_grad()
def eval_vq_capacity(vq_body: VQVAE, vq_hand: VQVAE, vq_states: dict, dataset) -> dict:
    """Reconstruction round trip over whole clips (scripts/test_vq.py:28-64).
    vq_states: {'body', 'hand': VQState} on the models' device."""
    dev = _device(vq_body)
    body_dim = vq_body.decoder.project.out_channels   # 39 (3-D) or 78 (6-D)
    vq_body.eval()
    vq_hand.eval()
    losses = []
    for clip in dataset.whole_clips():
        conv = _conv_channels(clip["poses"])[None]
        t = conv.shape[1] - conv.shape[1] % 4
        conv = torch.as_tensor(conv[:, :t], dtype=torch.float32, device=dev)
        rb = vq_body(conv[..., :body_dim], vq_states["body"])[0]
        rh = vq_hand(conv[..., body_dim:], vq_states["hand"])[0]
        recon = torch.cat([rb, rh], dim=-1)
        losses.append(float((recon - conv).abs().mean()))
    return {"capacity_l1": float(np.mean(losses)), "num_clips": len(losses)}


def _smplx_full(poses_t: np.ndarray, conv: np.ndarray, expression: np.ndarray,
                dev) -> torch.Tensor:
    """[jaw | conv129 | exp100] -> the full (T, 265) vector on `dev`."""
    pred = np.concatenate([poses_t[:, :3], conv, expression], axis=-1)
    return pose_ops.part2full(torch.as_tensor(pred, dtype=torch.float32, device=dev))


@torch.no_grad()
def eval_body(body, ae: AE, dataset, num_samples: int = 2, seed: int = 0,
              smplx_model: smplx_lbs.SmplxModel | None = None,
              noise: Callable[[int], object] | None = None,
              evaluator: FGDEvaluator | None = None) -> dict:
    """Generation quality over whole clips (scripts/test_body.py:113-194).

    body: a Pipeline (its decode tables, in its `table_dtype`) or the
    port's BodyModels (bf16 tables packed once here, a Pipeline's default).
    ae: the FGD feature net.
    noise: for parity with JAX, a callable from the clip's index to its
    gumbel block (H, 2, num_samples, K); without it the decode draws from
    torch.Generator(seed) (Philox in K1 on the card).  evaluator: an
    FGDEvaluator to fill (default a fresh one over `ae`), which a caller
    may read afterwards."""
    if not isinstance(body, BodyModels):      # a Pipeline
        tables, body = body._decode_tables, body.body
    else:
        tables = None
    dev = _device(body.prior)
    if tables is None and dev.type == "cuda":
        tables = pack_decode_tables(body.prior, torch.bfloat16)
    fgd_eval = evaluator if evaluator is not None else FGDEvaluator(ae)
    gen = torch.Generator().manual_seed(seed)
    lvd_vals, l2_vals, div_vals = [], [], []

    for ci, clip in enumerate(dataset.whole_clips()):
        conv_gt = _conv_channels(clip["poses"])
        aud = clip["aud_feat"]
        t = min(conv_gt.shape[0], aud.shape[0])
        t -= t % 4
        conv_gt, aud = conv_gt[:t], aud[:t]
        feat = torch.as_tensor(aud, dtype=torch.float32, device=dev)[None]
        feat = feat.expand(num_samples, -1, -1).contiguous()
        ids = torch.full((num_samples,), int(clip["speaker"]), dtype=torch.long, device=dev)
        block = None
        if noise is not None:
            block = torch.as_tensor(np.asarray(noise(ci)), dtype=torch.float32,
                                    device=dev).contiguous()
        pred, _ = generate_conv_poses(body, feat, ids, generator=gen, noise=block,
                                      tables=tables)
        pred = pred[:, :t]

        fgd_eval.push_samples(pred, conv_gt[None])
        pred = pred.cpu().numpy()
        l2_vals.append(float(np.mean(np.linalg.norm(pred[0] - conv_gt, axis=-1))))
        div_vals.append(diversity(pred))

        if smplx_model is not None:
            sdev = smplx_model.device
            betas = torch.as_tensor(clip["betas"][:smplx_model.num_betas], device=sdev)
            head, exp = clip["poses"][:t], clip["expression"][:t]
            _, gt_j = smplx_lbs.smplx_forward_talkshow(
                smplx_model, betas, _smplx_full(head, conv_gt, exp, sdev), return_verts=False)
            _, pr_j = smplx_lbs.smplx_forward_talkshow(
                smplx_model, betas, _smplx_full(head, pred[0], exp, sdev), return_verts=False)
            lvd_vals.append(float(lvd(gt_j[:, :22], pr_j[:, :22])))
            fgd_eval.push_joints(pr_j.cpu().numpy(), gt_j.cpu().numpy())
            if clip.get("audio_path"):
                fgd_eval.push_aud(audio_ops.onset_times(clip["audio_path"], device=sdev))

    fgd, feat_mae = fgd_eval.get_scores()
    out = {"fgd": fgd, "feat_mae": feat_mae, "l2": float(np.mean(l2_vals)),
           "diversity": float(np.mean(div_vals)), "num_clips": len(l2_vals),
           "per_clip": {"l2": l2_vals, "diversity": div_vals}}
    if len(l2_vals) >= 2:
        out["fgd_ci"] = fgd_eval.bootstrap_fgd(return_draws=True)
        out["l2_ci"] = clip_ci(l2_vals)
    if lvd_vals:
        out["lvd"] = float(np.mean(lvd_vals))
        out["per_clip"]["lvd"] = lvd_vals
        if len(lvd_vals) >= 2:
            out["lvd_ci"] = clip_ci(lvd_vals)
        if fgd_eval.audio_beats:
            out["bc"] = fgd_eval.get_bc_score()
    return out


@torch.no_grad()
def eval_face(face_model, dataset, smplx_model: smplx_lbs.SmplxModel | None = None,
              num_classes: int = 4) -> dict:
    """Face metrics over whole clips (scripts/test_face.py:114-160) of a
    dataset loaded with feat='raw'.  On the card the fused face stage runs
    on f32 tables, packed once here."""
    dev = _device(face_model)
    face_model.eval()
    tables = pack_face_tables(face_model, torch.float32) if dev.type == "cuda" else None
    jaw_l1, exp_mse, lvd_vals = [], [], []
    for clip in dataset.whole_clips():
        gt_poses, exp = clip["poses"], clip["expression"]
        t = gt_poses.shape[0]
        if clip["aud_feat"].shape[-1] != 1:
            continue  # face eval needs the raw-waveform feature
        wav = torch.as_tensor(clip["aud_feat"].reshape(1, -1), dtype=torch.float32, device=dev)
        ids = torch.zeros((1, num_classes), device=dev)
        if dev.type == "cuda":
            pred = face_apply_fused(face_model, wav, ids, t, tables=tables)
        else:
            pred = face_model(wav, ids, t)
        pred = pred[0].cpu().numpy()
        jaw_l1.append(float(np.mean(np.abs(pred[:, :3] - gt_poses[:, :3]))))
        exp_mse.append(float(np.mean((pred[:, 3:103] - exp[:, :100]) ** 2)))

        if smplx_model is not None:
            sdev = smplx_model.device
            betas = torch.as_tensor(clip["betas"][:smplx_model.num_betas], device=sdev)
            gt_full = np.concatenate([gt_poses, exp], axis=-1)
            pr_full = gt_full.copy()
            pr_full[:, 0:3] = pred[:, :3]
            pr_full[:, 165:265] = pred[:, 3:103]
            gt_v, _ = smplx_lbs.smplx_forward_talkshow(smplx_model, betas,
                                                       torch.as_tensor(gt_full, device=sdev))
            pr_v, _ = smplx_lbs.smplx_forward_talkshow(smplx_model, betas,
                                                       torch.as_tensor(pr_full, device=sdev))
            lvd_vals.append(float(lvd(gt_v, pr_v)))

    if not jaw_l1:
        raise ValueError("eval_face saw no raw-waveform clips — load the dataset with "
                         "feat='raw' (every clip's aud_feat was mfcc-like)")
    out = {"jaw_l1": float(np.mean(jaw_l1)), "exp_mse": float(np.mean(exp_mse)),
           "num_clips": len(jaw_l1), "per_clip": {"jaw_l1": jaw_l1, "exp_mse": exp_mse}}
    if len(jaw_l1) >= 2:
        out["jaw_l1_ci"] = clip_ci(jaw_l1)
    if lvd_vals:
        out["face_lvd"] = float(np.mean(lvd_vals))
        out["per_clip"]["face_lvd"] = lvd_vals
        if len(lvd_vals) >= 2:
            out["face_lvd_ci"] = clip_ci(lvd_vals)
    return out
