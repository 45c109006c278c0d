"""SMPL-X linear blend skinning on tensors (port of
talkshow_tpu/ops/smplx_lbs.py, which replaces the external `smplx` package
the reference uses at eval time, scripts/demo.py:274-295,
data_utils/get_j.py:20-51).

    v_shaped = v_template + shapedirs . [betas | expression]
    J        = J_regressor . v_shaped
    v_posed  = v_shaped + posedirs . vec(R_1..54 - I)
    verts    = LBS(v_posed, W, rigid transforms along the kinematic tree)

Frames are the batch.  The products are `torch.einsum` / matmuls on the
model's device (the JAX module runs them outside any Pallas kernel too);
the forward kinematics is the tree's 54 dependent 4x4 products, one small
launch each on the card.  The skinning product is kept whole: at T = 300
frames and V = 10 475 vertices its (T, V, 4, 4) f32 transforms are 201 MB.

`smplx_forward_talkshow` takes the TalkSHOW (T, 265) vector and reorders it
into the model's joint order (global_orient, body 21, jaw, leye, reye,
hands 15 + 15).  The model loads from the official SMPLX_NEUTRAL_2020.npz,
which is licensed and not in the repository; `build_synthetic_smplx_arrays`
builds a rig with the official on-disk schema and coefficient counts (a
copy of scripts/make_synthetic_smplx.py's builder with a vertex-count
argument, so that a rig of the official V = 10 475 can be built).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from talkshow_torch.ops.rotation import axis_angle_to_matrix

NUM_JOINTS = 55            # pelvis-rooted kinematic tree
NUM_BETAS = 300
NUM_EXPRESSION = 100
#: vertices of the official SMPL-X mesh
NUM_VERTS = 10475


class SmplxModel(NamedTuple):
    """The model's arrays as tensors on one device (parents and faces stay
    on the host: the tree is walked in Python)."""
    v_template: torch.Tensor      # (V, 3)
    shapedirs: torch.Tensor       # (V, 3, S) shape (+ expression) directions
    posedirs: torch.Tensor        # ((J-1)*9, V*3)
    j_regressor: torch.Tensor     # (J, V)
    parents: np.ndarray           # (J,) int64
    lbs_weights: torch.Tensor     # (V, J)
    hands_mean_l: torch.Tensor    # (45,)
    hands_mean_r: torch.Tensor    # (45,)
    num_betas: int
    num_expression: int
    faces: np.ndarray | None = None   # (F, 3) int32

    @property
    def device(self) -> torch.device:
        return self.v_template.device


def load_smplx_npz(path: str, num_betas: int = NUM_BETAS,
                   num_expression: int = NUM_EXPRESSION, device="cuda") -> SmplxModel:
    """The official SMPL-X npz (e.g. SMPLX_NEUTRAL_2020.npz: shape dirs
    [0:300] betas, [300:400] expression) -> SmplxModel on `device`."""
    d = np.load(path, allow_pickle=True)
    shapedirs = np.asarray(d["shapedirs"], np.float32)
    total = num_betas + num_expression
    if shapedirs.shape[-1] < total:
        raise ValueError(f"model has {shapedirs.shape[-1]} shape dirs; need {total} "
                         "(use the 300-beta SMPLX_NEUTRAL_2020.npz)")
    shapedirs = shapedirs[..., :total]
    posedirs = np.asarray(d["posedirs"], np.float32)
    v = posedirs.shape[0]
    posedirs = posedirs.reshape(v * 3, -1).T      # ((J-1)*9, V*3)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    return SmplxModel(
        v_template=t(d["v_template"]), shapedirs=t(shapedirs), posedirs=t(posedirs),
        j_regressor=t(d["J_regressor"]),
        parents=np.asarray(d["kintree_table"][0], np.int64),
        lbs_weights=t(d["weights"]), hands_mean_l=t(d["hands_meanl"]),
        hands_mean_r=t(d["hands_meanr"]), num_betas=num_betas,
        num_expression=num_expression,
        faces=np.asarray(d["f"], np.int32) if "f" in d else None)


def _rigid_transform(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray):
    """Forward kinematics: rot_mats (B, J, 3, 3), rest joints (B, J, 3) ->
    (posed joints (B, J, 3), transforms relative to the rest pose
    (B, J, 4, 4)).  Only parents[1:] is read: the root's entry is often
    2**32 - 1 in the official files."""
    par = torch.as_tensor(np.asarray(parents[1:], np.int64), device=joints.device)
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par]], dim=1)
    transforms_mat = _rigid_transform(rot_mats, rel_joints)     # (B, J, 4, 4)

    chain = [transforms_mat[:, 0]]
    for j in range(1, len(parents)):
        chain.append(chain[int(parents[j])] @ transforms_mat[:, j])
    transforms = torch.stack(chain, dim=1)                       # (B, J, 4, 4)

    posed_joints = transforms[..., :3, 3]
    # subtract the rest-pose joint's contribution (the standard LBS correction)
    joints_hom = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    correction = (transforms @ joints_hom[..., None])[..., 0]
    rel = transforms - torch.cat([torch.zeros_like(transforms[..., :3]),
                                  correction[..., None]], dim=-1)
    return posed_joints, rel


def lbs(model: SmplxModel, betas: torch.Tensor, expression: torch.Tensor,
        full_pose_aa: torch.Tensor, return_verts: bool = True):
    """The SMPL-X forward.  betas (B, num_betas); expression (B,
    num_expression); full_pose_aa (B, 55, 3) in MODEL joint order (global,
    body 21, jaw, leye, reye, lhand 15, rhand 15).  Returns (vertices
    (B, V, 3) or None, joints (B, 55, 3))."""
    shape_coeffs = torch.cat([betas, expression], dim=-1)          # (B, S)
    v_shaped = model.v_template[None] + torch.einsum("vcs,bs->bvc", model.shapedirs,
                                                     shape_coeffs)
    joints = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)

    rot_mats = axis_angle_to_matrix(full_pose_aa)                 # (B, 55, 3, 3)
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(rot_mats.shape[0], -1)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(v_shaped.shape)

    posed_joints, rel_transforms = batch_rigid_transform(rot_mats, joints, model.parents)
    if not return_verts:
        return None, posed_joints

    t = torch.einsum("vj,bjxy->bvxy", model.lbs_weights, rel_transforms)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = (t @ v_hom[..., None])[..., :3, 0]
    return verts, posed_joints


def talkshow_pose_to_model_order(pred265: torch.Tensor, model: SmplxModel,
                                 flat_hand_mean: bool = False):
    """(B, 265) TalkSHOW layout [jaw, leye, reye, orient, body63, lhand45,
    rhand45, exp100] -> ((B, 55, 3) pose in model order, (B, 100)
    expression) (data_utils/get_j.py:20-31).  flat_hand_mean=False adds the
    MANO hand means, as the reference's smplx config (demo.py:285)."""
    jaw, leye, reye = pred265[..., 0:3], pred265[..., 3:6], pred265[..., 6:9]
    orient, body = pred265[..., 9:12], pred265[..., 12:75]
    lhand, rhand = pred265[..., 75:120], pred265[..., 120:165]
    exp = pred265[..., 165:265]
    if not flat_hand_mean:
        lhand = lhand + model.hands_mean_l
        rhand = rhand + model.hands_mean_r
    pose = torch.cat([orient, body, jaw, leye, reye, lhand, rhand], dim=-1)
    return pose.reshape(pose.shape[:-1] + (NUM_JOINTS, 3)), exp


def smplx_forward_talkshow(model: SmplxModel, betas: torch.Tensor, pred265: torch.Tensor,
                           return_verts: bool = True):
    """(T, 265) parameters + (num_betas,) betas -> (vertices (T, V, 3) or
    None, joints (T, 55, 3)): the reference's frame loop
    (data_utils/get_j.py:20-51) as one batch, in f32."""
    pose, exp = talkshow_pose_to_model_order(pred265, model)
    b = betas[None, :].expand(pred265.shape[0], betas.shape[0])
    return lbs(model, b, exp, pose, return_verts)


def build_synthetic_smplx_arrays(verts_per_joint: int = 8, seed: int = 0,
                                 num_verts: int | None = None) -> dict:
    """A deterministic chain rig in the official npz schema (the keys
    `load_smplx_npz` reads) with the official coefficient counts: 55
    joints, 300 betas + 100 expression.  Joint j rests at (0, 0.1 j, 0)
    with parent j - 1 and owns a cluster of vertices: `verts_per_joint`
    each, or, with `num_verts`, that many vertices in all, the first
    num_verts % 55 joints taking one more than the rest (10 475 gives the
    official mesh size).  With num_verts = 55 * verts_per_joint the arrays
    equal scripts/make_synthetic_smplx.py's, draw for draw."""
    rng = np.random.default_rng(seed)
    J, S = NUM_JOINTS, NUM_BETAS + NUM_EXPRESSION
    V = J * verts_per_joint if num_verts is None else int(num_verts)
    if V < J:
        raise ValueError(f"{V} vertices cannot cover {J} joints")
    sizes = np.full(J, V // J)
    sizes[: V % J] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)])
    owner = np.repeat(np.arange(J), sizes)

    joints_rest = np.stack([np.zeros(J), np.arange(J) * 0.1, np.zeros(J)], 1).astype(np.float64)
    v_template = joints_rest[owner] + rng.standard_normal((V, 3)) * 0.02

    # the regressor averages each joint's own cluster
    j_reg = np.zeros((J, V))
    j_reg[owner, np.arange(V)] = 1.0 / sizes[owner]

    # skinning: 80 % own joint, 20 % parent (smooth chain deformation)
    w = np.zeros((V, J))
    w[np.arange(V), owner] = 0.8
    w[np.arange(V), np.maximum(owner - 1, 0)] += 0.2

    parents = np.concatenate([[0], np.arange(J - 1)]).astype(np.uint32)
    kintree = np.stack([parents, np.arange(J, dtype=np.uint32)])

    shapedirs = rng.standard_normal((V, 3, S)).astype(np.float64) * 0.002
    posedirs = rng.standard_normal((V, 3, (J - 1) * 9)).astype(np.float64) * 0.0005

    # a triangle fan over each joint's vertex cluster
    faces = [[b, b + k + 1, b + k + 2] for j in range(J)
             for b in (int(starts[j]),) for k in range(int(sizes[j]) - 2)]
    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": j_reg,
        "kintree_table": kintree,
        "weights": w,
        "hands_meanl": rng.standard_normal(45) * 0.1,
        "hands_meanr": rng.standard_normal(45) * 0.1,
        "f": np.asarray(faces, np.uint32),
    }
