"""SMPL-X pose-vector layout, channel masks and composition helpers
(port of talkshow_tpu/ops/pose.py).

The numpy tables are copied from talkshow_tpu/ops/pose.py:40-89 and held
equal to the originals by tests/test_torch_ops.py.  One frame of the
canonical layout is 165 axis-angle channels + 100 expression = 265; the
body models work on the 129 "conversational" channels `C_INDEX_3D` (258
for the 6-D layout, `C_INDEX_6D`), and `part2full` re-inserts a canned
lower body into [jaw | conv129 | exp100].  The reference's channel
asymmetry (mask drops joints 11,12; part2full re-inserts at joints 9,10)
is reproduced as-is, see the JAX module.

The raw dataset stores each hand as 12 PCA coefficients; `hand_pca_to_full`
expands them with the MANO components of `assets/hand_component.json`, the
port's own copy of the JAX package's asset (found there, or in the
directory that TALKSHOW_ASSETS names).  The tensor helpers run on the
device and dtype of their input.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np
import torch

from talkshow_torch.ops import rotation

FULL_POSE_DIM = 165
EXPRESSION_DIM = 100
FULL_DIM = FULL_POSE_DIM + EXPRESSION_DIM   # 265
CONV_DIM = 129
BODY_DIM = 39
HAND_DIM = 90
JAW_DIM = 3
NUM_SPEAKERS = 4

SPEAKER_ID = {"oliver": 20, "chemistry": 21, "seth": 22, "conan": 23}
SPEAKER_OFFSET = 20

_FIX_INDEX_3D = np.array(
    list(range(0, 18)) + list(range(21, 27)) + list(range(30, 36)) + list(range(45, 51))
)
_keep = np.ones(FULL_POSE_DIM, dtype=bool)
_keep[_FIX_INDEX_3D] = False
C_INDEX_3D = np.nonzero(_keep)[0]                     # (129,)
C_INDEX_6D = np.stack([2 * C_INDEX_3D, 2 * C_INDEX_3D + 1], -1).reshape(-1)  # (258,)

LOWER_POSE = np.array(
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 3.0747, -0.0158, -0.0152,
     -1.1826512813568115, 0.23866955935955048, 0.15146760642528534,
     -1.2604516744613647, -0.3160211145877838, -0.1603458970785141,
     1.1654603481292725, 0.0, 0.0,
     1.2521806955337524, 0.041598282754421234, -0.06312154978513718,
     0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    dtype=np.float32,
)

LOWER_POSE_STAND = np.array(
    [8.9759e-04, 7.1074e-04, -5.9163e-06, 8.9759e-04, 7.1074e-04, -5.9163e-06,
     3.0747, -0.0158, -0.0152,
     -3.6665e-01, -8.8455e-03, 1.6113e-01, -3.6665e-01, -8.8455e-03, 1.6113e-01,
     -3.9716e-01, -4.0229e-02, -1.2637e-01,
     7.9163e-01, 6.8519e-02, -1.5091e-01, 7.9163e-01, 6.8519e-02, -1.5091e-01,
     7.8632e-01, -4.3810e-02, 1.4375e-02,
     -1.0675e-01, 1.2635e-01, 1.6711e-02, -1.0675e-01, 1.2635e-01, 1.6711e-02],
    dtype=np.float32,
)

CHANGE_ANGLE = np.array([6.0181e-05, 5.1597e-05, 2.1344e-04, 2.1899e-04], dtype=np.float32)


def part2full(pred: torch.Tensor, stand: bool = False) -> torch.Tensor:
    """[jaw3 | conv129 | exp100] (..., 232) -> full (..., 265)."""
    if stand:
        lp = np.zeros_like(LOWER_POSE)
        lp[6:9] = [3.0747, -0.0158, -0.0152]
    else:
        lp = LOWER_POSE
    lp = torch.as_tensor(lp, dtype=pred.dtype, device=pred.device)
    lp = lp.expand(pred.shape[:-1] + (33,))
    return torch.cat(
        [
            pred[..., 0:3],      # jaw
            lp[..., 0:15],       # leye, reye, orient, body j0,j1
            pred[..., 3:6],      # body j2
            lp[..., 15:21],      # body j3,j4
            pred[..., 6:9],      # body j5
            lp[..., 21:27],      # body j6,j7
            pred[..., 9:12],     # body j8
            lp[..., 27:33],      # body j9,j10
            pred[..., 12:],      # remaining channels + expression
        ],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# hand PCA expansion (host side, numpy)
# ---------------------------------------------------------------------------

def _default_asset_dirs():
    env = os.environ.get("TALKSHOW_ASSETS")
    dirs = [env] if env else []
    dirs += [os.path.join(os.path.dirname(__file__), "..", "assets")]
    return [d for d in dirs if d and os.path.isdir(d)]


@lru_cache(maxsize=1)
def load_hand_components(path: str | None = None):
    """MANO hand PCA components (`hand_component.json`) -> (left, right),
    each (45, 45) float64: row i is the i-th component over the 45
    axis-angle hand channels."""
    if path is None:
        for d in _default_asset_dirs():
            cand = os.path.join(d, "hand_component.json")
            if os.path.isfile(cand):
                path = cand
                break
    if path is None:
        raise FileNotFoundError("hand_component.json not found; set TALKSHOW_ASSETS or pass a path")
    with open(path) as f:
        comp = json.load(f)
    return np.asarray(comp["left"]), np.asarray(comp["right"])


def hand_pca_to_full(packed99: np.ndarray, components=None) -> np.ndarray:
    """The packed 99-D pose [jaw, eyes, orient, body63, lpca12, rpca12]
    (T, 99) -> the 165-D layout, with the first 12 PCA components
    (mesh_dataset.py:22-26)."""
    if components is None:
        components = load_hand_components()
    left_c, right_c = components
    left = packed99[:, 75:87] @ left_c[:12, :]
    right = packed99[:, 87:99] @ right_c[:12, :]
    return np.concatenate([packed99[:, :75], left, right], axis=-1)


# ---------------------------------------------------------------------------
# channel extraction and recomposition (tensors)
# ---------------------------------------------------------------------------

def full_to_conv(poses: torch.Tensor, rep6d: bool = False) -> torch.Tensor:
    """The conversational channels of (..., 165) poses [or (..., 330) 6-D]."""
    idx = C_INDEX_6D if rep6d else C_INDEX_3D
    return poses[..., torch.as_tensor(idx, device=poses.device)]


def _lower(lp: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    lp = torch.as_tensor(lp, dtype=like.dtype, device=like.device)
    return lp.expand(like.shape[:-1] + (33,))


def poses2pred(full: torch.Tensor, stand: bool = False) -> torch.Tensor:
    """The lower-body channels of a FULL (..., 265) pose replaced by the
    canned pose (lower_body.py:117-133)."""
    lp = _lower(LOWER_POSE_STAND if stand else LOWER_POSE, full)
    return torch.cat([full[..., 0:3], lp[..., 0:15], full[..., 18:21], lp[..., 15:21],
                      full[..., 27:30], lp[..., 21:27], full[..., 36:39], lp[..., 27:33],
                      full[..., 45:]], dim=-1)


def _first_frame(gt: torch.Tensor, like: torch.Tensor, s: int, e: int) -> torch.Tensor:
    return gt[0:1, s:e].expand(like.shape[:-1] + (e - s,))


def pred2poses(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Predicted channels blended with the first GT frame's lower body
    (lower_body.py:90-101)."""
    rep = lambda s, e: _first_frame(gt, pred, s, e)
    return torch.cat([pred[..., 0:3], rep(3, 18), pred[..., 3:6], rep(21, 27),
                      pred[..., 6:9], rep(30, 36), pred[..., 9:12], rep(39, 45),
                      pred[..., 12:]], dim=-1)


def poses2poses(full: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The lower-body channels of a FULL pose replaced by the first GT
    frame's (lower_body.py:104-116)."""
    rep = lambda s, e: _first_frame(gt, full, s, e)
    return torch.cat([full[..., 0:3], rep(3, 18), full[..., 18:21], rep(21, 27),
                      full[..., 27:30], rep(30, 36), full[..., 36:39], rep(39, 45),
                      full[..., 45:]], dim=-1)


def split_jaw_body_exp(face_out: torch.Tensor):
    """Face-generator output (..., 103) -> (jaw (..., 3), expression (..., 100))."""
    return face_out[..., :3], face_out[..., 3:]


# ---------------------------------------------------------------------------
# rotation representations of the pose vector
# ---------------------------------------------------------------------------

def axis_angle_poses_to_6d(poses165: torch.Tensor) -> torch.Tensor:
    """(T, 165) axis-angle -> (T, 330) 6-D (mesh_dataset.py:187-191)."""
    aa = poses165.reshape(poses165.shape[0], 55, 3)
    return rotation.axis_angle_to_rotation_6d(aa).reshape(poses165.shape[0], 330)


def pose6d_to_axis_angle(poses330: torch.Tensor) -> torch.Tensor:
    """(T, 330) 6-D -> (T, 165) axis-angle (scripts/demo.py:216-219)."""
    d6 = poses330.reshape(poses330.shape[0], -1, 6)
    return rotation.rotation_6d_to_axis_angle(d6).reshape(poses330.shape[0], -1)


def pose5d_to_axis_angle(poses: torch.Tensor, expression: bool = True) -> torch.Tensor:
    """The legacy '5d' layout (axis3 + sin + cos per joint) -> axis-angle,
    the eval-time to3d (data_utils/get_j.py:4-17).  Input (T, 275[+100])."""
    exp = None
    if expression:
        exp = poses[:, -100:]
        poses = poses[:, :-100]
    p = poses.reshape(poses.shape[0], -1, 5)
    angle = torch.atan2(p[:, :, 3], p[:, :, 4])
    aa = (p[:, :, :3] * angle[..., None]).reshape(poses.shape[0], -1)
    if exp is not None:
        aa = torch.cat([aa, exp], dim=-1)
    return aa
