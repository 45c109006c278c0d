"""SMPL-X pose-vector layout constants and `part2full`.

Copied from talkshow_tpu/ops/pose.py:40-89,149-175 (numpy tables, held
equal to the originals by tests/test_torch_ops.py).  One frame of the
canonical layout is 165 axis-angle channels + 100 expression = 265; the
body models work on the 129 "conversational" channels `C_INDEX_3D`, and
`part2full` re-inserts a canned lower body into [jaw | conv129 | exp100].
The reference's channel asymmetry (mask drops joints 11,12; part2full
re-inserts at joints 9,10) is reproduced as-is, see the JAX module.
"""
from __future__ import annotations

import numpy as np
import torch

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
