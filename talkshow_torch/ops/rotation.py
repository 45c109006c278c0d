"""Rotation-representation conversions on tensors (port of
talkshow_tpu/ops/rotation.py:20-251).

Closed-form expressions without data-dependent control flow, as the JAX
module: `matrix_to_quaternion` computes all four candidate quaternions and
keeps the best by a one-hot sum (argmax, first index on ties), and the
small-angle Taylor branches are `torch.where` selections whose unused side
is kept finite by the `where(small, 1, angles)` guard.  Every function
runs on the device and dtype of its input.

Conventions (the reference's / pytorch3d's):
  - quaternions are (..., 4) with the real part first (w, x, y, z)
  - matrices are (..., 3, 3), row-major, acting on column vectors
  - axis-angle is (..., 3): axis * angle (radians)
  - 6-D is the first two ROWS of the rotation matrix, flattened (..., 6)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x))."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) (w,x,y,z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = torch.unbind(quaternions, -1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) (w,x,y,z),
    real part non-negative: the candidate with the largest denominator,
    selected by a one-hot weighted sum."""
    m = matrix.reshape(matrix.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(m, -1)
    q_abs = _sqrt_positive_part(torch.stack(
        [1.0 + m00 + m11 + m22,
         1.0 + m00 - m11 - m22,
         1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22], dim=-1))
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )  # (..., 4, 4)
    flr = torch.tensor(0.1, dtype=matrix.dtype, device=matrix.device)
    quat_candidates = quat_by_rijk / (2.0 * torch.maximum(q_abs[..., None], flr))
    # torch.argmax returns the first maximal index, as jnp.argmax
    onehot = F.one_hot(q_abs.argmax(dim=-1), 4).to(matrix.dtype)
    out = (quat_candidates * onehot[..., None]).sum(dim=-2)
    return torch.where(out[..., :1] < 0, -out, out)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion (..., 4), smooth at angle 0."""
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    small = angles.abs() < 1e-6
    # sin(x/2)/x ~ 1/2 - x^2/48 near zero
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles * angles) / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angles), angles))
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> axis-angle (..., 3), smooth at angle 0.  The
    angle comes from atan2(|xyz|, w), so it stays exact near pi, where
    sin(angle / 2) / angle is far from zero."""
    norms = torch.linalg.norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2.0 * half_angles
    small = angles.abs() < 1e-6
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles * angles) / 48.0,
        torch.sin(half_angles) / torch.where(small, torch.ones_like(angles), angles))
    return quaternions[..., 1:] / sin_half_over_angle


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (via quaternion)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> 6-D (first two rows flattened)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6-D (..., 6) -> rotation matrix (..., 3, 3) by Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def axis_angle_to_rotation_6d(axis_angle: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotation_6d(axis_angle_to_matrix(axis_angle))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    return matrix_to_axis_angle(rotation_6d_to_matrix(d6))


# ---------------------------------------------------------------------------
# quaternion algebra (reference rotation_conversion.py:154-253)
# ---------------------------------------------------------------------------

def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Canonical sign: non-negative real part."""
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate points (..., 3) by quaternions (..., 4)."""
    p = F.pad(point, (1, 0))
    out = quaternion_raw_multiply(quaternion_raw_multiply(q, p), quaternion_invert(q))
    return out[..., 1:]


# ---------------------------------------------------------------------------
# Euler angles (reference rotation_conversion.py:97-151)
# ---------------------------------------------------------------------------

def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        flat = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        flat = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(axis)
    return torch.stack(flat, -1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """(..., 3) angles + a convention like 'XYZ' -> (..., 3, 3)."""
    ms = [_axis_angle_rotation(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return ms[0] @ ms[1] @ ms[2]


def _angle_from_tan(axis, other_axis, data, horizontal, tait_bryan):
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) Euler angles in the given convention."""
    i0 = "XYZ".index(convention[0])
    i2 = "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(torch.clamp(
            matrix[..., i0, i2] * (-1.0 if i0 - i2 in (-1, 2) else 1.0), -1.0, 1.0))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, -1)
