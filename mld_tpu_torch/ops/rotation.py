"""Rotation representation conversions, batched (port of
``mld_tpu/ops/rotation.py``).

Parity target: the vendored pytorch3d conversions of the reference
(mld/utils/rotation_conversions.py): axis-angle / quaternion / matrix /
rotation-6d. Quaternions are w-first; rotation_6d is the pytorch3d flavour
(the first two ROWS of R, flattened), not the HumanML3D codec's column-based
cont6d of ``ops/quaternion.py``.
"""
from __future__ import annotations

import torch

from .quaternion import quaternion_to_matrix


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 4) unit quaternions."""
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    small = angles < 1e-6
    # sin(x/2)/x -> 0.5 - x^2/48 for small x
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles ** 2) / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angles),
                                      angles))
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle],
                     dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    # grad-safe norm: d|x|/dx at x = 0 is 0/0
    sumsq = (q[..., 1:] ** 2).sum(-1, keepdim=True)
    norms = torch.sqrt(sumsq + 1e-24)
    half = torch.atan2(norms, q[..., :1])
    angles = 2 * half
    small = angles.abs() < 1e-6
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles ** 2) / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angles),
                                      angles))
    return q[..., 1:] / sin_half_over_angle


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows flattened (pytorch3d)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt on the two encoded rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / torch.linalg.vector_norm(a2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) w-first, from the construction with the
    largest pivot; w made non-negative."""
    m = matrix
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    trace = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw = safe_sqrt(1 + trace) / 2
    qx = safe_sqrt(1 + m00 - m11 - m22) / 2
    qy = safe_sqrt(1 - m00 + m11 - m22) / 2
    qz = safe_sqrt(1 - m00 - m11 + m22) / 2

    c0 = torch.stack([qw,
                      (m[..., 2, 1] - m[..., 1, 2]) / (4 * qw),
                      (m[..., 0, 2] - m[..., 2, 0]) / (4 * qw),
                      (m[..., 1, 0] - m[..., 0, 1]) / (4 * qw)], -1)
    c1 = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / (4 * qx),
                      qx,
                      (m[..., 0, 1] + m[..., 1, 0]) / (4 * qx),
                      (m[..., 0, 2] + m[..., 2, 0]) / (4 * qx)], -1)
    c2 = torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / (4 * qy),
                      (m[..., 0, 1] + m[..., 1, 0]) / (4 * qy),
                      qy,
                      (m[..., 1, 2] + m[..., 2, 1]) / (4 * qy)], -1)
    c3 = torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / (4 * qz),
                      (m[..., 0, 2] + m[..., 2, 0]) / (4 * qz),
                      (m[..., 1, 2] + m[..., 2, 1]) / (4 * qz),
                      qz], -1)
    # the first largest pivot, as jnp.argmax picks it
    best = torch.stack([qw, qx, qy, qz], -1).argmax(-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.take_along_dim(cands, best[..., None, None].expand(
        best.shape + (1, 4)), dim=-2)[..., 0, :]
    return q * torch.sign(q[..., :1] + 1e-12)


def axis_angle_to_rotation_6d(axis_angle: torch.Tensor) -> torch.Tensor:
    return matrix_to_rotation_6d(axis_angle_to_matrix(axis_angle))


def rotation_6d_to_axis_angle(d6: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(
        rotation_6d_to_matrix(d6)))
