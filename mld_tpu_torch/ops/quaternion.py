"""Quaternion math (port of ``mld_tpu/ops/quaternion.py``): ``qinv``,
``qmul`` and ``qrot`` for joint recovery, and ``qnormalize``, ``qbetween``,
``quaternion_to_matrix``, ``quaternion_to_cont6d`` and ``qfix`` for the
feature encoder of the synthetic corpus (``data/humanml/motion_process.py``).

Hamilton convention, real part first: ``q = [w, x, y, z]``; arbitrary
leading batch dimensions that broadcast against each other.
"""
from __future__ import annotations

import torch


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (= conjugate). q: (..., 4), w-first."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*r. Both (..., 4), w-first; broadcasting."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    w = qw * rw - qx * rx - qy * ry - qz * rz
    x = qw * rx + qx * rw + qy * rz - qz * ry
    y = qw * ry - qx * rz + qy * rw + qz * rx
    z = qw * rz + qx * ry - qy * rx + qz * rw
    return torch.stack([w, x, y, z], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4):
    v + 2*(w*(u x v) + u x (u x v)) with u the imaginary part of q."""
    qw = q[..., :1]
    qvec = q[..., 1:]
    qvec, v = torch.broadcast_tensors(qvec, v)
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (qw * uv + uuv)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) scaled to unit length."""
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """The quaternion rotating direction v0 onto v1 (..., 3), not
    necessarily unit."""
    v0, v1 = torch.broadcast_tensors(v0, v1)
    v = torch.linalg.cross(v0, v1, dim=-1)
    n0 = torch.sqrt(torch.sum(v0 * v0, dim=-1, keepdim=True))
    n1 = torch.sqrt(torch.sum(v1 * v1, dim=-1, keepdim=True))
    w = n0 * n1 + torch.sum(v0 * v1, dim=-1, keepdim=True)
    return qnormalize(torch.cat([w, v], dim=-1))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) -> rotation matrix(es) (..., 3, 3)."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r), two_s * (i * j + k * r),
        1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j)], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def quaternion_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) -> continuous 6D rotation: the first two columns of
    the rotation matrix, concatenated."""
    rot = quaternion_to_matrix(q)
    return torch.cat([rot[..., 0], rot[..., 1]], dim=-1)


def qfix(q: torch.Tensor) -> torch.Tensor:
    """Sign continuity of a quaternion series q (T, J, 4): flip q[t]
    wherever its dot product with the previous, already fixed, frame is
    negative."""
    flips = torch.cumsum((torch.sum(q[1:] * q[:-1], dim=-1) < 0).int(),
                         dim=0) % 2 == 1
    out = q.clone()
    out[1:][flips] *= -1
    return out
