"""Quaternion math for joint recovery (port of ``qinv``, ``qmul`` and
``qrot`` from ``mld_tpu/ops/quaternion.py``).

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
