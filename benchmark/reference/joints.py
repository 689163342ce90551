"""Features -> joints.

Text (HumanML3D 263 features): de-normalise, then recover the root's yaw
and planar track (two cumulative sums, quaternion rotations) and place the
rotation-invariant local positions around it.
Action (HumanAct12 150 features = 24 rot6d rows + a translation row):
Gram-Schmidt rotations and forward kinematics over the SMPL tree with the
rest offsets of an approximate neutral body, plus the root translation.
Both zero outside the mask.
"""
from __future__ import annotations

import numpy as np
import torch

from .arith import matmul, rounded

SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21]
# each joint's rest offset from its parent (metres), the root's at 0
SMPL_OFFSETS = np.array([
    [0.0, 0.0, 0.0], [0.06, -0.09, -0.01], [-0.06, -0.09, -0.01],
    [0.0, 0.11, -0.01], [0.04, -0.38, 0.0], [-0.04, -0.38, 0.0],
    [0.0, 0.14, 0.0], [-0.01, -0.4, -0.04], [0.01, -0.4, -0.04],
    [0.0, 0.05, 0.02], [0.03, -0.06, 0.12], [-0.03, -0.06, 0.12],
    [0.0, 0.21, -0.03], [0.08, 0.11, -0.02], [-0.08, 0.11, -0.02],
    [0.0, 0.07, 0.03], [0.11, 0.05, -0.02], [-0.11, 0.05, -0.02],
    [0.26, -0.01, -0.02], [-0.26, -0.01, -0.02], [0.25, 0.01, 0.0],
    [-0.25, 0.01, 0.0], [0.09, -0.01, -0.01], [-0.09, -0.01, -0.01],
], dtype=np.float32)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _rotate_inverse_yaw(cos, sin, v):
    """Rotate v (..., 3) by the conjugate of the yaw quaternion
    [cos, 0, sin, 0]."""
    u = torch.stack([torch.zeros_like(sin), -sin, torch.zeros_like(sin)], -1)
    u, v = torch.broadcast_tensors(u, v)
    uv = _cross(u, v)
    return v + 2.0 * (cos[..., None] * uv + _cross(u, uv))


def ric_joints(feats, mask, n_joints, mean, std, mode):
    """[B, T, 263] -> [B, T, n_joints, 3]."""
    data = rounded(feats, mode) * std + mean
    rv = data[..., 0]
    ang = torch.cumsum(torch.cat([torch.zeros_like(rv[..., :1]),
                                  rv[..., :-1]], -1), -1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    vel = torch.cat([torch.zeros_like(data[..., :1, 1:3]),
                     data[..., :-1, 1:3]], -2)
    step = torch.stack([vel[..., 0], torch.zeros_like(vel[..., 0]),
                        vel[..., 1]], -1)
    track = torch.cumsum(_rotate_inverse_yaw(cos, sin, step), -2)
    root = torch.stack([track[..., 0], data[..., 3], track[..., 2]], -1)
    local = data[..., 4:(n_joints - 1) * 3 + 4].reshape(
        *data.shape[:-1], n_joints - 1, 3)
    local = _rotate_inverse_yaw(cos[..., None], sin[..., None], local)
    planar = torch.stack([track[..., 0], torch.zeros_like(track[..., 0]),
                          track[..., 2]], -1)
    joints = torch.cat([root[..., None, :], local + planar[..., None, :]], -2)
    return joints.masked_fill(~mask[..., None, None], 0.0)


def rest_offsets() -> np.ndarray:
    """SMPL_OFFSETS summed into rest-pose joints and differenced again, in
    f32, as the rest pose is stored."""
    rest = np.zeros_like(SMPL_OFFSETS)
    for j in range(1, len(SMPL_PARENTS)):
        rest[j] = rest[SMPL_PARENTS[j]] + SMPL_OFFSETS[j]
    return np.stack([rest[0]] + [rest[j] - rest[SMPL_PARENTS[j]]
                                 for j in range(1, len(SMPL_PARENTS))])


def _rot6d(d6):
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / torch.linalg.vector_norm(a2, dim=-1, keepdim=True)
    return torch.stack([b1, b2, _cross(b1, b2)], dim=-2)


def fk_joints(feats, mask, mode):
    """[B, T, 150] -> [B, T, 24, 3]; frames outside the mask are zero (their
    zero rot6d rows have no rotation)."""
    B, T, _ = feats.shape
    x = rounded(feats, mode).reshape(B * T, 25, 6)
    rot = _rot6d(x[:, :24])
    rel = torch.as_tensor(rest_offsets(), device=feats.device)
    glob_rot, glob_pos = [rot[:, 0]], [rel[0].expand(B * T, 3)]
    for j in range(1, 24):
        p = SMPL_PARENTS[j]
        glob_rot.append(matmul(glob_rot[p], rot[:, j], mode))
        off = matmul(glob_rot[p], rel[j].expand(B * T, 3)[..., None],
                     mode)[..., 0]
        glob_pos.append(off + glob_pos[p])
    pos = torch.stack(glob_pos, 1) + x[:, 24, None, :3]
    pos = pos.reshape(B, T, 24, 3)
    return pos.masked_fill(~mask[..., None, None], 0.0)
