"""HumanML3D 263-dim feature decode (port of ``recover_root_rot_pos`` and
``recover_from_ric`` from ``mld_tpu/data/humanml/motion_process.py``).

Feature layout (nfeats = 4 + (J-1)*3 + (J-1)*6 + J*3 + 4; 263 for J=22):
  [root_rot_vel(1), root_lin_vel_xz(2), root_y(1),
   ric(J-1 x 3), rot6d(J-1 x 6), local_vel(J x 3), foot_contact(4)]

Decoding is two cumulative sums plus batched quaternion rotations.
Parity target: reference mld/data/humanml/scripts/motion_process.py:169-430.
"""
from __future__ import annotations

import torch

from mld_tpu_torch.ops.quaternion import qinv, qrot


def recover_root_rot_pos(data: torch.Tensor):
    """data (..., T, nfeats) -> (r_rot_quat (..., T, 4), r_pos (..., T, 3))."""
    rot_vel = data[..., 0]
    # yaw angle at frame t = sum of rot_vel over frames < t
    r_rot_ang = torch.cumsum(
        torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], -1),
        -1)
    cos, sin = torch.cos(r_rot_ang), torch.sin(r_rot_ang)
    zero = torch.zeros_like(cos)
    r_rot_quat = torch.stack([cos, zero, sin, zero], dim=-1)

    # planar displacement of frame t comes from velocity stored at frame t-1
    vel_xz = data[..., :-1, 1:3]
    vel_xz = torch.cat([torch.zeros_like(vel_xz[..., :1, :]), vel_xz], -2)
    step = torch.stack([vel_xz[..., 0], torch.zeros_like(vel_xz[..., 0]),
                        vel_xz[..., 1]], dim=-1)
    # rotate the per-frame step into the world frame, then integrate
    r_pos = torch.cumsum(qrot(qinv(r_rot_quat), step), dim=-2)
    r_pos = torch.cat([r_pos[..., 0:1], data[..., 3:4], r_pos[..., 2:3]], -1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """Rotation-invariant local positions + root track -> global joints.
    data (..., T, nfeats) -> joints (..., T, J, 3)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4:(joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    positions = qrot(qinv(r_rot_quat)[..., None, :], positions)
    # add the planar root track; y stays untouched
    offset = torch.cat([r_pos[..., 0:1], torch.zeros_like(r_pos[..., 1:2]),
                        r_pos[..., 2:3]], -1)
    positions = positions + offset[..., None, :]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)
