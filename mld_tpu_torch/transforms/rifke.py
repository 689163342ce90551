"""Rifke: rotation-invariant forward-kinematics features (the torch twin of
``mld_tpu/transforms/rifke.py``, held to it by ``tests/test_torch_eval.py``).

Parity target: mld/transforms/joints2jfeats/rifke.py:11-142 +
joints2jfeats/tools.py (get_forward_direction, get_floor softmin). Used by
the Temos APE/AVE metrics (metrics/compute.py).
"""
from __future__ import annotations

import torch

HUMANML3D_JOINTS = [
    "root", "RH", "LH", "BP", "RK", "LK", "BT", "RMrot", "LMrot", "BLN",
    "RF", "LF", "BMN", "RSI", "LSI", "BUN", "RS", "LS", "RE", "LE", "RW",
    "LW",
]

MMM_JOINTS = [
    "root", "BP", "BT", "BLN", "BUN", "LS", "LE", "LW", "RS", "RE", "RW",
    "LH", "LK", "LA", "LMrot", "LF", "RH", "RK", "RA", "RMrot", "RF",
]

_JOINT_NAMES = {"humanml3d": HUMANML3D_JOINTS, "mmm": MMM_JOINTS,
                "mmmns": MMM_JOINTS}


def matrix_of_angles(cos, sin, inv=False):
    """2x2 rotation matrices from cos/sin stacks (geometry.py:22-28)."""
    sin = -sin if inv else sin
    row1 = torch.stack([cos, -sin], dim=-1)
    row2 = torch.stack([sin, cos], dim=-1)
    return torch.stack([row1, row2], dim=-2)


def _softmin(x, softness=0.5, dim=-1):
    maxi = torch.amax(-x, dim=dim)
    mini = torch.amin(-x, dim=dim)
    return -(maxi + torch.log(softness + torch.exp(mini - maxi)))


def get_floor(poses, jointstype="humanml3d"):
    names = _JOINT_NAMES[jointstype]
    idx = [names.index(n) for n in ("LMrot", "LF", "RMrot", "RF")]
    foot_heights = torch.amin(poses[..., idx, 1], dim=-1)
    return _softmin(foot_heights, softness=0.5, dim=-1)


def get_forward_direction(poses, jointstype="humanml3d"):
    names = _JOINT_NAMES[jointstype]
    LS, RS = names.index("LS"), names.index("RS")
    LH, RH = names.index("LH"), names.index("RH")
    across = (poses[..., RH, :] - poses[..., LH, :]
              + poses[..., RS, :] - poses[..., LS, :])
    forward = torch.stack([-across[..., 2], across[..., 0]], dim=-1)
    return forward / torch.linalg.norm(forward, dim=-1, keepdim=True)


def _diff_from_zero(x, dim):
    """diff along `dim` with a zero first entry, same length as x."""
    d = torch.diff(x, dim=dim)
    return torch.cat([torch.zeros_like(d.narrow(dim, 0, 1)), d], dim=dim)


class Rifke:
    """joints [..., T, J, 3] <-> features [..., T, 1 + (J-1)*3 + 1 + 2]."""

    def __init__(self, jointstype: str = "humanml3d"):
        self.jointstype = jointstype

    def __call__(self, joints):
        poses = joints.clone()
        floor = get_floor(poses, self.jointstype)  # [..., ] scalar over time
        poses[..., 1] -= floor[..., None, None]

        translation = poses[..., 0, :]
        root_y = translation[..., 1]
        trajectory = translation[..., [0, 2]]
        poses = poses[..., 1:, :].clone()
        poses[..., [0, 2]] -= trajectory[..., None, :]

        vel_trajectory = _diff_from_zero(trajectory, -2)

        forward = get_forward_direction(poses, self.jointstype)
        angles = torch.atan2(forward[..., 0], forward[..., 1])
        vel_angles = _diff_from_zero(angles, -1)

        sin, cos = forward[..., 0], forward[..., 1]
        rot_inv = matrix_of_angles(cos, sin, inv=True)

        poses_local = torch.einsum("...lj,...jk->...lk", poses[..., [0, 2]],
                                   rot_inv)
        poses_local = torch.stack(
            [poses_local[..., 0], poses[..., 1], poses_local[..., 1]],
            dim=-1)
        poses_features = poses_local.reshape(poses_local.shape[:-2] + (-1,))

        vel_traj_local = torch.einsum("...j,...jk->...k", vel_trajectory,
                                      rot_inv)
        return torch.cat(
            [root_y[..., None], poses_features, vel_angles[..., None],
             vel_traj_local], dim=-1)

    @staticmethod
    def extract(features):
        root_y = features[..., 0]
        poses_features = features[..., 1:-3]
        vel_angles = features[..., -3]
        vel_trajectory_local = features[..., -2:]
        return root_y, poses_features, vel_angles, vel_trajectory_local

    def inverse(self, features):
        """features -> joints [..., T, J, 3] (a canonical frame)."""
        return self.canonical(features)[0]

    def canonical(self, features):
        """features -> (poses [..., T, J, 3], poses_local [..., T, J-1, 3],
        root_y [..., T], trajectory [..., T, 2]): the inverse with the
        pieces the APE/AVE metrics read (``metrics/compute.py``)."""
        root_y, poses_features, vel_angles, vel_traj_local = self.extract(
            features)
        angles = torch.cumsum(vel_angles, dim=-1)
        angles = angles - angles[..., :1]
        rotations = matrix_of_angles(torch.cos(angles), torch.sin(angles))

        poses_local = poses_features.reshape(
            poses_features.shape[:-1] + (-1, 3))
        poses = torch.einsum("...lj,...jk->...lk", poses_local[..., [0, 2]],
                             rotations)
        poses = torch.stack([poses[..., 0], poses_local[..., 1],
                             poses[..., 1]], dim=-1)

        vel_traj = torch.einsum("...j,...jk->...k", vel_traj_local,
                                rotations)
        trajectory = torch.cumsum(vel_traj, dim=-2)
        trajectory = trajectory - trajectory[..., :1, :]

        poses = torch.cat([0 * poses[..., :1, :], poses], dim=-2)
        poses[..., 0, 1] = root_y
        poses[..., [0, 2]] += trajectory[..., None, :]
        return poses, poses_local, root_y, trajectory
