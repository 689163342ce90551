"""HumanML3D 263-dim feature codec (port of ``recover_root_rot_pos``,
``recover_from_ric`` and ``process_file`` from
``mld_tpu/data/humanml/motion_process.py``).

Feature layout (nfeats = 4 + (J-1)*3 + (J-1)*6 + J*3 + 4; 263 for J=22):
  [root_rot_vel(1), root_lin_vel_xz(2), root_y(1),
   ric(J-1 x 3), rot6d(J-1 x 6), local_vel(J x 3), foot_contact(4)]

Decoding is two cumulative sums plus batched quaternion rotations, on the
model's tensors. Encoding (``process_file``) is offline host work for the
synthetic corpus: numpy where the original is numpy, f32 torch where the
original runs jax.numpy, so the features round as the original's do.
Parity target: reference mld/data/humanml/scripts/motion_process.py:169-430.
"""
from __future__ import annotations

import numpy as np
import torch

from mld_tpu_torch.ops.quaternion import (qbetween, qinv, qmul, qrot,
                                          quaternion_to_cont6d)
from .param_util import (T2M_FACE_JOINT_IDX, T2M_FID_L, T2M_FID_R,
                         T2M_KINEMATIC_CHAIN, T2M_LOWER_LEG_IDX,
                         T2M_RAW_OFFSETS)
from .skeleton import Skeleton, f32


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


# --------------------------------------------------------------------- encode
def uniform_skeleton(positions: np.ndarray, tgt_offsets: np.ndarray,
                     raw_offsets=T2M_RAW_OFFSETS,
                     chains=T2M_KINEMATIC_CHAIN,
                     l_idx=T2M_LOWER_LEG_IDX,
                     face_joint_idx=T2M_FACE_JOINT_IDX) -> np.ndarray:
    """Retarget a joint sequence onto the canonical skeleton (leg-length
    scale + IK / FK)."""
    src = Skeleton(raw_offsets, chains)
    src_offset = src.offsets_from_joints(positions[0])
    l1, l2 = l_idx
    src_leg = np.abs(src_offset[l1]).max() + np.abs(src_offset[l2]).max()
    tgt_leg = np.abs(tgt_offsets[l1]).max() + np.abs(tgt_offsets[l2]).max()
    scale = tgt_leg / src_leg

    tgt_root_pos = positions[:, 0] * scale
    quat_params = src.inverse_kinematics_np(positions, face_joint_idx)
    src.set_offsets(tgt_offsets)
    return src.forward_kinematics(f32(quat_params), f32(tgt_root_pos)).numpy()


def _foot_detect(positions, thres, fid_l, fid_r):
    velfactor = np.array([thres, thres])
    d_l = np.sum((positions[1:, fid_l] - positions[:-1, fid_l]) ** 2, axis=-1)
    d_r = np.sum((positions[1:, fid_r] - positions[:-1, fid_r]) ** 2, axis=-1)
    return ((d_l < velfactor).astype(np.float64),
            (d_r < velfactor).astype(np.float64))


def process_file(positions: np.ndarray, feet_thre: float,
                 tgt_offsets: np.ndarray | None = None,
                 raw_offsets=T2M_RAW_OFFSETS,
                 chains=T2M_KINEMATIC_CHAIN,
                 l_idx=T2M_LOWER_LEG_IDX,
                 fid_r=T2M_FID_R, fid_l=T2M_FID_L,
                 face_joint_idx=T2M_FACE_JOINT_IDX,
                 do_uniform_skeleton: bool = True):
    """Joints (T, J, 3) -> (features (T-1, nfeats), global_positions,
    rifke_positions, l_velocity): optional retarget, floor / origin / Z+
    canonicalisation, foot contacts, IK (smoothed forward), cont6d, RIFKE
    local positions, root and joint velocities."""
    positions = np.asarray(positions, dtype=np.float64).copy()

    if do_uniform_skeleton and tgt_offsets is not None:
        positions = np.asarray(
            uniform_skeleton(positions, np.asarray(tgt_offsets), raw_offsets,
                             chains, l_idx, face_joint_idx),
            dtype=np.float64)

    # put on the floor, root XZ at the origin (first frame)
    positions[:, :, 1] -= positions.min(axis=0).min(axis=0)[1]
    root_pos_init = positions[0]
    positions = positions - root_pos_init[0] * np.array([1.0, 0.0, 1.0])
    root_pos_init = positions[0]

    # rotate so that the first pose faces Z+
    r_hip, l_hip, sdr_r, sdr_l = face_joint_idx
    across = (root_pos_init[r_hip] - root_pos_init[l_hip]) + (
        root_pos_init[sdr_r] - root_pos_init[sdr_l])
    across = across / np.linalg.norm(across)
    forward_init = np.cross(np.array([[0.0, 1.0, 0.0]]), across, axis=-1)
    forward_init = forward_init / np.linalg.norm(forward_init, axis=-1,
                                                 keepdims=True)
    root_quat_init = qbetween(f32(forward_init),
                              f32(np.array([[0.0, 0.0, 1.0]]))).numpy()
    root_quat_init = np.broadcast_to(root_quat_init,
                                     positions.shape[:-1] + (4,))
    positions = qrot(f32(root_quat_init), f32(positions)).numpy().astype(
        np.float64)

    global_positions = positions.copy()
    feet_l, feet_r = _foot_detect(positions, feet_thre, fid_l, fid_r)

    # cont6d through smoothed IK
    skel = Skeleton(raw_offsets, chains)
    quat_params = skel.inverse_kinematics_np(positions, face_joint_idx,
                                             smooth_forward=True)
    cont_6d_params = quaternion_to_cont6d(f32(quat_params)).numpy()
    r_rot = quat_params[:, 0].copy()

    # root linear velocity in the root frame, and the root's angular one
    velocity = (positions[1:, 0] - positions[:-1, 0]).copy()
    velocity = qrot(f32(r_rot[1:]), f32(velocity)).numpy()
    r_velocity = qmul(f32(r_rot[1:]), qinv(f32(r_rot[:-1]))).numpy()

    # RIFKE local positions: root-centred XZ, rotated into the root frame
    positions[..., 0] -= positions[:, 0:1, 0]
    positions[..., 2] -= positions[:, 0:1, 2]
    positions = qrot(f32(np.repeat(r_rot[:, None], positions.shape[1],
                                   axis=1)), f32(positions)).numpy()

    root_y = positions[:, 0, 1:2]
    r_velocity = np.arcsin(r_velocity[:, 2:3])
    l_velocity = velocity[:, [0, 2]]
    root_data = np.concatenate([r_velocity, l_velocity, root_y[:-1]], axis=-1)

    rot_data = cont_6d_params[:, 1:].reshape(len(cont_6d_params), -1)
    ric_data = positions[:, 1:].reshape(len(positions), -1)

    local_vel = qrot(f32(np.repeat(r_rot[:-1, None],
                                   global_positions.shape[1], axis=1)),
                     f32(global_positions[1:] - global_positions[:-1])
                     ).numpy()
    local_vel = local_vel.reshape(len(local_vel), -1)

    data = np.concatenate(
        [root_data, ric_data[:-1], rot_data[:-1], local_vel, feet_l, feet_r],
        axis=-1)
    return data, global_positions, positions, l_velocity
