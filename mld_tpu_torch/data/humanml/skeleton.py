"""Kinematic-chain forward and inverse kinematics (the torch / numpy twin
of ``mld_tpu/data/humanml/skeleton.py``, for the feature encoder).

FK runs in torch over f32 tensors, as the original runs in jax.numpy (whose
default dtype is f32); IK runs on host numpy and does its quaternion
products in f32 torch where the original does them in jax.numpy, so both
round at the same points. Parity target: reference
mld/data/humanml/common/skeleton.py:4-196.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d

from mld_tpu_torch.ops.quaternion import qbetween, qinv, qmul, qrot
from .param_util import parents_from_chains


def f32(a) -> torch.Tensor:
    """A host array as the f32 tensor jax.numpy would make of it."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


class Skeleton:
    """Skeleton with unit offset directions and kinematic chains.

    offsets_raw: (J, 3) unit direction of each joint from its parent.
    chains: list of joint-index chains, root first.
    """

    def __init__(self, offsets_raw: np.ndarray, chains):
        self.offsets_raw = np.asarray(offsets_raw, dtype=np.float32)
        self.chains = chains
        self.num_joints = len(self.offsets_raw)
        self.parents = parents_from_chains(self.num_joints, chains)
        self._offsets = None

    def set_offsets(self, offsets: np.ndarray):
        self._offsets = np.asarray(offsets, dtype=np.float32)

    def offsets_from_joints(self, joints: np.ndarray) -> np.ndarray:
        """Scale unit offsets by bone lengths measured from one pose."""
        offsets = self.offsets_raw.copy()
        for i in range(1, self.num_joints):
            bone = np.linalg.norm(joints[i] - joints[self.parents[i]])
            offsets[i] = bone * offsets[i]
        self._offsets = offsets
        return offsets

    @property
    def offsets(self) -> np.ndarray:
        if self._offsets is None:
            raise ValueError("call set_offsets or offsets_from_joints first")
        return self._offsets

    def forward_kinematics(self, quat_params: torch.Tensor,
                           root_pos: torch.Tensor,
                           do_root_rot: bool = True) -> torch.Tensor:
        """quat_params (B, J, 4), root_pos (B, 3) -> joints (B, J, 3)."""
        offsets = torch.as_tensor(self.offsets)
        B = quat_params.shape[0]
        joints = torch.zeros(quat_params.shape[:-1] + (3,),
                             dtype=quat_params.dtype)
        joints[:, 0] = root_pos
        for chain in self.chains:
            if do_root_rot:
                rot = quat_params[:, 0]
            else:
                rot = quat_params.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(B, 4)
            for i in range(1, len(chain)):
                rot = qmul(rot, quat_params[:, chain[i]])
                offset_vec = offsets[chain[i]].expand(B, 3)
                joints[:, chain[i]] = (qrot(rot, offset_vec)
                                       + joints[:, chain[i - 1]])
        return joints

    def inverse_kinematics_np(self, joints: np.ndarray, face_joint_idx,
                              smooth_forward: bool = False) -> np.ndarray:
        """joints (T, J, 3) -> local quaternions (T, J, 4): the root faces
        Z+ (from the hip / shoulder axes), each child aligns its unit
        offset with the observed bone."""
        l_hip, r_hip, sdr_r, sdr_l = face_joint_idx
        across = (joints[:, r_hip] - joints[:, l_hip]) + (
            joints[:, sdr_r] - joints[:, sdr_l])
        across = across / np.linalg.norm(across, axis=-1, keepdims=True)

        forward = np.cross(np.array([[0.0, 1.0, 0.0]]), across, axis=-1)
        if smooth_forward:
            forward = gaussian_filter1d(forward, 20, axis=0, mode="nearest")
        forward = forward / np.linalg.norm(forward, axis=-1, keepdims=True)

        target = np.broadcast_to(np.array([0.0, 0.0, 1.0]), forward.shape)
        root_quat = qbetween(f32(forward), f32(target)).numpy()
        root_quat[0] = np.array([1.0, 0.0, 0.0, 0.0])

        quat_params = np.zeros(joints.shape[:-1] + (4,))
        quat_params[:, 0] = root_quat
        T = len(joints)
        for chain in self.chains:
            rot = root_quat
            for j in range(len(chain) - 1):
                u = np.broadcast_to(self.offsets_raw[chain[j + 1]], (T, 3))
                v = joints[:, chain[j + 1]] - joints[:, chain[j]]
                v = v / np.linalg.norm(v, axis=-1, keepdims=True)
                rot_u_v = qbetween(f32(u), f32(v))
                rot_loc = qmul(qinv(f32(rot)), rot_u_v).numpy()
                quat_params[:, chain[j + 1]] = rot_loc
                rot = qmul(f32(rot), f32(rot_loc)).numpy()
        return quat_params
