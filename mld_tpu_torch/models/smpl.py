"""The SMPL body model's joints and linear blend skinning (port of
``mld_tpu/models/smpl.py``), the action-to-motion family's
``feats2joints``.

The reference takes the smplx package (mld/transforms/rotation2xyz.py:10-114).
Here the standard SMPL pickle is loaded when it exists; without it, a
24-joint forward-kinematics skeleton of the same topology
(``_APPROX_OFFSETS``) gives the joints, so the a2m paths run offline.
``vertices`` needs the asset.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from mld_tpu_torch.ops.rotation import rotation_6d_to_matrix
from mld_tpu_torch.utils import precision

SMPL_NUM_JOINTS = 24

# the SMPL kinematic tree (parent of each joint), the public model topology
SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21]

# rest-pose offsets from each joint's parent (metres, an approximate neutral
# body) of the offline skeleton; topology SMPL_PARENTS
_APPROX_OFFSETS = np.array([
    [0.0, 0.0, 0.0], [0.06, -0.09, -0.01], [-0.06, -0.09, -0.01],
    [0.0, 0.11, -0.01], [0.04, -0.38, 0.0], [-0.04, -0.38, 0.0],
    [0.0, 0.14, 0.0], [-0.01, -0.4, -0.04], [0.01, -0.4, -0.04],
    [0.0, 0.05, 0.02], [0.03, -0.06, 0.12], [-0.03, -0.06, 0.12],
    [0.0, 0.21, -0.03], [0.08, 0.11, -0.02], [-0.08, 0.11, -0.02],
    [0.0, 0.07, 0.03], [0.11, 0.05, -0.02], [-0.11, 0.05, -0.02],
    [0.26, -0.01, -0.02], [-0.26, -0.01, -0.02], [0.25, 0.01, 0.0],
    [-0.25, 0.01, 0.0], [0.09, -0.01, -0.01], [-0.09, -0.01, -0.01],
], dtype=np.float32)


def _APPROX_OFFSETS_ABS() -> np.ndarray:
    """The approximate offsets accumulated into rest-pose joints [24, 3]."""
    joints = np.zeros_like(_APPROX_OFFSETS)
    for j in range(1, SMPL_NUM_JOINTS):
        joints[j] = joints[SMPL_PARENTS[j]] + _APPROX_OFFSETS[j]
    return joints


def _rest_offsets(joints_rest, parents) -> np.ndarray:
    """Rest-pose joints [J, 3] -> each joint's offset from its parent (the
    root's own position first)."""
    joints_rest = np.asarray(joints_rest)
    return np.stack([joints_rest[0]] + [
        joints_rest[j] - joints_rest[parents[j]]
        for j in range(1, len(parents))])


def _fk_from_matrices(rot_mats: torch.Tensor, rel: torch.Tensor, parents):
    """Forward kinematics over the tree, one joint a step: rot_mats
    [B, J, 3, 3], rel [J, 3] (``_rest_offsets``) -> (positions [B, J, 3],
    global rotations [B, J, 3, 3]). Its products take the matmul
    precision in force, as the JAX package's ``jnp.matmul`` and ``einsum``
    inherit it (``precision.matmul``)."""
    B = rot_mats.shape[0]
    mode = precision.arithmetic()
    glob_rot = [rot_mats[:, 0]]
    glob_pos = [rel[0].expand(B, 3)]
    for j in range(1, len(parents)):
        p = parents[j]
        if mode == "f32":
            glob_rot.append(glob_rot[p] @ rot_mats[:, j])
            offset = torch.einsum("bij,j->bi", glob_rot[p], rel[j])
        else:
            glob_rot.append(precision.matmul(glob_rot[p], rot_mats[:, j],
                                             mode))
            offset = precision.matmul(glob_rot[p],
                                      rel[j].expand(B, 3)[..., None],
                                      mode)[..., 0]
        glob_pos.append(offset + glob_pos[p])
    return torch.stack(glob_pos, dim=1), torch.stack(glob_rot, dim=1)


class SMPLLayer:
    """Minimal SMPL: shape blendshapes and LBS. Loads the SMPL pickle at
    `model_path` (chumpy-free fields) when it exists; `joints` works with
    the offline skeleton too, `vertices` needs the asset. Its arrays live on
    `device`."""

    def __init__(self, model_path: Optional[str] = None, device="cpu"):
        self.device = torch.device(device)
        self.has_asset = False
        self.parents = SMPL_PARENTS
        if model_path and os.path.exists(model_path):
            self._load(model_path)
        else:
            self.joints_rest = _APPROX_OFFSETS_ABS()
        # the tree's offsets live on the device once: the fitter runs FK
        # hundreds of times a fit, and each copy from the host would wait
        self.rest_offsets = torch.as_tensor(
            _rest_offsets(self.joints_rest, self.parents),
            device=self.device)

    def _load(self, path: str):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")

        def npy(x):
            try:
                return np.asarray(x.todense(), np.float32)  # sparse
            except AttributeError:
                return np.asarray(x, np.float32)

        def dev(x):
            return torch.as_tensor(npy(x), device=self.device)

        self.v_template = dev(data["v_template"])
        self.shapedirs = dev(data["shapedirs"])
        self.J_regressor = dev(data["J_regressor"])
        self.weights = dev(data["weights"])
        self.posedirs = dev(data["posedirs"])
        kt = np.asarray(data["kintree_table"])
        self.parents = [-1] + list(kt[0][1:].astype(int))
        self.joints_rest = npy(data["J_regressor"]) @ npy(data["v_template"])
        if "f" in data:  # triangle faces, for rendering and export
            self.faces = np.asarray(data["f"], np.int64)
        self.has_asset = True

    def joints(self, rot6d: torch.Tensor,
               translation: Optional[torch.Tensor] = None) -> torch.Tensor:
        """rot6d [B, 24, 6] (+ translation [B, 3]) -> joints [B, 24, 3]."""
        rot_mats = rotation_6d_to_matrix(rot6d)
        rel = self.rest_offsets.to(rot_mats.device, rot_mats.dtype)
        pos, _ = _fk_from_matrices(rot_mats, rel, self.parents)
        if translation is not None:
            pos = pos + translation[:, None, :]
        return pos

    def vertices(self, rot6d: torch.Tensor,
                 translation: Optional[torch.Tensor] = None,
                 betas: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full LBS -> [B, V, 3]. Needs the SMPL asset."""
        if not self.has_asset:
            raise RuntimeError("SMPL asset required for vertices")
        B = rot6d.shape[0]
        # the template for every pose: without betas, JAX's layer keeps a
        # batch of 1 here and its root row then fails to stack with the
        # others for B > 1 (mld_tpu/models/smpl.py:106-137)
        v = self.v_template[None].expand(B, -1, -1)
        if betas is not None:
            v = v + torch.einsum("bl,vcl->bvc", betas, self.shapedirs)
        joints_rest = torch.einsum("jv,bvc->bjc", self.J_regressor, v)

        rot_mats = rotation_6d_to_matrix(rot6d)            # [B, 24, 3, 3]
        ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
        v = v + torch.einsum("bp,vcp->bvc", pose_feature, self.posedirs)

        J = len(self.parents)
        rel = torch.cat([joints_rest[:, :1],
                         joints_rest[:, 1:]
                         - joints_rest[:, self.parents[1:]]], dim=1)
        glob_rot = [rot_mats[:, 0]]
        glob_pos = [rel[:, 0]]
        for j in range(1, J):
            p = self.parents[j]
            glob_rot.append(glob_rot[p] @ rot_mats[:, j])
            glob_pos.append(torch.einsum("bij,bj->bi", glob_rot[p],
                                         rel[:, j]) + glob_pos[p])
        R = torch.stack(glob_rot, 1)                       # [B, J, 3, 3]
        t = torch.stack(glob_pos, 1)                       # [B, J, 3]
        # remove the rest-pose joint locations (the LBS correction)
        t_corr = t - torch.einsum("bjik,bjk->bji", R, joints_rest)

        W = self.weights                                   # [V, J]
        R_v = torch.einsum("vj,bjik->bvik", W, R)
        t_v = torch.einsum("vj,bji->bvi", W, t_corr)
        verts = torch.einsum("bvik,bvk->bvi", R_v, v) + t_v
        if translation is not None:
            verts = verts + translation[:, None, :]
        return verts


class Rotation2Joints:
    """feats2joints of the a2m features (reference mld.py:119-143):
    [B, T, 150] = 24 rot6d rows + one translation row (its first 3 of 6)
    -> joints [B, T, 24, 3]; `vertstrans` adds the root translation. With
    `mask` [B, T] the joints are zero outside it (zero rot6d rows there
    would give NaN, which the JAX package's product with the mask keeps)."""

    def __init__(self, smpl_path: Optional[str] = None, device="cpu"):
        self.smpl = SMPLLayer(smpl_path, device)

    def __call__(self, feats: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 vertstrans: bool = True) -> torch.Tensor:
        B, T, _ = feats.shape
        x = feats.reshape(B * T, 25, 6)
        joints = self.smpl.joints(x[:, :24],
                                  x[:, 24, :3] if vertstrans else None)
        joints = joints.reshape(B, T, 24, 3)
        if mask is not None:
            joints = joints.masked_fill(~mask[..., None, None], 0.0)
        return joints
