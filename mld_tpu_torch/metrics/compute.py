"""Temos APE/AVE metrics (mld/models/metrics/compute.py:15-196 parity): the
twin of ``mld_tpu/metrics/compute.py``, whose Rifke transform runs in torch
here (``transforms/rifke.py``) where the JAX package runs it in jax.numpy;
the accumulation is the same numpy. Held to the original by
``tests/test_torch_eval.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from mld_tpu_torch.transforms.rifke import Rifke


def _variance(x: np.ndarray, length: int, axis=0) -> np.ndarray:
    """Unbiased-by-length variance (metrics/utils variance semantics)."""
    mean = x.mean(axis)
    out = (x - mean) ** 2
    return out.sum(axis) / (length - 1)


class ComputeMetrics:
    """APE/AVE on root/trajectory/pose/joints in the Rifke canonical frame,
    the transform in f32 on the host."""

    def __init__(self, njoints: int = 22, jointstype: str = "humanml3d",
                 force_in_meter: bool = True):
        self.njoints = njoints
        self.jointstype = jointstype
        self.force_in_meter = force_in_meter
        self.rifke = Rifke(jointstype=jointstype)
        self.reset()

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.APE_root = 0.0
        self.APE_traj = 0.0
        self.APE_pose = np.zeros(self.njoints - 1)
        self.APE_joints = np.zeros(self.njoints)
        self.AVE_root = 0.0
        self.AVE_traj = 0.0
        self.AVE_pose = np.zeros(self.njoints - 1)
        self.AVE_joints = np.zeros(self.njoints)

    @torch.no_grad()
    def _transform(self, joints):
        """[B, T, J, 3] -> (poses, poses_local, root, trajectory), numpy."""
        joints = torch.as_tensor(np.asarray(joints), dtype=torch.float32)
        poses, poses_local, root_y, trajectory = self.rifke.canonical(
            self.rifke(joints))
        root = torch.cat([trajectory[..., :, :1], root_y[..., None],
                          trajectory[..., :, 1:2]], dim=-1)
        out = (poses, poses_local, root, trajectory)
        if self.force_in_meter:
            factor = (1000.0 if self.jointstype == "mmm"
                      else 1000.0 * 0.75 / 480.0)
            out = tuple(x / factor for x in out)
        return tuple(x.numpy() for x in out)

    def update(self, jts_text, jts_ref, lengths):
        lengths = [int(x) for x in np.asarray(lengths)]
        self.count += sum(lengths)
        self.count_seq += len(lengths)
        pt, plt_, rt, tt = self._transform(jts_text)
        pr, plr, rr, tr = self._transform(jts_ref)

        l2 = lambda a, b, axis: np.linalg.norm(a - b, axis=axis)
        for i, L in enumerate(lengths):
            self.APE_root += l2(rt[i, :L], rr[i, :L], 1).sum()
            self.APE_pose += l2(plt_[i, :L], plr[i, :L], 2).sum(0)
            self.APE_traj += l2(tt[i, :L], tr[i, :L], 1).sum()
            self.APE_joints += l2(pt[i, :L], pr[i, :L], 2).sum(0)

            self.AVE_root += l2(_variance(rt[i, :L], L),
                                _variance(rr[i, :L], L), 0)
            self.AVE_traj += l2(_variance(tt[i, :L], L),
                                _variance(tr[i, :L], L), 0)
            self.AVE_pose += l2(_variance(plt_[i, :L], L),
                                _variance(plr[i, :L], L), 1)
            self.AVE_joints += l2(_variance(pt[i, :L], L),
                                  _variance(pr[i, :L], L), 1)

    def compute(self) -> dict:
        count, count_seq = max(self.count, 1), max(self.count_seq, 1)
        out = {
            "APE_root": self.APE_root / count,
            "APE_traj": self.APE_traj / count,
            "APE_mean_pose": self.APE_pose.mean() / count,
            "APE_mean_joints": self.APE_joints.mean() / count,
            "AVE_root": self.AVE_root / count_seq,
            "AVE_traj": self.AVE_traj / count_seq,
            "AVE_mean_pose": self.AVE_pose.mean() / count_seq,
            "AVE_mean_joints": self.AVE_joints.mean() / count_seq,
        }
        return {k: float(v) for k, v in out.items()}
