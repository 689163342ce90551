"""Joints -> SMPL pose fitting over all frames at once (port of
``mld_tpu/transforms/fitting.py``).

The reference fits each frame with LBFGS (SMPLify3D, fit.py:104-280); here
one optimisation runs over every frame: per-frame rot6d poses and
translation, with joint error + temporal smoothness + a pull to the identity
pose (+ the GMM pose prior when ``gmm_08.pkl`` sits beside the SMPL
pickle). Two phases, as in JAX:

1. Adam on a cosine-decayed learning rate, written out by hand in optax's
   f32 arithmetic (b1 0.9, b2 0.999, eps 1e-8 outside the square root):
   update ``i`` takes the schedule at count ``i``, and ``loss_curve[i]`` is
   the loss at the parameters before update ``i``. The losses go into a
   tensor on the device, so the loop never waits for the card.
2. A per-frame Levenberg-Marquardt polish: each frame's 147 parameters
   (24 x rot6d + translation) take Gauss-Newton steps on its 66 joint
   errors plus a weak anchor to the Adam iterate, through
   ``torch.func.vmap(jacfwd)`` and a Cholesky solve batched over the
   frames. A step is kept where the frame's cost falls (its lambda halves)
   and dropped otherwise (lambda x 2.5); a system Cholesky cannot factor
   is a dropped step, as JAX's NaN solve is, never an exception.

Everything runs on `device` under ``matmul_precision("highest")`` (no
TF32): the Gram-Schmidt, the FK chain and the Cholesky are held to JAX's
f32.
"""
from __future__ import annotations

import math
import os
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from mld_tpu_torch.models.mld import resolve_device
from mld_tpu_torch.models.smpl import SMPL_NUM_JOINTS, SMPLLayer
from mld_tpu_torch.ops.rotation import (matrix_to_rotation_6d,
                                        rotation_6d_to_axis_angle)
from mld_tpu_torch.utils.precision import matmul_precision

# HumanML3D's 22 joints are the first 22 SMPL joints, in the same order
_N_FIT_JOINTS = 22
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _identity_rot6d(B: int, device=None) -> torch.Tensor:
    eye = matrix_to_rotation_6d(torch.eye(3, device=device)[None])  # [1, 6]
    return eye[None].expand(B, SMPL_NUM_JOINTS, 6).clone()


def cosine_decay(lr: float, steps: int, alpha: float) -> np.ndarray:
    """optax.cosine_decay_schedule(lr, steps, alpha) at counts 0..steps-1,
    in f32: lr * ((1 - alpha) * 0.5 * (1 + cos(pi * i / steps)) + alpha).
    The cosine of the f32 argument is taken in f64 and rounded (XLA's f32
    cosine is not correctly rounded either: the two differ by at most one
    f32 ulp)."""
    f32 = np.float32
    arg = f32(np.pi) * np.arange(steps, dtype=f32) / f32(steps)
    cos = np.cos(arg.astype(np.float64)).astype(f32)
    decayed = f32(1 - alpha) * (f32(0.5) * (f32(1) + cos)) + f32(alpha)
    return (f32(lr) * decayed).astype(f32)


class GMMPosePrior:
    """Max-mixture Gaussian pose prior (joints2rots/prior.py:52): loads
    ``gmm_08.pkl`` (means [K, 69], covars [K, 69, 69], weights [K]) over the
    23 body joints' axis-angle pose; the energy is the smallest weighted
    Mahalanobis distance over the components, averaged over the frames.
    The inverses and log-determinants are taken on the host in f32, as JAX
    takes them."""

    def __init__(self, gmm_path: Optional[str] = None, device="cpu"):
        self.available = False
        if gmm_path and os.path.exists(gmm_path):
            with open(gmm_path, "rb") as f:
                gmm = pickle.load(f, encoding="latin1")
            means = np.asarray(gmm["means"], np.float32)
            covs = np.asarray(gmm["covars"], np.float32)
            weights = np.asarray(gmm["weights"], np.float32)
            _, logdet = np.linalg.slogdet(covs)
            self.means = torch.as_tensor(means, device=device)
            self.precisions = torch.as_tensor(np.linalg.inv(covs),
                                              device=device)
            # constant a component: -log w + 0.5 log|Sigma|
            self.const = torch.as_tensor(-np.log(weights) + 0.5 * logdet,
                                         device=device)
            self.available = True

    def __call__(self, pose_aa_body: torch.Tensor) -> torch.Tensor:
        """pose_aa_body [T, 69] axis-angle (joints 1..23) -> scalar."""
        diff = pose_aa_body[:, None, :] - self.means[None]       # [T, K, 69]
        maha = 0.5 * torch.einsum("tki,kij,tkj->tk", diff, self.precisions,
                                  diff)
        return (maha + self.const[None]).min(dim=1).values.mean()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchedSMPLFitter:
    """joints [T, >=22, 3] -> SMPL rot6d [T, 24, 6] + translation [T, 3],
    every frame at once, on `device` (the card unless the caller names
    another; raises when the card is asked for and none is visible)."""

    def __init__(self, smpl_path: Optional[str] = None,
                 num_steps: int = 300, lr: float = 0.03,
                 w_smooth: float = 1.0, w_reg: float = 1e-3,
                 gmm_path: Optional[str] = None, w_prior: float = 1e-4,
                 polish_steps: int = 25, polish_anchor: float = 1e-4,
                 device="cuda"):
        self.device = resolve_device(device)
        self.smpl = SMPLLayer(smpl_path, self.device)
        self.num_steps = num_steps
        self.lr = lr
        self.w_smooth = w_smooth
        self.w_reg = w_reg
        self.w_prior = w_prior
        self.polish_steps = polish_steps
        self.polish_anchor = polish_anchor
        if gmm_path is None and smpl_path:
            gmm_path = os.path.join(os.path.dirname(smpl_path), "gmm_08.pkl")
        self.prior = GMMPosePrior(gmm_path, self.device)

    # ------------------------------------------------------ Adam, all frames
    def objective(self, rot6d: torch.Tensor, trans: torch.Tensor,
                  target: torch.Tensor, ident: torch.Tensor) -> torch.Tensor:
        """The Adam phase's loss; `ident` is ``_identity_rot6d(T)``."""
        joints = self.smpl.joints(rot6d, trans)                  # [T, 24, 3]
        data = ((joints[:, :_N_FIT_JOINTS] - target[:, :_N_FIT_JOINTS])
                ** 2).sum(-1).mean()
        smooth = (((rot6d[1:] - rot6d[:-1]) ** 2).sum((-1, -2)).mean()
                  + ((trans[1:] - trans[:-1]) ** 2).sum(-1).mean())
        reg = ((rot6d - ident) ** 2).sum((-1, -2)).mean()
        total = data + self.w_smooth * smooth + self.w_reg * reg
        if self.prior.available:
            pose_aa = rotation_6d_to_axis_angle(rot6d[:, 1:])  # body joints
            total = total + self.w_prior * self.prior(
                pose_aa.reshape(pose_aa.shape[0], -1))
        return total

    def adam(self, target: torch.Tensor):
        """target [T, 22, 3] on the device -> ({rot6d, trans}, losses
        [num_steps]): Adam from the identity pose at the root track."""
        T = target.shape[0]
        ident = _identity_rot6d(T, self.device)
        params = [ident.clone().requires_grad_(True),
                  target[:, 0].clone().requires_grad_(True)]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        f32 = np.float32
        count = np.arange(1, self.num_steps + 1, dtype=f32)
        # what optax's update i reads: -lr at count i, 1 - b ** (i + 1)
        neg_lr = torch.as_tensor(
            -cosine_decay(self.lr, self.num_steps, 0.04), device=self.device)
        bc1 = torch.as_tensor(f32(1) - f32(_B1) ** count, device=self.device)
        bc2 = torch.as_tensor(f32(1) - f32(_B2) ** count, device=self.device)
        losses = torch.empty(self.num_steps, device=self.device)
        for i in range(self.num_steps):
            with torch.enable_grad():
                loss = self.objective(*params, target, ident)
                grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                losses[i] = loss
                for p, g, m, v in zip(params, grads, mu, nu):
                    m.copy_((1 - _B1) * g + _B1 * m)
                    v.copy_((1 - _B2) * (g * g) + _B2 * v)
                    u = (m / bc1[i]) / (torch.sqrt(v / bc2[i]) + _EPS)
                    p.add_(neg_lr[i] * u)
        return {"rot6d": params[0].detach(),
                "trans": params[1].detach()}, losses

    # ------------------------------------------------- the per-frame polish
    def frame_residual(self, p: torch.Tensor, target: torch.Tensor,
                       p0: torch.Tensor) -> torch.Tensor:
        """One frame's Gauss-Newton residual: p [147] = rot6d (24 x 6) +
        translation, target [22, 3], p0 the Adam iterate -> [66 + 147]: the
        joint errors and sqrt(anchor) * (p - p0). The anchor holds the
        directions no target constrains (the hands) and keeps what the
        smoothness term of the first phase bought."""
        rot6d = p[: SMPL_NUM_JOINTS * 6].reshape(SMPL_NUM_JOINTS, 6)
        trans = p[SMPL_NUM_JOINTS * 6:]
        joints = self.smpl.joints(rot6d[None], trans[None])[0]
        data = (joints[:_N_FIT_JOINTS] - target).reshape(-1)
        anchor = math.sqrt(self.polish_anchor) * (p - p0)
        return torch.cat([data, anchor])

    def _residual_and_aux(self, p, target, p0):
        r = self.frame_residual(p, target, p0)
        return r, r

    def lm_step(self, p: torch.Tensor, lam: torch.Tensor,
                targets: torch.Tensor, p0: torch.Tensor):
        """One Levenberg-Marquardt step of every frame: p [T, 147], lam [T]
        -> (p, lam, jacobian [T, 213, 147], delta [T, 147]). H = J^T J +
        lam I is factored by Cholesky; a frame whose H does not factor, or
        whose step does not lower its cost, keeps p and takes lam x 2.5;
        the others take the step and lam x 0.5."""
        J, r = torch.func.vmap(torch.func.jacfwd(
            self._residual_and_aux, has_aux=True))(p, targets, p0)
        Jt = J.transpose(1, 2)
        eye = torch.eye(p.shape[1], device=p.device, dtype=p.dtype)
        H = Jt @ J + lam[:, None, None] * eye
        g = (Jt @ r[..., None])[..., 0]
        L, info = torch.linalg.cholesky_ex(H)
        delta = torch.cholesky_solve(g[..., None], L)[..., 0]
        p_new = p - delta
        cost = (r * r).sum(-1)
        r_new = torch.func.vmap(self.frame_residual)(p_new, targets, p0)
        better = (info == 0) & ((r_new * r_new).sum(-1) < cost)
        p = torch.where(better[:, None], p_new, p)
        lam = torch.where(better, lam * 0.5, lam * 2.5)
        return p, lam, J, delta

    def polish(self, params: Dict[str, torch.Tensor],
               targets: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`polish_steps` LM steps from the Adam iterate, every frame with
        its own lambda (from 1e-3)."""
        T = params["trans"].shape[0]
        p0 = torch.cat([params["rot6d"].reshape(T, -1), params["trans"]], -1)
        p = p0
        lam = torch.full((T,), 1e-3, device=p0.device)
        for _ in range(self.polish_steps):
            p, lam, _, _ = self.lm_step(p, lam, targets, p0)
        return {"rot6d": p[:, : SMPL_NUM_JOINTS * 6].reshape(
                    T, SMPL_NUM_JOINTS, 6),
                "trans": p[:, SMPL_NUM_JOINTS * 6:]}

    # ---------------------------------------------------------------- entry
    def fit(self, joints: np.ndarray) -> Dict[str, np.ndarray]:
        """joints [T, J>=22, 3] -> {rot6d [T, 24, 6], trans [T, 3],
        joints_fit [T, 24, 3], loss_curve [num_steps]} as numpy, plus the
        seconds of each phase (`adam_s`, `polish_s`: host clock around work
        that ends in a device synchronisation)."""
        if joints.shape[1] < _N_FIT_JOINTS:
            raise ValueError("need at least 22 joints")
        with matmul_precision("highest"), torch.no_grad():
            target = torch.as_tensor(
                np.array(joints[:, :_N_FIT_JOINTS], np.float32),
                device=self.device)
            _sync(self.device)
            t0 = time.perf_counter()
            params, losses = self.adam(target)
            _sync(self.device)
            t1 = time.perf_counter()
            if self.polish_steps > 0:
                params = self.polish(params, target)
            fit_joints = self.smpl.joints(params["rot6d"], params["trans"])
            _sync(self.device)
            t2 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in params.items()}
        out["joints_fit"] = fit_joints.cpu().numpy()
        out["loss_curve"] = losses.cpu().numpy()
        out["adam_s"], out["polish_s"] = t1 - t0, t2 - t1
        return out

    def vertices(self, rot6d, trans) -> np.ndarray:
        """Mesh vertices [T, V, 3] for export (needs the SMPL asset)."""
        with matmul_precision("highest"), torch.no_grad():
            return self.smpl.vertices(
                torch.as_tensor(np.array(rot6d, np.float32),
                                device=self.device),
                torch.as_tensor(np.array(trans, np.float32),
                                device=self.device)
            ).cpu().numpy()
