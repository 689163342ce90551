"""Stage-dependent MLD losses (port of ``mld_tpu/losses/mld.py``).

  vae:        SmoothL1(recons_feature) * lambda_rec
              + SmoothL1(recons_joints) * lambda_joint
              + KL(q || N(0, 1)) * lambda_kl
  diffusion:  MSE(noise_pred, noise) (epsilon) or MSE(pred, latent) (sample)

Every loss is a mean over rows (batch entries) of each row's mean, weighted
by ``row_valid`` [B] when given: with all rows valid this is the plain mean
over the padded tensors, the reference's reduction.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _row_mean(loss_elems: torch.Tensor,
              row_valid: Optional[torch.Tensor]) -> torch.Tensor:
    per_row = loss_elems.reshape(loss_elems.shape[0], -1).mean(dim=1)
    if row_valid is None:
        return per_row.mean()
    w = row_valid.to(per_row.dtype)
    return (per_row * w).sum() / torch.clamp(w.sum(), min=1.0)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0,
              row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch SmoothL1Loss(reduction='mean') semantics, row-weighted."""
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _row_mean(loss, row_valid)


def mse(pred: torch.Tensor, target: torch.Tensor,
        row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _row_mean((pred - target) ** 2, row_valid)


def kl_standard_normal(mu: torch.Tensor, logvar: torch.Tensor,
                       row_valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """mean KL( N(mu, exp(logvar / 2)) || N(0, 1) )."""
    return _row_mean(0.5 * (mu ** 2 + torch.exp(logvar) - 1.0 - logvar),
                     row_valid)


def vae_losses(feats_rst, feats_ref, joints_rst, joints_ref, mu, logvar,
               cfg, row_valid=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """cfg: the config's ``loss`` section."""
    recons_feature = smooth_l1(feats_rst, feats_ref, row_valid=row_valid)
    recons_joints = smooth_l1(joints_rst, joints_ref, row_valid=row_valid)
    kl_motion = kl_standard_normal(mu, logvar, row_valid=row_valid)
    total = (cfg.lambda_rec * recons_feature
             + cfg.lambda_joint * recons_joints
             + cfg.lambda_kl * kl_motion)
    return total, {"recons_feature": recons_feature,
                   "recons_joints": recons_joints,
                   "kl_motion": kl_motion, "total": total}


def diffusion_losses(pred, target, cfg, predict_epsilon: bool = True,
                     row_valid=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    name = "inst_loss" if predict_epsilon else "x_loss"
    loss = mse(pred, target, row_valid=row_valid)
    return loss, {name: loss, "total": loss}
