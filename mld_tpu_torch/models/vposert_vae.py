"""VPosert — the MLP sequence VAE over the flattened clip (port of
``mld_tpu/models/vposert_vae.py``, the ablation's ``vae_type="vposert"``).

Parity target: mld/models/architectures/vposert_vae.py:27-145. The encoder
flattens the whole padded clip (max_frames x nfeats), normalises it, and
runs BatchNorm MLPs to mu and a softplus scale; the decoder maps one latent
token back to max_frames x nfeats features (at full width ``dec_out`` is
Linear(512, 196 x 263): 26M parameters, one GEMM a call), cropped to the
mask's T and zeroed outside it.

Its BatchNorm always normalises with the running averages, in training
too, as flax's ``BatchNorm(use_running_average=True)`` does (eps 1e-5):
``BatchNorm`` below, whose ``running_mean`` / ``running_var`` are buffers
(flax's initial 0 and 1 unless a ``batch_stats`` collection is loaded,
``utils/convert.py``). Parameter names: ``bn_in`` / ``bn_mid`` (``weight``,
``bias``), ``enc_1..3``, ``mu_head``, ``logvar_head``, ``dec_1``,
``dec_2``, ``dec_out``. The interface is ``MldVae``'s (``encode``,
``decode``); it has no kernel of its own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mld_tpu_torch.ops.transformer import Linear

BN_EPS = 1e-5        # flax.linen.BatchNorm's default
LEAKY_SLOPE = 0.01


class BatchNorm(nn.Module):
    """BatchNorm over the feature axis of [B, N] that always uses its
    running statistics (never the batch's, never updated)."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_running_stats(self):
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's arithmetic: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mean, var, w, b = (t.to(x.dtype) for t in (
            self.running_mean, self.running_var, self.weight, self.bias))
        return (x - mean) * (torch.rsqrt(var + self.eps) * w) + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus, log(1 + e^x) without torch's linear cut-off past 20
    return torch.logaddexp(x, torch.zeros_like(x))


class VPosert(nn.Module):
    def __init__(self, nfeats: int = 263, max_frames: int = 196,
                 latent_size: int = 1, latent_dim: int = 256,
                 num_neurons: int = 512):
        super().__init__()
        self.nfeats, self.max_frames = nfeats, max_frames
        self.latent_size, self.latent_dim = latent_size, latent_dim
        n_in, n = max_frames * nfeats, num_neurons
        self.bn_in = BatchNorm(n_in)
        self.enc_1 = Linear(n_in, n)
        self.bn_mid = BatchNorm(n)
        self.enc_2 = Linear(n, n)
        self.enc_3 = Linear(n, n)
        self.mu_head = Linear(n, latent_dim)
        self.logvar_head = Linear(n, latent_dim)
        self.dec_1 = Linear(latent_dim, n)
        self.dec_2 = Linear(n, n)
        self.dec_out = Linear(n, n_in)

    def encode(self, features: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               sample_mean: bool = False, fact: float = 1.0, *,
               eps: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """features [B, max_frames, nfeats] -> (z, (mu, logvar)), each
        [B, 1, latent_dim]: z = mu + fact * eps * scale, logvar =
        2 log(scale + 1e-12) (``vposert_vae.py:44-56``), eps given or drawn
        from `generator` in f32; mu without either. The mask is not read
        (the clip is flattened whole) and there is no dropout."""
        x = features.reshape(features.shape[0],
                             self.max_frames * self.nfeats)
        x = F.leaky_relu(self.enc_1(self.bn_in(x)), LEAKY_SLOPE)
        x = self.enc_3(self.enc_2(self.bn_mid(x)))
        mu = self.mu_head(x)[:, None]
        scale = _softplus(self.logvar_head(x))[:, None]
        logvar = 2.0 * torch.log(scale + 1e-12)
        if eps is None and generator is not None and not sample_mean:
            eps = torch.randn(mu.shape, generator=generator,
                              device=generator.device)
        if sample_mean or eps is None:
            return mu, (mu, logvar)
        return mu + fact * eps.to(mu) * scale, (mu, logvar)

    def decode(self, z: torch.Tensor, mask: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """z [B, 1, latent_dim] -> feats [B, max_frames, nfeats], cropped to
        the mask's T and zero outside it when a mask [B, T] is given."""
        x = F.leaky_relu(self.dec_1(z[:, 0]), LEAKY_SLOPE)
        x = F.leaky_relu(self.dec_2(x), LEAKY_SLOPE)
        feats = self.dec_out(x).reshape(-1, self.max_frames, self.nfeats)
        if mask is None:
            return feats
        return feats[:, : mask.shape[1]] * mask[..., None]
