"""MldVae — transformer motion VAE, ``encoder_decoder`` arch (port of
``mld_tpu/models/vae.py``), batch-first and mask-driven.

Parameter names follow the reference torch module
(mld/models/architectures/mld_vae.py:33-248): ``query_pos_encoder.pe``,
``query_pos_decoder.pe``, ``encoder.*``, ``decoder.*``,
``global_motion_token``, ``skel_embedding``, ``final_layer``.

``encode`` and ``decode`` are the plain module path (flax's LayerNorm eps
1e-6), differentiable, with dropout when given a generator; the serving
callers run them under ``torch.no_grad()`` (``models/mld.py``). The fused
decode (``ops.fused_seq_decoder.fused_vae_decode``, eps 1e-5, serving only)
reads the decoder's weights stacked for its kernel; they are built by
``restack`` and rebuilt whenever parameters are loaded or moved, once a
stack exists, and dropped (``drop_stack``) when an optimizer step changes
the parameters in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mld_tpu_torch.ops.embeddings import PositionEmbeddingLearned1D
from mld_tpu_torch.ops.fused_seq_decoder import (StackedSkipDecoder,
                                                 stack_skip_decoder)
from mld_tpu_torch.ops.transformer import (SkipTransformerDecoder,
                                           SkipTransformerEncoder)


class MldVae(nn.Module):
    def __init__(self, nfeats: int, latent_size: int = 1,
                 latent_dim: int = 256, ff_size: int = 1024,
                 num_layers: int = 9, num_heads: int = 4,
                 activation: str = "gelu",
                 weight_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        d = latent_dim
        self.latent_size = latent_size
        self.latent_dim = latent_dim
        self.query_pos_encoder = PositionEmbeddingLearned1D(d)
        self.query_pos_decoder = PositionEmbeddingLearned1D(d)
        self.encoder = SkipTransformerEncoder(d, num_heads, num_layers,
                                              ff_size, activation,
                                              dropout=dropout)
        self.decoder = SkipTransformerDecoder(d, num_heads, num_layers,
                                              ff_size, activation,
                                              dropout=dropout)
        self.global_motion_token = nn.Parameter(torch.empty(2 * latent_size, d))
        self.skel_embedding = nn.Linear(nfeats, d)
        self.final_layer = nn.Linear(d, nfeats)
        self.weight_dtype = weight_dtype
        self._stacked: Optional[StackedSkipDecoder] = None
        self.register_load_state_dict_post_hook(
            lambda module, incompatible: module._restack_if_stacked())

    def restack(self):
        """Rebuild the decoder kernel's stacked weights from the params."""
        self._stacked = stack_skip_decoder(self.decoder, self.weight_dtype)

    def _restack_if_stacked(self):
        if self._stacked is not None:
            self.restack()

    def drop_stack(self):
        """Forget the stacked weights (the params changed in place); the
        next fused decode restacks."""
        self._stacked = None

    def stacked_decoder(self) -> StackedSkipDecoder:
        """K5's stacked weights: the cached stack of the parameters or,
        while a forward runs on their bf16 copies (a mixed-precision step's
        validation, ``train/steps.py:_segment``), a stack of those copies
        built for the call, matrices in bf16."""
        dtype = self.decoder.norm.weight.dtype
        if dtype != torch.float32:
            return stack_skip_decoder(self.decoder, dtype)
        if self._stacked is None:
            self.restack()
        return self._stacked

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .float() replace the params: restack after them
        out = super()._apply(fn, *args, **kwargs)
        self._restack_if_stacked()
        return out

    def encode(self, features: torch.Tensor, mask: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sample_mean: bool = False, fact: float = 1.0, *,
               eps: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """features [B, T, nfeats], mask [B, T] bool -> (z, (mu, logvar)),
        each [B, latent_size, latent_dim]. z = mu + fact * eps * std
        (``mld_tpu/models/vae.py:98-112``), with eps given, or drawn from
        `generator` in f32; without either (or with sample_mean) z is mu.
        Dropout is on when dropout_generator is given."""
        B = features.shape[0]
        x = self.skel_embedding(features)
        dist = self.global_motion_token[None].expand(B, -1, -1)
        xseq = self.query_pos_encoder(torch.cat([dist, x], dim=1))
        valid = torch.cat([mask.new_ones(B, dist.shape[1]), mask], dim=1)
        out = self.encoder(xseq, valid,
                           generator=dropout_generator)[:, : dist.shape[1]]
        mu, logvar = out[:, : self.latent_size], out[:, self.latent_size:]
        if eps is None and generator is not None and not sample_mean:
            eps = torch.randn(mu.shape, generator=generator,
                              device=generator.device)
        if sample_mean or eps is None:
            return mu, (mu, logvar)
        eps = eps.to(mu)
        return mu + fact * eps * torch.exp(0.5 * logvar), (mu, logvar)

    def decode(self, z: torch.Tensor, mask: torch.Tensor,
               dropout_generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """z [B, latent_size, latent_dim], mask [B, T] -> feats [B, T, nfeats],
        zero outside the mask. Dropout is on when dropout_generator is
        given."""
        B, T = mask.shape
        queries = self.query_pos_decoder(
            z.new_zeros(B, T, self.latent_dim))
        output = self.decoder(queries, z, tgt_valid=mask,
                              generator=dropout_generator)
        return self.final_layer(output) * mask[..., None]
