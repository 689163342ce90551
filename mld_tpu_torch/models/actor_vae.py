"""The ACTOR motion VAE of the action-to-motion presets (port of
``mld_tpu/models/actor_vae.py``), batch-first and mask-driven.

Parity target: mld/models/architectures/actor_vae.py:11-258. The encoder
embeds the frames, PREPENDS its ``mu_token`` and ``logvar_token``, adds the
sinusoidal PE and runs a plain post-norm encoder over [2 + T] tokens whose
key mask is ``[ones(2), mask]``; rows 0 and 1 are mu and logvar. The decoder
runs zero queries plus the sinusoidal PE through a plain decoder (no final
norm) that cross-attends the single latent, then ``final_layer``, zero
outside the mask. Every attention is ``ops.attention.sdpa`` (K3 on the
card).

Parameter names follow the reference torch module: ``encoder.skel_embedding``,
``encoder.mu_token``, ``encoder.logvar_token``, ``encoder.seqTransEncoder.*``,
``decoder.seqTransDecoder.*``, ``decoder.final_layer``. LayerNorm eps is
flax's 1e-6, as the plain modules' (``ops/transformer.py``). The interface
is ``MldVae``'s (``encode``, ``decode``); it has no kernel stack of its own.
Under bf16 mixed precision the f32 sine PE promotes the activations to f32,
and the layers after it compute in f32 on the bf16 weights, as the JAX
package's do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mld_tpu_torch.ops.embeddings import PositionEmbeddingSine1D
from mld_tpu_torch.ops.transformer import (Linear, TransformerDecoder,
                                           TransformerEncoder)

PE_MAX_LEN = 5000


class ActorAgnosticEncoder(nn.Module):
    def __init__(self, nfeats: int, latent_dim: int = 256,
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, dropout: float = 0.0,
                 activation: str = "gelu"):
        super().__init__()
        d = latent_dim
        self.skel_embedding = Linear(nfeats, d)
        self.mu_token = nn.Parameter(torch.empty(d))
        self.logvar_token = nn.Parameter(torch.empty(d))
        self.sequence_pos_encoding = PositionEmbeddingSine1D(
            d, PE_MAX_LEN, dropout)
        self.seqTransEncoder = TransformerEncoder(
            d, num_heads, num_layers, ff_size, activation, dropout=dropout)

    def forward(self, features: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """features [B, T, nfeats], mask [B, T] -> (mu, logvar), [B, d]."""
        B = features.shape[0]
        x = self.skel_embedding(features)
        tokens = torch.stack([self.mu_token, self.logvar_token])[None]
        xseq = torch.cat([tokens.expand(B, -1, -1), x], dim=1)
        valid = torch.cat([mask.new_ones(B, 2), mask], dim=1)
        xseq = self.sequence_pos_encoding(xseq, generator)
        out = self.seqTransEncoder(xseq, valid, generator)
        return out[:, 0], out[:, 1]


class ActorAgnosticDecoder(nn.Module):
    def __init__(self, nfeats: int, latent_dim: int = 256,
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, dropout: float = 0.0,
                 activation: str = "gelu"):
        super().__init__()
        d = latent_dim
        self.latent_dim = d
        self.sequence_pos_encoding = PositionEmbeddingSine1D(
            d, PE_MAX_LEN, dropout)
        self.seqTransDecoder = TransformerDecoder(
            d, num_heads, num_layers, ff_size, activation, final_norm=False,
            dropout=dropout)
        self.final_layer = Linear(d, nfeats)

    def forward(self, z: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z [B, 1, d], mask [B, T] -> feats [B, T, nfeats], zero outside
        the mask."""
        B, T = mask.shape
        queries = self.sequence_pos_encoding(
            z.new_zeros(B, T, self.latent_dim), generator)
        out = self.seqTransDecoder(queries, z, tgt_valid=mask,
                                   generator=generator)
        return self.final_layer(out) * mask[..., None]


class ActorVae(nn.Module):
    def __init__(self, nfeats: int, latent_size: int = 1,
                 latent_dim: int = 256, ff_size: int = 1024,
                 num_layers: int = 9, num_heads: int = 4,
                 activation: str = "gelu", dropout: float = 0.0):
        super().__init__()
        if latent_size != 1:
            raise ValueError("the ACTOR VAE has one latent token")
        self.latent_size = latent_size
        self.latent_dim = latent_dim
        self.encoder = ActorAgnosticEncoder(nfeats, latent_dim, ff_size,
                                            num_layers, num_heads, dropout,
                                            activation)
        self.decoder = ActorAgnosticDecoder(nfeats, latent_dim, ff_size,
                                            num_layers, num_heads, dropout,
                                            activation)

    def encode_dist(self, features: torch.Tensor, mask: torch.Tensor,
                    dropout_generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (mu, logvar), each [B, 1, latent_dim]."""
        mu, logvar = self.encoder(features, mask, dropout_generator)
        return mu[:, None], logvar[:, None]

    def encode(self, features: torch.Tensor, mask: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               sample_mean: bool = False, fact: float = 1.0, *,
               eps: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """-> (z, (mu, logvar)), as ``MldVae.encode``: z = mu + fact * eps *
        std with eps given or drawn from `generator` in f32, else mu."""
        mu, logvar = self.encode_dist(features, mask, dropout_generator)
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
        return self.decoder(z, mask, dropout_generator)

    def forward(self, features: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                eps: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None):
        """-> (feats, z, (mu, logvar))."""
        z, dist = self.encode(features, mask, generator, eps=eps,
                              dropout_generator=dropout_generator)
        return self.decode(z, mask, dropout_generator), z, dist
