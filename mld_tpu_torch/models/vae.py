"""MldVae — transformer motion VAE (port of ``mld_tpu/models/vae.py``),
batch-first and mask-driven, with the JAX module's options
(``vae.py:41-120``): ``arch`` encoder_decoder (a skip decoder whose frame
queries cross-attend the latent) or all_encoder (a skip encoder over
``[z; zero queries]`` under the key mask ``[ones(latent_size); mask]``,
whose latent rows are dropped), ``mlp_dist`` (``latent_size`` motion tokens
and a ``dist_layer`` Linear(d, 2d) split into mu | logvar, instead of
2 x latent_size tokens), ``normalize_before`` (pre-norm layers) and the PE
kind (``position_embedding``, tables of the default length 500).

Parameter names follow the reference torch module
(mld/models/architectures/mld_vae.py:33-248): ``query_pos_encoder.pe``,
``query_pos_decoder.pe`` (a learned PE), ``encoder.*``, ``decoder.*``,
``global_motion_token``, ``dist_layer``, ``skel_embedding``,
``final_layer``.

``encode`` and ``decode`` are the plain module path (flax's LayerNorm eps
1e-6), differentiable, with dropout when given a generator; the serving
callers run them under ``torch.no_grad()`` (``models/mld.py``). The fused
decode (``ops.fused_seq_decoder.fused_vae_decode``, eps 1e-5, serving only,
where ``can_fuse_decode`` holds: the post-norm encoder_decoder arch with a
learned PE) reads the decoder's weights stacked for its kernel; they are
built by
``restack`` and rebuilt whenever parameters are loaded or moved, once a
stack exists, and dropped (``drop_stack``) when an optimizer step changes
the parameters in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mld_tpu_torch.ops.embeddings import build_position_encoding
from mld_tpu_torch.ops.fused_seq_decoder import (StackedSkipDecoder,
                                                 stack_skip_decoder)
from mld_tpu_torch.ops.transformer import (Linear, SkipTransformerDecoder,
                                           SkipTransformerEncoder)
from mld_tpu_torch.utils import precision


class MldVae(nn.Module):
    def __init__(self, nfeats: int, latent_size: int = 1,
                 latent_dim: int = 256, ff_size: int = 1024,
                 num_layers: int = 9, num_heads: int = 4,
                 activation: str = "gelu",
                 weight_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, arch: str = "encoder_decoder",
                 normalize_before: bool = False,
                 position_embedding: str = "learned",
                 mlp_dist: bool = False):
        super().__init__()
        if arch not in ("encoder_decoder", "all_encoder"):
            raise ValueError(f"arch {arch} not supported")
        d = latent_dim
        self.latent_size = latent_size
        self.latent_dim = latent_dim
        self.arch = arch
        self.mlp_dist = mlp_dist
        self.query_pos_encoder = build_position_encoding(d,
                                                         position_embedding)
        self.query_pos_decoder = build_position_encoding(d,
                                                         position_embedding)
        layer_kw = dict(ff_size=ff_size, activation=activation,
                        dropout=dropout, normalize_before=normalize_before)
        self.encoder = SkipTransformerEncoder(d, num_heads, num_layers,
                                              **layer_kw)
        self.decoder = (SkipTransformerEncoder if arch == "all_encoder"
                        else SkipTransformerDecoder)(d, num_heads, num_layers,
                                                     **layer_kw)
        self.global_motion_token = nn.Parameter(torch.empty(
            latent_size if mlp_dist else 2 * latent_size, d))
        self.dist_layer = Linear(d, 2 * d) if mlp_dist else None
        self.skel_embedding = Linear(nfeats, d)
        self.final_layer = Linear(d, nfeats)
        self.weight_dtype = weight_dtype
        # K5's stacks: in weight_dtype, and the bf16 arm the matmul
        # precision picks when weight_dtype is f32 (built at first use)
        self._stacked: Optional[StackedSkipDecoder] = None
        self._stacked_bf16: Optional[StackedSkipDecoder] = None
        self.register_load_state_dict_post_hook(
            lambda module, incompatible: module._restack_if_stacked())

    def restack(self):
        """Rebuild the decoder kernel's stacked weights from the params, the
        bf16 arm too once it was built."""
        self._stacked = stack_skip_decoder(self.decoder, self.weight_dtype)
        if self._stacked_bf16 is not None:
            self._stacked_bf16 = stack_skip_decoder(self.decoder,
                                                    torch.bfloat16)

    def _restack_if_stacked(self):
        if self._stacked is not None or self._stacked_bf16 is not None:
            self.restack()

    def drop_stack(self):
        """Forget the stacked weights (the params changed in place); the
        next fused decode restacks."""
        self._stacked = self._stacked_bf16 = None

    def stacked_decoder(self) -> StackedSkipDecoder:
        """K5's stacked weights: the cached stack of the parameters, in
        weight_dtype or, where that is f32, in the arm the matmul precision
        in force picks (bf16 under "default", ``mld.py:305-312``); or,
        while a forward runs on their bf16 copies (a mixed-precision step's
        validation, ``train/steps.py:_segment``), a stack of those copies
        built for the call, matrices in bf16."""
        dtype = self.decoder.norm.weight.dtype
        if dtype != torch.float32:
            return stack_skip_decoder(self.decoder, dtype)
        if self.weight_dtype == torch.float32 \
                and precision.weight_dtype() == torch.bfloat16:
            if self._stacked_bf16 is None:
                self._stacked_bf16 = stack_skip_decoder(self.decoder,
                                                        torch.bfloat16)
            return self._stacked_bf16
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
        if self.mlp_dist:
            out = self.dist_layer(out)
            mu, logvar = out[..., : self.latent_dim], out[..., self.latent_dim:]
        else:
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
        queries = z.new_zeros(B, T, self.latent_dim)
        if self.arch == "all_encoder":
            xseq = self.query_pos_decoder(torch.cat([z, queries], dim=1))
            valid = torch.cat([mask.new_ones(B, self.latent_size), mask],
                              dim=1)
            output = self.decoder(xseq, valid, generator=dropout_generator)
            output = output[:, self.latent_size:]
        else:
            output = self.decoder(self.query_pos_decoder(queries), z,
                                  tgt_valid=mask, generator=dropout_generator)
        return self.final_layer(output) * mask[..., None]
