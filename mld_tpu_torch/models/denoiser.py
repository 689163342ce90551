"""MldDenoiser — latent-space text-conditioned denoiser (port of
``mld_tpu/models/denoiser.py`` for ``condition="text"``, ``trans_enc`` with
skip connections, latent mode).

Token sequence: [sample tokens ; time token ; text tokens], sample first
(mld_denoiser.py:187). The module holds the parameters under the reference
torch names (``time_embedding.linear_1``, ``emb_proj.1``, ``query_pos.pe``,
``encoder.*``); its inference forward is ``ops.fused_denoiser``.

The encoder's per-layer weights are stacked for the kernel once, whenever
parameters are loaded or moved (``restack``), never per call.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mld_tpu_torch.ops.embeddings import (PositionEmbeddingLearned1D,
                                          TimestepEmbedding)
from mld_tpu_torch.ops.fused_denoiser import fused_denoiser_forward
from mld_tpu_torch.ops.fused_layer import (MAX_S, StackedSkipEncoder,
                                           stack_skip_encoder)
from mld_tpu_torch.ops.transformer import SkipTransformerEncoder


class MldDenoiser(nn.Module):
    def __init__(self, latent_size: int = 1, latent_dim: int = 256,
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, text_encoded_dim: int = 768,
                 flip_sin_to_cos: bool = True, freq_shift: float = 0.0,
                 pe_max_len: int = 500, activation: str = "gelu",
                 weight_dtype: torch.dtype = torch.float32):
        super().__init__()
        if activation != "gelu":
            raise ValueError("the fused denoiser stack computes gelu only")
        if latent_size + 2 > MAX_S:
            raise ValueError(f"latent_size {latent_size} exceeds the fused "
                             f"stack's {MAX_S} tokens")
        self.latent_dim = latent_dim
        self.text_encoded_dim = text_encoded_dim
        self.flip_sin_to_cos = flip_sin_to_cos
        self.freq_shift = freq_shift
        self.weight_dtype = weight_dtype
        self.time_embedding = TimestepEmbedding(text_encoded_dim, latent_dim)
        self.emb_proj = (nn.Sequential(nn.ReLU(),
                                       nn.Linear(text_encoded_dim, latent_dim))
                         if text_encoded_dim != latent_dim else None)
        self.query_pos = PositionEmbeddingLearned1D(latent_dim, pe_max_len)
        self.encoder = SkipTransformerEncoder(latent_dim, num_heads,
                                              num_layers, ff_size, activation)
        self._stacked: Optional[StackedSkipEncoder] = None
        self.register_load_state_dict_post_hook(
            lambda module, incompatible: module.restack())

    def restack(self):
        """Rebuild the kernel's stacked weights from the current params."""
        self._stacked = stack_skip_encoder(self.encoder, self.weight_dtype)

    def stacked_encoder(self) -> StackedSkipEncoder:
        if self._stacked is None:
            self.restack()
        return self._stacked

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .float() replace the params: restack after them
        out = super()._apply(fn, *args, **kwargs)
        if self._stacked is not None:
            self.restack()
        return out

    def forward(self, sample: torch.Tensor, timestep,
                encoder_hidden_states: torch.Tensor,
                time_emb: Optional[torch.Tensor] = None,
                cond_lat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample [B, latent_size, d]; timestep scalar or [B];
        encoder_hidden_states [B, S_text, text_dim] -> [B, latent_size, d]."""
        return fused_denoiser_forward(self, sample, timestep,
                                      encoder_hidden_states, time_emb,
                                      cond_lat)
