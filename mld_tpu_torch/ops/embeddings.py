"""Positional and timestep embeddings (port of ``mld_tpu/ops/embeddings.py``).

Parity targets:
  learned 1D PE        — mld/models/operator/position_encoding.py:138-159
  sinusoidal PE        — mld/models/operator/position_encoding_layer.py:6-30
  timestep sinusoid    — mld/models/architectures/tools/embeddings.py:245-322
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dropout import dropout as _dropout
from .transformer import Linear

# the denoisers' timestep sinusoid: cos first, no frequency shift
# (mld_tpu/models/denoiser.py:79-80; every preset keeps these)
DENOISER_FLIP_SIN_TO_COS = True
DENOISER_FREQ_SHIFT = 0.0


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = False,
                           downscale_freq_shift: float = 1.0,
                           scale: float = 1.0,
                           max_period: int = 10000) -> torch.Tensor:
    """DDPM sinusoidal timestep embedding. timesteps: [N] -> [N, dim] f32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)
    emb = timesteps.to(torch.float32)[:, None] * emb[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class PositionEmbeddingLearned1D(nn.Module):
    """Learned additive PE over the (batch-first) sequence axis; the table
    keeps the reference's ``pe [max_len, 1, D]`` layout."""

    def __init__(self, d_model: int, max_len: int = 500):
        super().__init__()
        self.pe = nn.Parameter(torch.empty(max_len, 1, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: [B, S, D]
        return x + self.pe[: x.shape[1], 0][None]


@functools.lru_cache(maxsize=None)
def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """The sin/cos interleaved table [max_len, d_model] (f32, computed in
    numpy as the JAX package computes it; read-only, shared)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    pe.setflags(write=False)
    return pe


class PositionEmbeddingSine1D(nn.Module):
    """The fixed sinusoidal additive PE (the ACTOR VAE's), with dropout when
    a generator is given. The table is a constant of (max_len, d_model), not
    a parameter: it is copied to a device at its first use there."""

    def __init__(self, d_model: int, max_len: int = 500,
                 dropout: float = 0.0):
        super().__init__()
        self.d_model, self.max_len, self.dropout = d_model, max_len, dropout
        self._tables = {}

    def table(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.as_tensor(
                sinusoidal_table(self.max_len, self.d_model).copy(),
                device=device)
        return t

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:  # x: [B, S, D]
        x = x + self.table(x.device)[: x.shape[1]][None]
        return _dropout(x, self.dropout, generator)


LEARNED_PE = ("v3", "learned")
SINE_PE = ("v2", "sine", "actor")


def build_position_encoding(d_model: int, kind: str = "learned",
                            max_len: int = 500) -> nn.Module:
    """The additive PE a config's ``position_embedding`` names
    (``embeddings.py:55-61``): the learned table for v3 / learned, the fixed
    sinusoid for v2 / sine / actor; any other kind raises."""
    if kind in LEARNED_PE:
        return PositionEmbeddingLearned1D(d_model, max_len)
    if kind in SINE_PE:
        return PositionEmbeddingSine1D(d_model, max_len)
    raise ValueError(f"not supported {kind}")


class TimestepEmbedding(nn.Module):
    """2-layer SiLU MLP over the sinusoid (embeddings.py:288-305), its
    GEMMs at the matmul precision in force."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_channels, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))
