"""Plain masked multi-head attention (port of ``sdpa_xla``,
``mld_tpu/ops/attention.py:49-73``).

Layout is batch-first: q [B, H, Sq, Dh], k/v [B, H, Sk, Dh]. Padded keys are
filled with -1e9, not -inf, so that a fully masked row stays finite; scores
and softmax are f32 whatever the input dtype. The two Pallas attention
kernels of the JAX package are not ported yet (ROADMAP.md, queue 2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e9


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """key_valid: [B, Sk] bool (True = attend). Returns [B, H, Sq, Dh]."""
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)
