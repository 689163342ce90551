"""Inverted dropout with masks drawn from an explicit generator (the
semantics of flax's ``nn.Dropout`` and of ``sdpa_xla``'s probability
dropout: keep with probability 1 - rate, scale the kept by 1 / (1 - rate)).

Masks are drawn on the generator's device from ``torch.rand``, never from
the global RNG, so a seeded generator replays the same masks.
"""
from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """x unchanged without a generator or at rate 0; else x / (1 - rate)
    where kept (probability 1 - rate) and 0 where dropped."""
    if generator is None or rate <= 0.0:
        return x
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = (u < 1.0 - rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
