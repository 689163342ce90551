"""Inverted dropout with masks drawn from an explicit generator (the
semantics of flax's ``nn.Dropout`` and of ``sdpa_xla``'s probability
dropout: keep with probability 1 - rate, scale the kept by 1 / (1 - rate)).

Masks are drawn on the generator's device from ``torch.rand``, never from
the global RNG, so a seeded generator replays the same masks.

Under a model axis (``parallel/partition.py``) a rank's masks come from
two generators, ``AxisGenerators``: masks on an activation every rank of
the model group holds whole (the residual stream) from ``replicated``,
keyed by the data rank, so that the model ranks drop alike; masks on an
activation the axis shards (the FFN's hidden columns, a rank's heads'
attention probabilities) from ``sharded``, keyed by data and model rank.
``dropout`` takes the replicated one; the sharded sites pass
``sharded(generator)``. A plain generator is both.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AxisGenerators(NamedTuple):
    """A rank's dropout generators under a model axis."""
    replicated: torch.Generator
    sharded: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.replicated.device


def sharded(generator):
    """The generator of masks on an activation a model axis shards."""
    return (generator.sharded if isinstance(generator, AxisGenerators)
            else generator)


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """x unchanged without a generator or at rate 0; else x / (1 - rate)
    where kept (probability 1 - rate) and 0 where dropped. `generator`: a
    torch.Generator, or AxisGenerators (its replicated one)."""
    if generator is None or rate <= 0.0:
        return x
    if isinstance(generator, AxisGenerators):
        generator = generator.replicated
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = (u < 1.0 - rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
