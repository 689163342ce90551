"""Cross-rank metric-cache gather (the twin of
``mld_tpu/parallel/multihost.py``).

The reference syncs metric state with torchmetrics' dist_sync (an
all-gather of the cached embedding lists, tm2t.py:73-75). The returned
callable plugs into a metric accumulator's ``sync=`` hook (``metrics/``),
or gathers one batch's outputs (``eval/pipeline.py:run_split`` with
``sharded``).
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import ddp


def make_metric_sync():
    """sync(list of arrays) -> [the arrays of every rank, concatenated
    along axis 0 in rank order]; the identity with one rank (no process
    group, or a group of one)."""
    if ddp.world_size() == 1:
        return lambda cache: cache

    def sync(cache: List[np.ndarray]) -> List[np.ndarray]:
        local = (np.concatenate([np.asarray(c) for c in cache], axis=0)
                 if cache else None)
        parts = [p for p in ddp.all_gather_object(local) if p is not None]
        return [np.concatenate(parts, axis=0)] if parts else []

    return sync
