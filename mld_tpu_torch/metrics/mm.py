"""MultiModality metric (mld/models/metrics/mm.py:11-63 parity).

Carried copy of ``mld_tpu/metrics/mm.py`` (numpy and scipy only), held
equal to the original by ``tests/test_torch_eval.py``.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from .utils import calculate_multimodality


class MMMetrics:
    def __init__(self, mm_num_times: int = 10,
                 sync: Optional[Callable] = None):
        self.mm_num_times = mm_num_times
        self.sync = sync
        self.reset()

    def reset(self):
        self.count_seq = 0
        self.mm_motion_embeddings: List[np.ndarray] = []

    def update(self, mm_motion_embeddings, lengths):
        """mm_motion_embeddings: [1, n_repeats, D] per update (one text)."""
        self.count_seq += len(lengths)
        arr = np.asarray(mm_motion_embeddings)
        self.mm_motion_embeddings.append(arr.reshape(1, arr.shape[-2], -1)
                                         if arr.ndim == 3 else arr)

    def compute(self, rng: Optional[np.random.RandomState] = None) -> dict:
        cache = self.mm_motion_embeddings
        if self.sync is not None:
            cache = self.sync(cache)
        all_mm = np.concatenate(cache, axis=0)  # [n_texts, n_repeats, D]
        return {"MultiModality": calculate_multimodality(
            all_mm, self.mm_num_times, rng or np.random.RandomState(0))}
