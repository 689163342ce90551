"""TM2T metrics: R-precision, Matching score, FID, Diversity.

Carried copy of ``mld_tpu/metrics/tm2t.py`` (numpy and scipy only), held
equal to the original by ``tests/test_torch_eval.py``.

Parity target: mld/models/metrics/tm2t.py:11-178 — cached-embedding states,
shuffle at compute, 32-way ranking groups, FID over motion embeddings,
random-pair diversity. `sync` hook gathers per-host caches before compute
(replacing torchmetrics dist_sync).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from .utils import (
    activation_statistics,
    calculate_diversity,
    calculate_top_k,
    euclidean_distance_matrix,
    frechet_distance,
)


class TM2TMetrics:
    def __init__(self, top_k: int = 3, R_size: int = 32,
                 diversity_times: int = 300,
                 sync: Optional[Callable] = None):
        self.top_k = top_k
        self.R_size = R_size
        self.diversity_times = diversity_times
        self.sync = sync
        self.reset()

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.text_embeddings: List[np.ndarray] = []
        self.recmotion_embeddings: List[np.ndarray] = []
        self.gtmotion_embeddings: List[np.ndarray] = []

    def update(self, text_embeddings, recmotion_embeddings,
               gtmotion_embeddings, lengths):
        self.count += int(np.sum(lengths))
        self.count_seq += len(lengths)
        flat = lambda x: np.asarray(x).reshape(len(lengths), -1)
        self.text_embeddings.append(flat(text_embeddings))
        self.recmotion_embeddings.append(flat(recmotion_embeddings))
        self.gtmotion_embeddings.append(flat(gtmotion_embeddings))

    def _r_precision(self, texts, motions):
        top_k_mat = np.zeros(self.top_k)
        score = 0.0
        groups = self.count_seq // self.R_size
        for i in range(groups):
            sl = slice(i * self.R_size, (i + 1) * self.R_size)
            dist = euclidean_distance_matrix(texts[sl], motions[sl])
            dist = np.nan_to_num(dist)
            score += np.trace(dist)
            argsm = np.argsort(dist, axis=1)
            top_k_mat += calculate_top_k(argsm, self.top_k).sum(axis=0)
        R_count = groups * self.R_size
        return score, top_k_mat, R_count

    def compute(self, rng: Optional[np.random.RandomState] = None) -> dict:
        rng = rng or np.random.RandomState(0)
        caches = [self.text_embeddings, self.recmotion_embeddings,
                  self.gtmotion_embeddings]
        if self.sync is not None:
            caches = [self.sync(c) for c in caches]
        texts, gen, gt = (np.concatenate(c, axis=0) for c in caches)
        count_seq = len(texts)
        self.count_seq = count_seq

        shuffle = rng.permutation(count_seq)
        texts, gen, gt = texts[shuffle], gen[shuffle], gt[shuffle]

        metrics = {}
        assert count_seq > self.R_size, "need more sequences than R_size"
        score, top_k_mat, R_count = self._r_precision(texts, gen)
        metrics["Matching_score"] = score / R_count
        for k in range(self.top_k):
            metrics[f"R_precision_top_{k + 1}"] = top_k_mat[k] / R_count
        score, top_k_mat, _ = self._r_precision(texts, gt)
        metrics["gt_Matching_score"] = score / R_count
        for k in range(self.top_k):
            metrics[f"gt_R_precision_top_{k + 1}"] = top_k_mat[k] / R_count

        mu, cov = activation_statistics(gen)
        gt_mu, gt_cov = activation_statistics(gt)
        metrics["FID"] = frechet_distance(gt_mu, gt_cov, mu, cov)

        assert count_seq > self.diversity_times
        metrics["Diversity"] = calculate_diversity(gen, self.diversity_times,
                                                   rng)
        metrics["gt_Diversity"] = calculate_diversity(
            gt, self.diversity_times, rng)
        return metrics
