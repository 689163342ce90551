"""Unconditional-generation metrics: FID + KID + Diversity.

Carried copy of ``mld_tpu/metrics/uncond.py`` (numpy and scipy only), held
equal to the original by ``tests/test_torch_eval.py``.

Parity target: mld/models/metrics/uncond.py:11-140 with the polynomial-MMD
KID estimator from metrics/utils.py:461-607 (unbiased MMD^2 over 100 random
subsets, degree-3 polynomial kernel (x.y/d + 1)^3).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from .utils import (
    activation_statistics,
    calculate_diversity,
    frechet_distance,
)


def _poly_kernel(X, Y, degree=3, gamma=None, coef0=1.0):
    gamma = gamma if gamma is not None else 1.0 / X.shape[1]
    return (gamma * (X @ Y.T) + coef0) ** degree


def _mmd2_unbiased(K_XX, K_XY, K_YY):
    m = K_XX.shape[0]
    diag_X, diag_Y = np.diagonal(K_XX), np.diagonal(K_YY)
    Kt_XX_sum = K_XX.sum() - diag_X.sum()
    Kt_YY_sum = K_YY.sum() - diag_Y.sum()
    K_XY_sum = K_XY.sum()
    return (Kt_XX_sum + Kt_YY_sum) / (m * (m - 1)) - 2 * K_XY_sum / (m * m)


def calculate_kid(real: np.ndarray, gen: np.ndarray, n_subsets: int = 100,
                  subset_size: int = 1000, rng=None):
    rng = rng or np.random.RandomState(0)
    replace = subset_size < len(real)
    subset_size = min(subset_size, len(real), len(gen))
    mmds = np.zeros(n_subsets)
    for i in range(n_subsets):
        g = real[rng.choice(len(real), subset_size, replace=replace)]
        r = gen[rng.choice(len(gen), subset_size, replace=replace)]
        K_XX = _poly_kernel(g, g)
        K_YY = _poly_kernel(r, r)
        K_XY = _poly_kernel(g, r)
        mmds[i] = _mmd2_unbiased(K_XX, K_XY, K_YY)
    return float(mmds.mean()), float(mmds.std())


class UncondMetrics:
    def __init__(self, diversity_times: int = 300,
                 sync: Optional[Callable] = None):
        self.diversity_times = diversity_times
        self.sync = sync
        self.reset()

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.recmotion_embeddings: List[np.ndarray] = []
        self.gtmotion_embeddings: List[np.ndarray] = []

    def update(self, gtmotion_embeddings, lengths,
               recmotion_embeddings=None):
        self.count += int(np.sum(lengths))
        self.count_seq += len(lengths)
        flat = lambda x: np.asarray(x).reshape(len(lengths), -1)
        self.gtmotion_embeddings.append(flat(gtmotion_embeddings))
        if recmotion_embeddings is not None:
            self.recmotion_embeddings.append(flat(recmotion_embeddings))

    def compute(self, rng: Optional[np.random.RandomState] = None) -> dict:
        rng = rng or np.random.RandomState(0)
        gt_cache, rec_cache = self.gtmotion_embeddings, \
            self.recmotion_embeddings
        if self.sync is not None:
            gt_cache = self.sync(gt_cache)
            rec_cache = self.sync(rec_cache)
        gt = np.concatenate(gt_cache, axis=0)
        gen = np.concatenate(rec_cache, axis=0)

        metrics = {}
        kid_mean, kid_std = calculate_kid(gt, gen, rng=rng)
        metrics["KID_mean"], metrics["KID_std"] = kid_mean, kid_std
        mu, cov = activation_statistics(gen)
        gt_mu, gt_cov = activation_statistics(gt)
        metrics["FID"] = frechet_distance(gt_mu, gt_cov, mu, cov)
        assert len(gen) > self.diversity_times
        metrics["Diversity"] = calculate_diversity(gen, self.diversity_times,
                                                   rng)
        metrics["gt_Diversity"] = calculate_diversity(gt,
                                                      self.diversity_times,
                                                      rng)
        return metrics
