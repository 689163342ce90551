"""Metric math: distance matrices, top-k, FID, diversity, MPJPE family.

Carried copy of ``mld_tpu/metrics/utils.py`` (numpy and scipy only), held
equal to the original by ``tests/test_torch_eval.py``.

Host-side numpy (matching the reference's deliberate host FID,
mld/models/metrics/utils.py:161-607); batched pieces are trivially
vectorized.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg


def euclidean_distance_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, D] x [M, D] -> [N, M] pairwise euclidean distances."""
    d2 = (np.sum(a * a, 1)[:, None] - 2 * a @ b.T + np.sum(b * b, 1)[None])
    return np.sqrt(np.maximum(d2, 0.0))


def calculate_top_k(argsorted: np.ndarray, top_k: int) -> np.ndarray:
    """argsorted [N, M] of distances; hit when ground-truth index i appears
    in the first k columns of row i. Returns bool [N, top_k] cumulative."""
    N = argsorted.shape[0]
    gt = np.arange(N)[:, None]
    hits = argsorted[:, :top_k] == gt
    return np.cumsum(hits, axis=1) > 0


def activation_statistics(act: np.ndarray):
    mu = np.mean(act, axis=0)
    cov = np.cov(act, rowvar=False)
    return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (scipy sqrtm on host)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    cov1, cov2 = np.atleast_2d(cov1), np.atleast_2d(cov2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(cov1.dot(cov2))
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov1 + offset).dot(cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(cov1) + np.trace(cov2)
                 - 2 * np.trace(covmean))


def calculate_diversity(act: np.ndarray, diversity_times: int,
                        rng=None) -> float:
    """Mean distance between random activation pairs."""
    rng = rng or np.random.RandomState(0)
    n = act.shape[0]
    assert n > diversity_times
    first = rng.choice(n, diversity_times, replace=False)
    second = rng.choice(n, diversity_times, replace=False)
    return float(np.linalg.norm(act[first] - act[second], axis=1).mean())


def calculate_multimodality(act: np.ndarray, multimodality_times: int,
                            rng=None) -> float:
    """act [N_texts, N_repeats, D]: mean pairwise distance within repeats."""
    rng = rng or np.random.RandomState(0)
    n, reps, _ = act.shape
    assert reps > multimodality_times
    first = rng.choice(reps, multimodality_times, replace=False)
    second = rng.choice(reps, multimodality_times, replace=False)
    return float(np.linalg.norm(act[:, first] - act[:, second],
                                axis=2).mean())


# ------------------------------------------------------- reconstruction family
def calc_mpjpe(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[T, J, 3] pairs -> per-frame mean joint position error, after
    root-centering both (metrics/utils.py:354 semantics)."""
    pred_c = pred - pred[:, :1]
    gt_c = gt - gt[:, :1]
    return np.linalg.norm(pred_c - gt_c, axis=-1).mean(axis=-1)


def batch_similarity_transform(S1: np.ndarray, S2: np.ndarray) -> np.ndarray:
    """Procrustes-align S1 to S2. [T, J, 3] each (computed per frame)."""
    out = np.zeros_like(S1)
    for t in range(S1.shape[0]):
        X1, X2 = S1[t].T, S2[t].T  # [3, J]
        mu1 = X1.mean(axis=1, keepdims=True)
        mu2 = X2.mean(axis=1, keepdims=True)
        X1c, X2c = X1 - mu1, X2 - mu2
        var1 = np.sum(X1c ** 2)
        K = X1c @ X2c.T
        U, s, Vh = np.linalg.svd(K)
        V = Vh.T
        Z = np.eye(3)
        Z[-1, -1] *= np.sign(np.linalg.det(U @ V.T))
        R = V @ Z @ U.T
        scale = np.trace(R @ K) / var1
        t_vec = mu2 - scale * (R @ mu1)
        out[t] = (scale * R @ X1 + t_vec).T
    return out


def calc_pampjpe(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Procrustes-aligned MPJPE per frame."""
    aligned = batch_similarity_transform(pred, gt)
    return np.linalg.norm(aligned - gt, axis=-1).mean(axis=-1)


def calc_accel(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Acceleration error per frame (second differences)."""
    accel_pred = pred[:-2] - 2 * pred[1:-1] + pred[2:]
    accel_gt = gt[:-2] - 2 * gt[1:-1] + gt[2:]
    return np.linalg.norm(accel_pred - accel_gt, axis=-1).mean(axis=-1)
