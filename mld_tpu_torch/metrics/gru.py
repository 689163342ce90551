"""HumanAct12 a2m metrics: accuracy, FID, diversity and multimodality (port
of ``mld_tpu/metrics/gru.py``).

Parity target: mld/models/metrics/gru.py:13-200: the GRU classifier over
generated and ground-truth joints [B, T, 72], confusion-matrix accuracy, FID
on the tanh(linear1) features, per-class multimodality. The classifier runs
on its device in f32 without TF32 (``matmul_precision("highest")``,
``utils/precision.py``); the accumulation and the statistics are numpy on
the host, and their only randomness is the ``RandomState`` handed to
``compute``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mld_tpu_torch.models.humanact12_gru import (
    build_classifier, convert_humanact12_checkpoint)
from mld_tpu_torch.utils.precision import matmul_precision
from .utils import (activation_statistics, calculate_diversity,
                    calculate_multimodality, frechet_distance)


class HUMANACTMetrics:
    def __init__(self, params: Optional[Dict] = None, num_labels: int = 12,
                 diversity_times: int = 200,
                 multimodality_times: int = 20, seed: int = 0,
                 sync: Optional[Callable] = None, device="cpu"):
        """`params`: the JAX package's classifier tree (a checkpoint
        converted, or the in-repo trainer's); None draws random weights
        from `seed`."""
        self.num_labels = num_labels
        self.diversity_times = diversity_times
        self.multimodality_times = multimodality_times
        self.sync = sync
        self.device = torch.device(device)
        self.model = build_classifier(params, num_labels, self.device, seed)
        self.reset()

    @classmethod
    def from_checkpoint(cls, tar_path: str, **kw):
        return cls(params=convert_humanact12_checkpoint(tar_path), **kw)

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.confusion = np.zeros((self.num_labels, self.num_labels), int)
        self.gt_confusion = np.zeros((self.num_labels, self.num_labels), int)
        self.label_embeddings: List[np.ndarray] = []
        self.recmotion_embeddings: List[np.ndarray] = []
        self.gtmotion_embeddings: List[np.ndarray] = []

    def classify(self, joints, lengths):
        """joints [B, T, 24, 3] (or [B, T, 72]) -> (features [B, 30],
        logits [B, num_labels]) as tensors on the classifier's device."""
        j = torch.as_tensor(joints).to(self.device, torch.float32)
        if j.ndim == 4:
            j = j.reshape(j.shape[0], j.shape[1], -1)
        with torch.no_grad(), matmul_precision("highest"):
            return self.model(j, lengths)

    def update(self, labels, joints_rst, joints_ref, lengths):
        """labels [B], joints_* [B, T, 24, 3] (or [B, T, 72]; arrays or
        tensors), lengths [B]."""
        labels = np.asarray(labels).reshape(-1).astype(int)
        lengths = np.asarray(lengths).astype(np.int32)
        self.count += int(lengths.sum())
        self.count_seq += len(labels)
        for joints, conf, cache in (
                (joints_rst, self.confusion, self.recmotion_embeddings),
                (joints_ref, self.gt_confusion, self.gtmotion_embeddings)):
            feats, logits = self.classify(joints, lengths)
            pred = logits.argmax(-1).cpu().numpy()
            for y, p in zip(labels, pred):
                conf[y, p] += 1
            cache.append(feats.cpu().numpy())
        self.label_embeddings.append(labels)

    def compute(self, rng: Optional[np.random.RandomState] = None) -> dict:
        rng = rng or np.random.RandomState(0)
        caches = [self.label_embeddings, self.recmotion_embeddings,
                  self.gtmotion_embeddings]
        if self.sync is not None:
            caches = [self.sync(c) for c in caches]
        labels = np.concatenate(caches[0])
        gen = np.concatenate(caches[1], axis=0)
        gt = np.concatenate(caches[2], axis=0)

        metrics = {
            "accuracy": np.trace(self.confusion) / max(
                self.confusion.sum(), 1),
            "gt_accuracy": np.trace(self.gt_confusion) / max(
                self.gt_confusion.sum(), 1),
        }
        mu, cov = activation_statistics(gen)
        gt_mu, gt_cov = activation_statistics(gt)
        metrics["FID"] = frechet_distance(gt_mu, gt_cov, mu, cov)
        metrics["gt_FID"] = 0.0

        if len(gen) > self.diversity_times:
            metrics["Diversity"] = calculate_diversity(
                gen, self.diversity_times, rng)
            metrics["gt_Diversity"] = calculate_diversity(
                gt, self.diversity_times, rng)

        # per-class multimodality: group embeddings by label, equalize counts
        counts = np.bincount(labels, minlength=self.num_labels)
        min_count = counts[counts > 0].min() if (counts > 0).any() else 0
        if min_count > self.multimodality_times:
            grouped = np.stack([
                gen[labels == c][:min_count]
                for c in range(self.num_labels) if counts[c] > 0])
            metrics["Multimodality"] = calculate_multimodality(
                grouped, self.multimodality_times, rng)
            grouped_gt = np.stack([
                gt[labels == c][:min_count]
                for c in range(self.num_labels) if counts[c] > 0])
            metrics["gt_Multimodality"] = calculate_multimodality(
                grouped_gt, self.multimodality_times, rng)
        return {k: float(v) for k, v in metrics.items()}
