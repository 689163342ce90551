"""UESTC a2m metrics through the frozen ST-GCN classifier (port of
``mld_tpu/metrics/stgcn.py``).

Parity target: mld/models/metrics/stgcn.py:13-180: accuracy, FID, diversity
and per-class multimodality over rot6d rotations [B, 24, 6, T]. The
classifier runs on its device (f32 without TF32); the statistics are numpy
on the host, random only through the ``RandomState`` given to ``compute``.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from mld_tpu_torch.models.uestc_stgcn import STGCN, convert_stgcn_checkpoint
from .utils import (activation_statistics, calculate_diversity,
                    calculate_multimodality, frechet_distance)


class UESTCMetrics:
    def __init__(self, classifier: Optional[STGCN] = None,
                 num_labels: int = 40, diversity_times: int = 200,
                 multimodality_times: int = 20,
                 sync: Optional[Callable] = None, device="cpu"):
        self.classifier = classifier or STGCN.init_random(num_labels,
                                                          device=device)
        self.num_labels = num_labels
        self.diversity_times = diversity_times
        self.multimodality_times = multimodality_times
        self.sync = sync
        self.reset()

    @classmethod
    def from_checkpoint(cls, tar_path: str, num_labels: int = 40,
                        device="cpu", **kw):
        return cls(convert_stgcn_checkpoint(tar_path, num_labels, device),
                   num_labels, device=device, **kw)

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.confusion = np.zeros((self.num_labels, self.num_labels), int)
        self.gt_confusion = np.zeros((self.num_labels, self.num_labels), int)
        self.labels: List[np.ndarray] = []
        self.rec_feats: List[np.ndarray] = []
        self.gt_feats: List[np.ndarray] = []

    def update(self, labels, rots_rst, rots_ref, lengths):
        """labels [B]; rots_* [B, V, 6, T] rot6d (the reference's layout;
        arrays or tensors)."""
        labels = np.asarray(labels).reshape(-1).astype(int)
        self.count += int(np.sum(lengths))
        self.count_seq += len(labels)
        for rots, conf, cache in ((rots_rst, self.confusion, self.rec_feats),
                                  (rots_ref, self.gt_confusion,
                                   self.gt_feats)):
            feats, logits = self.classifier(rots)
            pred = logits.argmax(-1).cpu().numpy()
            for y, p in zip(labels, pred):
                conf[y, p] += 1
            cache.append(feats.cpu().numpy())
        self.labels.append(labels)

    def compute(self, rng: Optional[np.random.RandomState] = None) -> dict:
        rng = rng or np.random.RandomState(0)
        caches = [self.labels, self.rec_feats, self.gt_feats]
        if self.sync is not None:
            caches = [self.sync(c) for c in caches]
        labels = np.concatenate(caches[0])
        gen = np.concatenate(caches[1], 0)
        gt = np.concatenate(caches[2], 0)

        metrics = {
            "accuracy": np.trace(self.confusion) / max(
                self.confusion.sum(), 1),
            "gt_accuracy": np.trace(self.gt_confusion) / max(
                self.gt_confusion.sum(), 1),
        }
        mu, cov = activation_statistics(gen)
        gt_mu, gt_cov = activation_statistics(gt)
        metrics["FID"] = frechet_distance(gt_mu, gt_cov, mu, cov)

        if len(gen) > self.diversity_times:
            metrics["Diversity"] = calculate_diversity(
                gen, self.diversity_times, rng)
            metrics["gt_Diversity"] = calculate_diversity(
                gt, self.diversity_times, rng)
        counts = np.bincount(labels, minlength=self.num_labels)
        min_count = counts[counts > 0].min() if (counts > 0).any() else 0
        if min_count > self.multimodality_times:
            grouped = np.stack([gen[labels == c][:min_count]
                                for c in range(self.num_labels)
                                if counts[c] > 0])
            metrics["Multimodality"] = calculate_multimodality(
                grouped, self.multimodality_times, rng)
        return {k: float(v) for k, v in metrics.items()}
