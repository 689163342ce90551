"""Motion-reconstruction metrics: MPJPE / PAMPJPE / ACCEL.

Carried copy of ``mld_tpu/metrics/mr.py`` (numpy and scipy only), held
equal to the original by ``tests/test_torch_eval.py``.

Parity target: mld/models/metrics/mr.py:11 + helpers utils.py:354-420.
Units: meters by default (force_in_meter scales joints by 1000 -> mm like
the reference METRIC.FORCE_IN_METER).
"""
from __future__ import annotations

import numpy as np

from .utils import calc_accel, calc_mpjpe, calc_pampjpe


class MRMetrics:
    def __init__(self, njoints: int = 22, force_in_meter: bool = True):
        self.njoints = njoints
        self.force_in_meter = force_in_meter
        self.reset()

    def reset(self):
        self.count = 0
        self.count_seq = 0
        self.mpjpe = 0.0
        self.pampjpe = 0.0
        self.accel = 0.0

    def update(self, joints_rst, joints_ref, lengths):
        scale = 1000.0 if self.force_in_meter else 1.0
        for i, L in enumerate(np.asarray(lengths)):
            L = int(L)
            pred = np.asarray(joints_rst[i][:L]) * scale
            gt = np.asarray(joints_ref[i][:L]) * scale
            self.mpjpe += float(np.sum(calc_mpjpe(pred, gt)))
            self.pampjpe += float(np.sum(calc_pampjpe(pred, gt)))
            if L > 2:
                self.accel += float(np.sum(calc_accel(pred, gt)))
            self.count += L
            self.count_seq += 1

    def compute(self) -> dict:
        c = max(self.count, 1)
        return {"MPJPE": self.mpjpe / c,
                "PAMPJPE": self.pampjpe / c,
                "ACCEL": self.accel / max(self.count - 2 * self.count_seq, 1)}
