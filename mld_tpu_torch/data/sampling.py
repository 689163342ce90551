"""Framerate resampling utilities (a carried copy of
``mld_tpu/data/sampling.py``; numpy only, held equal to the original by
``tests/test_torch_e2e.py``).

Parity target: mld/utils/temos_utils.py:104-125 (re-exported via
mld/data/sampling/) — integer-step subsampling and linear-interpolation
upsampling between framerates.
"""
from __future__ import annotations

import numpy as np


def subsample(num_frames: int, last_framerate: float,
              new_framerate: float) -> np.ndarray:
    """Frame indices that downsample last_framerate -> new_framerate."""
    step = int(last_framerate / new_framerate)
    assert step >= 1
    return np.arange(0, num_frames, step)


def upsample(motion: np.ndarray, last_framerate: float,
             new_framerate: float) -> np.ndarray:
    """Linear interpolation upsampling along axis 0."""
    step = int(new_framerate / last_framerate)
    assert step >= 1
    alpha = np.linspace(0, 1, step + 1)
    last = np.einsum("l,t...->lt...", 1 - alpha, motion[:-1])
    new = np.einsum("l,t...->lt...", alpha, motion[1:])
    chunks = (last + new)[:-1]
    output = np.concatenate(chunks.swapaxes(1, 0))
    return np.concatenate((output, motion[[-1]]))
