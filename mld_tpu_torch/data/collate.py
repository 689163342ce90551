"""Batch collators emitting static-shape numpy batches (carried copy of
``lengths_to_mask_np``, ``MldCollator`` and ``A2MCollator`` from
``mld_tpu/data/collate.py``, held equal to the originals by
``tests/test_torch_train_data.py`` and ``tests/test_torch_a2m.py``).

Parity target: mld/data/utils.py:12-98 (right-padding, the text-length
sort), except that motion is padded to the configured max_motion_len rather
than the batch's longest. CLIP tokenization happens here, on the host.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def lengths_to_mask_np(lengths, max_len: int) -> np.ndarray:
    return np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]


class MldCollator:
    """Text-to-motion batches: motion/mask/text ids/evaluator word feats."""

    def __init__(self, max_motion_len: int = 196,
                 tokenizer: Optional[Callable] = None):
        self.max_motion_len = max_motion_len
        self.tokenizer = tokenizer

    def __call__(self, items: List[dict]) -> dict:
        # sort desc by text_len (mld_collate:58; GRU evaluator ordering)
        items = sorted(items, key=lambda x: x.get("text_len", 0),
                       reverse=True)
        B = len(items)
        T = self.max_motion_len
        nfeats = items[0]["motion"].shape[-1]
        motion = np.zeros((B, T, nfeats), np.float32)
        lengths = np.zeros((B,), np.int32)
        for i, it in enumerate(items):
            L = min(len(it["motion"]), T)
            motion[i, :L] = it["motion"][:L]
            lengths[i] = L
        batch = {
            "motion": motion,
            "length": lengths,
            "mask": lengths_to_mask_np(lengths, T),
            "text": [it["text"] for it in items],
        }
        if "word_embs" in items[0]:
            batch["word_embs"] = np.stack(
                [it["word_embs"] for it in items]).astype(np.float32)
            batch["pos_ohot"] = np.stack(
                [it["pos_ohot"] for it in items]).astype(np.float32)
            batch["text_len"] = np.asarray(
                [it["text_len"] for it in items], np.int32)
            batch["tokens"] = [it.get("tokens", "") for it in items]
        if self.tokenizer is not None:
            batch["text_ids"] = np.asarray(
                self.tokenizer(batch["text"]), np.int32)
        return batch


class A2MCollator:
    """Action-to-motion batches (a2m_collate:77-98 semantics)."""

    def __init__(self, max_motion_len: int = 60):
        self.max_motion_len = max_motion_len

    def __call__(self, items: List[dict]) -> dict:
        B = len(items)
        T = self.max_motion_len
        nfeats = items[0]["motion"].shape[-1]
        motion = np.zeros((B, T, nfeats), np.float32)
        lengths = np.zeros((B,), np.int32)
        actions = np.zeros((B,), np.int32)
        for i, it in enumerate(items):
            L = min(len(it["motion"]), T)
            motion[i, :L] = it["motion"][:L]
            lengths[i] = L
            actions[i] = int(it["action"])
        return {
            "motion": motion,
            "length": lengths,
            "mask": lengths_to_mask_np(lengths, T),
            "action": actions,
            "action_text": [it.get("action_text", "") for it in items],
        }
