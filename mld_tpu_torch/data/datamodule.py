"""The HumanML3D data module (the twin of ``HumanML3DDataModule``,
``mld_tpu/data/datamodule.py:22-75``): the corpus on disk, its Mean / Std,
the word vectorizer, the collator and the per-split loaders.

When ``Mean.npy`` is missing, or the corpus carries a ``.synth_version``
stamp other than the current one, the synthetic corpus is built in its place
(64 clips in debug, else 256), as the original does; a real dataset never
carries the stamp and is never touched. The evaluator-space statistics and
the native C++ loader are not part of this slice.
"""
from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Optional

import numpy as np

from .collate import MldCollator
from .dataset import DataLoader, PrefetchDataLoader, Text2MotionDataset
from .synthetic import SYNTH_VERSION, build_synthetic_dataset
from .word_vectorizer import WordVectorizer


def needs_synthesis(root: str) -> bool:
    """No Mean.npy, or a synthetic corpus of another generator version."""
    stamp = pjoin(root, ".synth_version")
    if os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() != str(SYNTH_VERSION):
                return True
    return not os.path.exists(pjoin(root, "Mean.npy"))


class HumanML3DDataModule:
    name = "humanml3d"

    def __init__(self, cfg, tokenizer=None):
        self.cfg = cfg
        ds = cfg.dataset
        self.root = ds.root
        self.njoints = ds.njoints
        if needs_synthesis(self.root):
            build_synthetic_dataset(self.root,
                                    n_samples=64 if cfg.debug else 256,
                                    dataset=self.name)
        self.mean = np.load(pjoin(self.root, "Mean.npy"))
        self.std = np.load(pjoin(self.root, "Std.npy"))
        self.w_vectorizer = WordVectorizer(ds.word_vectorizer_path, "our_vab")
        self.collate = MldCollator(ds.max_motion_len, tokenizer)
        self._datasets = {}
        self.nfeats = ds.nfeats

    def _make(self, split: str):
        ds = self.cfg.dataset
        # GloVe/POS features feed the t2m evaluators only; the train split
        # skips them
        return Text2MotionDataset(
            self.root, split, self.mean, self.std, self.w_vectorizer,
            max_motion_length=ds.max_motion_len,
            min_motion_length=ds.min_motion_len,
            max_text_len=ds.max_text_len, unit_length=ds.unit_len,
            fps=ds.frame_rate, debug=self.cfg.debug,
            with_eval_embeddings=split != "train")

    def dataset(self, split: str) -> Text2MotionDataset:
        if split not in self._datasets:
            self._datasets[split] = self._make(split)
        return self._datasets[split]

    def loader(self, split: str, batch_size: Optional[int] = None,
               shuffle: Optional[bool] = None, seed: int = 0,
               drop_last: bool = False,
               prefetch: Optional[int] = None) -> DataLoader:
        if batch_size is None:
            batch_size = (self.cfg.train.batch_size if split == "train"
                          else self.cfg.eval.batch_size)
        if shuffle is None:
            shuffle = split == "train"
        if prefetch is None:
            prefetch = 3 if split == "train" else 0
        if prefetch > 0:
            return PrefetchDataLoader(
                self.dataset(split), batch_size, self.collate,
                shuffle=shuffle, seed=seed, drop_last=drop_last,
                prefetch=prefetch)
        return DataLoader(self.dataset(split), batch_size, self.collate,
                          shuffle=shuffle, seed=seed, drop_last=drop_last)


class KitDataModule(HumanML3DDataModule):
    name = "kit"


def get_datamodule(cfg, tokenizer=None) -> HumanML3DDataModule:
    name = cfg.dataset.name.lower()
    if name == "humanml3d":
        return HumanML3DDataModule(cfg, tokenizer)
    if name == "kit":
        return KitDataModule(cfg, tokenizer)
    raise ValueError(f"dataset {name} is not in the port yet")
