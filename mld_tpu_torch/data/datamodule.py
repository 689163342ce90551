"""The HumanML3D data module (the twin of ``HumanML3DDataModule``,
``mld_tpu/data/datamodule.py:22-75``): the corpus on disk, its Mean / Std,
the word vectorizer, the collator and the per-split loaders, and the
evaluator-space statistics and MultiModality sample swap of the evaluation
protocol.

When ``Mean.npy`` is missing, or the corpus carries a ``.synth_version``
stamp other than the current one, the synthetic corpus is built in its place
(64 clips in debug, else 256), as the original does; a real dataset never
carries the stamp and is never touched.

With ``dataset.native_loader`` (the default) the collator is
``NativeMldCollator`` over the lazy dataset: the C++ loader
(``mld_tpu_torch/native``) reads, crops, normalizes and pads the motion.
When the loader cannot be built the numpy collator serves instead, as in
the original (the batches are the same either way, and the loader is host
code); the module logs which collator it took and, on a fallback, the build
error. ``use_native`` says which.

One departure: in MultiModality mode the JAX loader forces a batch of one
text (``mld_tpu/data/datamodule.py:136-137``), whose 30 repeats then make a
batch; the port's evaluator batches ``eval.batch_size`` texts x 30 repeats a
call (``eval/pipeline.py``), so its loader keeps the batch size asked for.
"""
from __future__ import annotations

import logging
import os
from os.path import join as pjoin
from typing import Optional

import numpy as np

from .collate import MldCollator, NativeMldCollator
from .dataset import (DataLoader, PrefetchDataLoader, Text2MotionDataset,
                      Text2MotionDatasetLazy)
from .synthetic import SYNTH_VERSION, build_synthetic_dataset
from .word_vectorizer import WordVectorizer

_log = logging.getLogger(__name__)


class MemoWordVectorizer(WordVectorizer):
    """The word vectorizer with its offline fallback vectors (a fresh seeded
    RandomState a lookup, ~0.3 ms: 22 tokens an item made the evaluator
    trainer's loader 0.4 s a batch of 64 on the host) computed once a word.
    A word's vector is a function of the word, so the values are the
    carried vectorizer's; the cached arrays are read-only."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._memo = {}

    def _fallback_vec(self, word: str) -> np.ndarray:
        vec = self._memo.get(word)
        if vec is None:
            vec = self._memo[word] = super()._fallback_vec(word)
            vec.setflags(write=False)
        return vec


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
        # evaluator-space stats (t2m meta); fall back to model stats
        t2m_meta = pjoin(cfg.model.t2m_path, "t2m", "Comp_v6_KLD01", "meta")
        if os.path.exists(pjoin(t2m_meta, "mean.npy")):
            self.mean_eval = np.load(pjoin(t2m_meta, "mean.npy"))
            self.std_eval = np.load(pjoin(t2m_meta, "std.npy"))
        else:
            self.mean_eval, self.std_eval = self.mean, self.std
        self.w_vectorizer = MemoWordVectorizer(ds.word_vectorizer_path,
                                               "our_vab")
        self.use_native = False
        if ds.native_loader:
            try:
                self.collate = NativeMldCollator(
                    ds.max_motion_len, self.mean, self.std, tokenizer)
                self.use_native = True
                _log.info(f"{self.name}: native collator (C++ loader)")
            except RuntimeError as e:
                _log.warning(f"{self.name}: numpy collator (the native "
                             f"loader cannot be built: {e})")
        if not self.use_native:
            self.collate = MldCollator(ds.max_motion_len, tokenizer)
        self._datasets = {}
        self.is_mm = False
        self._mm_backup = None
        self.nfeats = ds.nfeats

    def _make(self, split: str, eval_embeddings: Optional[bool] = None):
        ds = self.cfg.dataset
        if eval_embeddings is None:
            # GloVe/POS features feed the t2m evaluators only; the train
            # split skips them
            eval_embeddings = split != "train"
        cls = Text2MotionDatasetLazy if self.use_native else Text2MotionDataset
        return cls(
            self.root, split, self.mean, self.std, self.w_vectorizer,
            max_motion_length=ds.max_motion_len,
            min_motion_length=ds.min_motion_len,
            max_text_len=ds.max_text_len, unit_length=ds.unit_len,
            fps=ds.frame_rate, debug=self.cfg.debug,
            with_eval_embeddings=eval_embeddings)

    def eval_embedding_loader(self, split: str = "train",
                              batch_size: Optional[int] = None,
                              seed: int = 0, shuffle: bool = True,
                              drop_last: bool = True) -> DataLoader:
        """Loader whose items carry GloVe/POS eval embeddings whatever the
        split: the evaluator trainer's (eval/t2m_train.py)."""
        if batch_size is None:
            batch_size = self.cfg.train.batch_size
        return DataLoader(self._make(split, eval_embeddings=True),
                          batch_size, self.collate, shuffle=shuffle,
                          seed=seed, drop_last=drop_last)

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
        return make_loader(self.dataset(split), batch_size, self.collate,
                           split, shuffle, seed, drop_last, prefetch)


    def renorm4t2m_np(self, feats: np.ndarray) -> np.ndarray:
        """model-space features -> the evaluators' normalisation."""
        feats = feats * self.std + self.mean
        return (feats - self.mean_eval) / self.std_eval

    def mm_mode(self, on: bool = True, mm_num_samples: int = 100,
                rng: Optional[np.random.RandomState] = None):
        """Restrict the test set to a random sample subset for MultiModality
        (HumanML3D.py:64-75), drawn from `rng` as the JAX package draws
        it."""
        test = self.dataset("test")
        if on:
            rng = rng or np.random.RandomState(0)
            self._mm_backup = list(test.name_list)
            n = min(mm_num_samples, len(test.name_list))
            chosen = rng.choice(len(test.name_list), n, replace=False)
            test.name_list = [self._mm_backup[i] for i in chosen]
            self.is_mm = True
        else:
            if self._mm_backup is not None:
                test.name_list = self._mm_backup
            self.is_mm = False


class KitDataModule(HumanML3DDataModule):
    name = "kit"


def make_loader(dataset, batch_size: int, collate, split: str,
                shuffle: bool, seed: int, drop_last: bool,
                prefetch: Optional[int]) -> DataLoader:
    """A data module's loader: `prefetch` batches assembled ahead on a
    thread (default 3 for the train split, none otherwise), or none."""
    if prefetch is None:
        prefetch = 3 if split == "train" else 0
    if prefetch > 0:
        return PrefetchDataLoader(dataset, batch_size, collate,
                                  shuffle=shuffle, seed=seed,
                                  drop_last=drop_last, prefetch=prefetch)
    return DataLoader(dataset, batch_size, collate, shuffle=shuffle,
                      seed=seed, drop_last=drop_last)


def get_datamodule(cfg, tokenizer=None):
    """The data module of ``cfg.dataset.name`` (``datamodule.py:185-195``):
    HumanML3D / KIT-ML (text), or HumanAct12 / UESTC (action, no
    tokenizer)."""
    name = cfg.dataset.name.lower()
    if name == "humanml3d":
        return HumanML3DDataModule(cfg, tokenizer)
    if name == "kit":
        return KitDataModule(cfg, tokenizer)
    if name in ("humanact12", "uestc"):
        from .a2m import get_a2m_datamodule
        return get_a2m_datamodule(cfg)
    raise ValueError(f"dataset {name} not supported")
