"""Action-to-motion datasets, HumanAct12 and UESTC (the twin of
``mld_tpu/data/a2m.py``).

Parity target: mld/data/a2m/ (dataset.py:14-145, humanact12poses.py:11-60,
uestc.py): pose_rep rot6d + root translation, fixed-length frame sampling,
root-centring. Features are [T, 150] = 24 x rot6d + one translation row
padded to 6. The rot6d of a clip is computed by ``ops/rotation.py`` (torch,
f32, on the CPU), where the JAX package computes it with jnp; everything else
is numpy, as there. ``synth_humanact12_pkl`` is a carried copy (the same
bytes from the same seed).

When the license-gated pkl is absent, a synthetic pose archive with the same
schema is generated (smooth axis-angle walks per action class). Each dataset
draws its crops from its own ``RandomState(1234)``; the 90/10 split is a
``RandomState(0)`` permutation, unless the pkl carries a split.

The UESTC dataset copies its pkl to ``humanact12poses.pkl`` in its own root
(``a2m.py:150-165``): the two presets need different ``dataset.root``s.
"""
from __future__ import annotations

import os
import pickle
import shutil
from typing import Optional

import numpy as np
import torch

from mld_tpu_torch.ops.rotation import axis_angle_to_rotation_6d
from .collate import A2MCollator
from .datamodule import make_loader
from .dataset import DataLoader

HUMANACT12_ACTIONS = {
    0: "warm_up", 1: "walk", 2: "run", 3: "jump", 4: "drink",
    5: "lift_dumbbell", 6: "sit", 7: "eat", 8: "turn steering wheel",
    9: "phone", 10: "boxing", 11: "throw",
}


def synth_humanact12_pkl(path: str, n_per_class: int = 8, seed: int = 0,
                         num_classes: int = 12):
    """Write a schema-compatible humanact12poses.pkl with synthetic poses.

    Class-conditioned the same way data/synthetic.py v2 conditions on
    captions: each class carries a static pose bias AND a distinct
    oscillation (frequency/amplitude/joint-subset all deterministic in the
    class id), so a GRU classifier trained on the corpus separates classes
    from dynamics — which is what lets the a2m accuracy/FID protocol
    discriminate trained generators from random ones (the reference's
    frozen action-recognition nets do the same through the real data)."""
    rng = np.random.RandomState(seed)
    poses, joints3d, ys = [], [], []
    for c in range(num_classes):
        # deterministic per-class motion signature
        crng = np.random.RandomState(10007 * (c + 1))
        freq = 0.35 + 0.22 * c                  # cycles/sec at 20 fps
        joints_sel = crng.permutation(24)[:8]   # which joints oscillate
        axis_dir = crng.randn(8, 3)
        axis_dir /= np.linalg.norm(axis_dir, axis=-1, keepdims=True)
        for i in range(n_per_class):
            T = int(rng.randint(40, 120))
            base = rng.randn(24, 3) * 0.1
            walk = np.cumsum(0.015 * rng.randn(T, 24, 3), axis=0)
            t = np.arange(T) / 20.0
            osc = 0.45 * np.sin(2 * np.pi * freq * t
                                + rng.uniform(0, 2 * np.pi))
            pose = base[None] + walk + 0.05 * c
            pose[:, joints_sel] += osc[:, None, None] * axis_dir[None]
            poses.append(pose.reshape(T, 72).astype(np.float32))
            joints3d.append(rng.randn(T, 24, 3).astype(np.float32) * 0.3)
            ys.append(c)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"poses": poses, "joints3D": joints3d, "y": ys}, f)
    return path


class HumanAct12Dataset:
    """rot6d + translation features with fixed-length sampling
    (a2m/dataset.py:14)."""

    def __init__(self, datapath: str, num_frames: int = 60, split="train",
                 rng: Optional[np.random.RandomState] = None,
                 synthesize_if_missing: bool = True):
        pkl_path = os.path.join(datapath, "humanact12poses.pkl")
        if not os.path.exists(pkl_path):
            if not synthesize_if_missing:
                raise FileNotFoundError(pkl_path)
            synth_humanact12_pkl(pkl_path)
        with open(pkl_path, "rb") as f:
            data = pickle.load(f)
        self._pose = data["poses"]
        self._joints = data["joints3D"]
        self._actions = list(data["y"])
        self.num_frames = num_frames
        self.num_classes = 12
        self.rng = rng or np.random.RandomState(1234)
        self._rot6d_cache = {}
        n = len(self._pose)
        if "split" in data:  # an explicit split (uestc.py:78-88 semantics)
            key = "train" if split == "train" else "test"
            self.indices = np.asarray(data["split"][key], int)
        else:
            split_point = int(0.9 * n)
            order = np.random.RandomState(0).permutation(n)
            self.indices = (order[:split_point] if split == "train"
                            else order[split_point:])

    def __len__(self):
        return len(self.indices)

    def _frame_ix(self, total: int) -> np.ndarray:
        """Fixed-length sampling: a random crop if long, else pad by
        repeating the last frame."""
        T = self.num_frames
        if total >= T:
            start = self.rng.randint(0, total - T + 1)
            return np.arange(start, start + T)
        idx = np.arange(total)
        return np.concatenate([idx, np.full(T - total, total - 1)])

    def _rot6d(self, ind: int) -> np.ndarray:
        """A clip's rot6d [T, 24, 6], computed once."""
        if ind not in self._rot6d_cache:
            pose_aa = torch.as_tensor(self._pose[ind].reshape(-1, 24, 3))
            self._rot6d_cache[ind] = axis_angle_to_rotation_6d(
                pose_aa).numpy()
        return self._rot6d_cache[ind]

    def __getitem__(self, i: int) -> dict:
        ind = int(self.indices[i])
        total = len(self._pose[ind])
        frame_ix = self._frame_ix(total)
        rot6d = self._rot6d(ind)[frame_ix]
        trans = self._joints[ind][frame_ix][:, 0, :]
        trans = trans - trans[0:1]
        padded_tr = np.zeros((rot6d.shape[0], 6), np.float32)
        padded_tr[:, :3] = trans
        feats = np.concatenate([rot6d.reshape(-1, 144), padded_tr], axis=-1)
        return {
            "motion": feats.astype(np.float32),
            "action": self._actions[ind],
            "action_text": HUMANACT12_ACTIONS.get(
                self._actions[ind], f"action_{self._actions[ind]}"),
            "length": min(total, self.num_frames),
        }


class UestcDataset(HumanAct12Dataset):
    """UESTC (40 action classes) from the same preprocessed pose-pkl
    schema, read through the HumanAct12 reader from a copy named
    humanact12poses.pkl in the same root."""

    PKL_NAME = "uestc_poses.pkl"

    def __init__(self, datapath: str, num_frames: int = 60, split="train",
                 rng=None, synthesize_if_missing: bool = True):
        pkl_path = os.path.join(datapath, self.PKL_NAME)
        real = os.path.join(datapath, "humanact12poses.pkl")
        if not os.path.exists(pkl_path) and synthesize_if_missing:
            synth_humanact12_pkl(real, n_per_class=4, num_classes=40)
            os.rename(real, pkl_path)
        if not os.path.exists(real):
            shutil.copy(pkl_path, real)
        super().__init__(datapath, num_frames, split, rng,
                         synthesize_if_missing=False)
        self.num_classes = 40


class A2MDataModule:
    """The a2m data module: features are already in model space (mean 0,
    std 1 statistics), and the collator pads to ``dataset.num_frames``."""

    name = "humanact12"

    def __init__(self, cfg):
        self.cfg = cfg
        self.nfeats = 150
        self.njoints = 24
        self.num_frames = cfg.dataset.num_frames
        self.collate = A2MCollator(self.num_frames)
        self._datasets = {}
        self.is_mm = False
        self.mean = np.zeros(self.nfeats, np.float32)
        self.std = np.ones(self.nfeats, np.float32)
        self.mean_eval, self.std_eval = self.mean, self.std
        self._dataset_cls = (UestcDataset
                             if cfg.dataset.name.lower() == "uestc"
                             else HumanAct12Dataset)

    def dataset(self, split: str):
        split = "train" if split == "train" else "test"
        if split not in self._datasets:
            self._datasets[split] = self._dataset_cls(
                self.cfg.dataset.root, self.num_frames, split)
        return self._datasets[split]

    def loader(self, split: str, batch_size: Optional[int] = None,
               shuffle: Optional[bool] = None, seed: int = 0,
               drop_last: bool = False,
               prefetch: Optional[int] = None) -> DataLoader:
        """The text loader's parameters (``datamodule.py:121-124``). The
        JAX package's a2m loader has no `drop_last`, so its ``train()``
        raises on these presets (``loop.py:217``); for one seed, this one's
        batches are its batches, with a short last batch dropped under
        `drop_last`."""
        if batch_size is None:
            batch_size = (self.cfg.train.batch_size if split == "train"
                          else self.cfg.eval.batch_size)
        if shuffle is None:
            shuffle = split == "train"
        return make_loader(self.dataset(split), batch_size, self.collate,
                           split, shuffle, seed, drop_last, prefetch)


def get_a2m_datamodule(cfg):
    return A2MDataModule(cfg)
