"""Checkpoints of the port's training (the twin of
``mld_tpu/utils/checkpoint.py``), and a reader of the JAX package's npz
exports.

A checkpoint is one ``torch.save`` file ``<dir>/<step>.pt`` holding
``{"step", "state_dict", "optimizer"}``: the model's ``state_dict`` without
the frozen CLIP tower (the JAX package strips it too and re-initialises it
on load) and the optimizer's. The model's under ``state_dict``, in the
reference torch names, is what the JAX package's
``load_reference_checkpoint`` reads from a Lightning checkpoint, so a port
checkpoint is a ``pretrained_vae`` / ``pretrained`` the JAX package loads.
Every checkpoint is kept, as the reference keeps every one
(``save_top_k=-1``); resume takes the latest step.

``load_params_npz`` reads a ``save_params_npz`` file of the JAX package
(``mld_tpu/utils/checkpoint.py:60-86``, which ``save_params_npz`` writes
here too) with numpy alone, into the flax tree
that ``utils/convert.py`` bridges to torch names; ``load_pretrained`` loads
the vae and / or denoiser of either package's checkpoint into a model, so a
VAE trained by either package hands off to the other's diffusion stage, and
the CLIP text tower of an npz that holds one (the JAX loader,
``mld_tpu/train/loop.py:_load_pretrained``, copies every subtree of such a
file, ``clip`` included: a tower trained by ``train/pretrain.py``).
``save_params_npz(path, mld.params_tree())`` writes a model as such a
file, which the JAX package's ``test.py --checkpoint`` and
``train.pretrained`` read. ``load_pretrained`` also reads a released
reference Lightning checkpoint (``reference_state``), as the JAX demo's
``--checkpoint`` does; every file is loaded weights-only unless the caller
passes ``trust`` (``_load_file``).
"""
from __future__ import annotations

import argparse
import os
import pickle
import re
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from mld_tpu_torch.utils.convert import (flax_clip_to_state_dict,
                                         flax_to_state_dict)

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state_dict without the frozen CLIP tower."""
    return {k: v for k, v in model.state_dict().items()
            if not k.startswith("clip.")}


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def save(self, step: int, model: torch.nn.Module, optimizer=None):
        payload = {"step": int(step), "state_dict": model_state(model),
                   "optimizer": (optimizer.state_dict()
                                 if optimizer is not None else None)}
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))

    def steps(self):
        found = (_STEP_FILE.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)


def save_params_npz(path: str, tree: Mapping):
    """A nested dict of arrays -> a JAX package ``save_params_npz`` file
    (keys joined by "/")."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict:
    """A JAX package ``save_params_npz`` file -> nested dict of numpy
    arrays (keys split on "/")."""
    tree: Dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree


def reference_state(payload) -> Dict[str, torch.Tensor]:
    """The vae and denoiser of a released reference checkpoint (a Lightning
    ``{"state_dict": ...}`` or a bare state dict), as the JAX package's
    ``load_reference_checkpoint`` takes them (``mld_tpu/utils/
    checkpoint.py:89-119``). The port's modules carry the reference torch
    names, so what JAX renames for flax is kept as it is here: the
    denoiser's ``emb_proj.1`` (Sequential(ReLU, Linear)) and an action
    denoiser's ``emb_proj.action_embedding`` (EmbedAction). The frozen text
    encoder (``text_encoder.*``) is not taken, as JAX does not take it, and
    keys the model lacks (``denoiser.sequence_pos_encoding.pe``, which the
    reference itself strips on load) are ignored by ``load_pretrained``."""
    state = payload.get("state_dict", payload)
    return {k: torch.as_tensor(v) for k, v in state.items()
            if k.startswith(("vae.", "denoiser."))}


# what a Lightning checkpoint's hyper-parameters may hold besides tensors and
# containers, and that a weights-only load may build: nothing of it runs code
_SAFE_GLOBALS = (argparse.Namespace,)


def _load_file(path: str, trust: bool = False):
    """torch.load of a checkpoint file, tensors and containers only (and
    ``_SAFE_GLOBALS``). A file holding other objects (a released reference
    checkpoint whose hyper-parameters are pickled config objects) raises,
    unless ``trust``: then it is unpickled fully, which runs whatever code
    the file names, as the JAX package's loader does for every file."""
    try:
        with torch.serialization.safe_globals(list(_SAFE_GLOBALS)):
            return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        if not trust:
            raise pickle.UnpicklingError(
                f"{path} holds objects other than tensors, so loading it "
                f"runs code; load it with trust=True (demo: "
                f"--trust_checkpoint) only if you trust the file") from err
    return torch.load(path, map_location="cpu", weights_only=False)


def _state_from(path: str, trust: bool = False) -> Dict[str, torch.Tensor]:
    """Torch-named state of the modules in a checkpoint: a JAX npz export
    (its vae, denoiser and clip), a port checkpoints directory (its latest
    step; vae and denoiser), or a file: a port checkpoint or a released
    reference checkpoint. Both kinds of file are read through one path,
    ``reference_state``, whatever their suffix (the port writes ``.pt``
    files and the JAX package reads a ``.pt`` as a reference checkpoint): a
    port checkpoint's ``state_dict`` holds only the vae and denoiser, in the
    reference names."""
    if path.endswith(".npz"):
        tree = load_params_npz(path)
        tree = tree.get("params", tree)
        state = {f"{top}.{k}": v for top in ("vae", "denoiser") if top in tree
                 for k, v in flax_to_state_dict(tree[top]).items()}
        if "clip" in tree:
            state.update({f"clip.{k}": v for k, v in
                          flax_clip_to_state_dict(tree["clip"]).items()})
        return state
    if os.path.isdir(path):
        return CheckpointManager(path).restore()["state_dict"]
    return reference_state(_load_file(path, trust))


def load_pretrained(model: torch.nn.Module, path: str,
                    only: Optional[Iterable[str]] = None,
                    trust: bool = False) -> Iterable[str]:
    """Load the top-level modules `only` (default: every one the checkpoint
    has among vae / denoiser / clip that the model has) from `path` into
    `model`, as ``_load_pretrained`` does. Every parameter of a loaded
    module must be in the checkpoint. `trust` lets a file that holds more
    than tensors be unpickled fully (``_load_file``). Returns the modules
    loaded."""
    state = _state_from(path, trust)
    tops = sorted({k.split(".", 1)[0] for k in state}
                  & {t for t in ("vae", "denoiser", "clip")
                     if getattr(model, t, None) is not None})
    if only is not None:
        tops = [t for t in tops if t in set(only)]
        missing_tops = set(only) - set(tops)
        if missing_tops:
            raise KeyError(f"{path} holds no {sorted(missing_tops)}")
    own = model.state_dict()
    sub = {k: v for k, v in state.items() if k.split(".", 1)[0] in tops}
    missing = [k for k in own if k.split(".", 1)[0] in tops and k not in sub]
    if missing:
        raise KeyError(f"{path} lacks {missing[:5]} ...")
    model.load_state_dict(sub, strict=False)
    return tops


def restore_model(model: torch.nn.Module, payload: Mapping):
    """Load a checkpoint's model state (CLIP excluded) strictly."""
    result = model.load_state_dict(payload["state_dict"], strict=False)
    missing = [k for k in result.missing_keys if not k.startswith("clip.")]
    if missing or result.unexpected_keys:
        raise KeyError(f"checkpoint does not match the model: missing "
                       f"{missing[:5]}, unexpected "
                       f"{result.unexpected_keys[:5]}")
