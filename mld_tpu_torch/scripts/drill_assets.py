"""Fabricated release assets for the parity drill, in the layout
``scripts/parity_drill.py:asset_paths`` reads and the schema of each real
file, built from the port's own modules and seeded weights:

  - the checkpoint, a Lightning-style ``.ckpt``: ``{"state_dict":
    {vae.*, denoiser.* (with emb_proj.1), denoiser.sequence_pos_encoding.pe,
    text_encoder.*}, "hyper_parameters": {"cfg": argparse.Namespace}}``;
  - the CLIP clone, an HF ``CLIPTextModelWithProjection`` state dict (with
    its ``position_ids`` buffer) as ``pytorch_model.bin``, or as
    ``model.safetensors`` where the ``safetensors`` package is there to
    write it;
  - ``finest.tar``, the three t2m evaluators' state dicts under the
    reference's keys (``eval/pipeline.py:T2MEvaluatorBundle``), from a
    trained bundle's tree or seeded random weights;
  - the evaluator-space meta statistics ``mean.npy`` / ``std.npy``;
  - a HumanML3D-layout corpus (``data/synthetic.py``), or a link to one.

The drill's verdict on such assets means nothing: they show its mechanics
(the JAX package's test fabricates the same schema from the reference's
modules, ``tests/test_parity_drill.py``). Host only: no device.
"""
from __future__ import annotations

import argparse
import os
from typing import Mapping, Optional

import numpy as np
import torch

from mld_tpu_torch.scripts.parity_drill import asset_paths


def _seeded_like(state: Mapping, seed: int, scale: float = 0.05):
    """Seeded normal values of each tensor's shape; LayerNorm weights (and
    other ``*norm*.weight``) around 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in state.items():
        arr = (scale * rng.randn(*v.shape)).astype(np.float32)
        if "norm" in k and k.endswith("weight"):
            arr += 1.0
        out[k] = torch.from_numpy(arr)
    return out


def fabricate(root: str, cfg, seed: int = 0,
              t2m_params: Optional[Mapping] = None,
              corpus: Optional[str] = None, n_clips: int = 48,
              clip_format: str = "bin") -> dict:
    """Write every asset of the drill under `root` for a model of `cfg`
    (its widths and depths); returns asset_paths(root). `t2m_params`: a
    t2m bundle's tree (``T2MEvaluatorBundle.params_tree``) for finest.tar,
    else seeded random evaluators. `corpus`: a HumanML3D-layout directory to
    link as the dataset, else `n_clips` synthetic clips are built.
    `clip_format`: "bin" or "safetensors"."""
    from mld_tpu_torch.data.synthetic import build_synthetic_dataset
    from mld_tpu_torch.eval.pipeline import NETS, T2MEvaluatorBundle
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.utils.checkpoint import model_state

    paths = asset_paths(root)
    mld = MLD(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))

    # 1. the released-format checkpoint
    state = _seeded_like(model_state(mld), seed + 1)
    D = cfg.model.latent_dim
    state["denoiser.sequence_pos_encoding.pe"] = torch.from_numpy(
        np.random.RandomState(seed + 2).randn(5000, 1, D).astype(np.float32))
    state["text_encoder.text_model.final_layer_norm.weight"] = torch.ones(
        cfg.model.text_encoded_dim)
    os.makedirs(os.path.dirname(paths["ckpt"]), exist_ok=True)
    torch.save({"state_dict": state, "epoch": 0, "global_step": 0,
                "hyper_parameters": {"cfg": argparse.Namespace(lr=1e-4)}},
               paths["ckpt"])

    # 2. the HF CLIP clone's text tower
    tower = _seeded_like(mld.clip.state_dict(), seed + 3, scale=0.02)
    tower["text_model.embeddings.position_ids"] = torch.arange(
        mld.clip.text_model.embeddings.position_embedding.num_embeddings)[None]
    os.makedirs(paths["clip"], exist_ok=True)
    if clip_format == "safetensors":
        from safetensors.torch import save_file
        save_file(tower, os.path.join(paths["clip"], "model.safetensors"))
    else:
        torch.save(tower, os.path.join(paths["clip"], "pytorch_model.bin"))

    # 3. the t2m evaluators in finest.tar's schema
    bundle = T2MEvaluatorBundle(cfg, t2m_params, device="cpu", seed=seed + 4)
    os.makedirs(os.path.dirname(paths["t2m_tar"]), exist_ok=True)
    torch.save({tar_key: getattr(bundle, attr).state_dict()
                for _, tar_key, attr in NETS}, paths["t2m_tar"])

    # 4. the evaluator-space meta statistics
    nf = cfg.dataset.nfeats
    os.makedirs(paths["t2m_meta"], exist_ok=True)
    rng = np.random.RandomState(seed + 5)
    np.save(os.path.join(paths["t2m_meta"], "mean.npy"),
            (0.01 * rng.randn(nf)).astype(np.float32))
    np.save(os.path.join(paths["t2m_meta"], "std.npy"),
            np.ones(nf, np.float32))

    # 5. the HumanML3D-layout corpus
    os.makedirs(os.path.dirname(paths["data"]), exist_ok=True)
    if corpus is not None:
        if os.path.lexists(paths["data"]):
            os.remove(paths["data"])
        os.symlink(os.path.abspath(corpus), paths["data"])
    else:
        build_synthetic_dataset(paths["data"], n_samples=n_clips, seed=seed)
    return paths
