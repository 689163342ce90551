"""Capability presets mirroring the reference experiment configs (carried
copy of ``mld_tpu/config/presets.py``, held equal by a test).

  mld_humanml3d   <- configs/config_mld_humanml3d.yaml   (t2m latent diffusion)
  vae_humanml3d   <- configs/config_vae_humanml3d.yaml   (stage-1 VAE)
  novae_humanml3d <- configs/config_novae_humanml3d.yaml (raw-motion diffusion)
  mld_humanact12  <- configs/config_mld_humanact12.yaml  (action-to-motion)
  mld_kit         <- KIT-ML variant of mld_humanml3d
"""
from __future__ import annotations

import copy
from typing import Dict

from .core import Config, config_to_dict, merge_dicts

_BASE = config_to_dict(Config())

_PRESETS: Dict[str, dict] = {}


def _register(name: str, overlay: dict):
    _PRESETS[name] = merge_dicts(copy.deepcopy(_BASE), overlay)


_register("mld_humanml3d", {
    "name": "mld_humanml3d",
    "model": {"vae": True, "vae_type": "mld", "condition": "text",
              "latent_size": 1, "latent_dim": 256, "num_layers": 9,
              "denoiser_num_layers": 9, "guidance_scale": 7.5,
              "guidance_uncondp": 0.1},
    "train": {"stage": "diffusion", "batch_size": 64},
    "dataset": {"name": "humanml3d", "njoints": 22, "nfeats": 263},
})

_register("vae_humanml3d", {
    "name": "vae_humanml3d",
    "model": {"vae": True, "vae_type": "mld", "condition": "text"},
    "train": {"stage": "vae", "batch_size": 128},
    "dataset": {"name": "humanml3d", "njoints": 22, "nfeats": 263},
})

_register("novae_humanml3d", {
    "name": "novae_humanml3d",
    # no VAE: denoise raw 263-dim motion, trans_dec denoiser, DDPM-1000
    "model": {"vae": False, "vae_type": "no", "condition": "text",
              "latent_size": 1, "latent_dim": 512,
              "denoiser_arch": "trans_dec", "denoiser_num_layers": 9,
              "scheduler": {"kind": "ddpm", "num_inference_timesteps": 1000,
                            "clip_sample": False}},
    "train": {"stage": "diffusion"},
    "dataset": {"name": "humanml3d", "njoints": 22, "nfeats": 263},
})

_register("novae_stress_s512", {
    "name": "novae_stress_s512",
    # long-sequence stressor beyond the reference's T=196: raw-motion
    # diffusion over 512 frames — the config where the fused Pallas
    # attention kernel engages by default (ops/attention.py dispatch)
    "model": {"vae": False, "vae_type": "no", "condition": "text",
              "latent_size": 1, "latent_dim": 512,
              "denoiser_arch": "trans_dec", "denoiser_num_layers": 9,
              "scheduler": {"kind": "ddpm", "num_inference_timesteps": 1000,
                            "clip_sample": False}},
    "train": {"stage": "diffusion"},
    "dataset": {"name": "humanml3d", "njoints": 22, "nfeats": 263,
                "max_motion_len": 512},
})

_register("mld_humanact12", {
    "name": "mld_humanact12",
    "model": {"vae": True, "vae_type": "actor", "condition": "action",
              "latent_size": 1, "latent_dim": 256,
              "denoiser_num_layers": 15, "guidance_scale": 7.5,
              "nclasses": 12},
    "train": {"stage": "diffusion"},
    "dataset": {"name": "humanact12", "njoints": 24, "nfeats": 150,
                "nclasses": 12, "num_frames": 60},
    "eval": {"metrics": ["HUMANACTMetrics"]},
})

_register("mld_uestc", {
    "name": "mld_uestc",
    "model": {"vae": True, "vae_type": "actor", "condition": "action",
              "latent_size": 1, "latent_dim": 256,
              "denoiser_num_layers": 9, "guidance_scale": 7.5,
              "nclasses": 40},
    "train": {"stage": "diffusion"},
    "dataset": {"name": "uestc", "njoints": 24, "nfeats": 150,
                "nclasses": 40, "num_frames": 60, "root": "datasets/uestc"},
    "eval": {"metrics": ["UESTCMetrics"]},
})

_register("mld_kit", {
    "name": "mld_kit",
    "model": {"vae": True, "vae_type": "mld", "condition": "text"},
    "train": {"stage": "diffusion"},
    "dataset": {"name": "kit", "njoints": 21, "nfeats": 251,
                "frame_rate": 12.5, "root": "datasets/kit-ml"},
})


def get_preset(name: str) -> dict:
    if name not in _PRESETS:
        raise KeyError(
            f"unknown preset '{name}'; available: {sorted(_PRESETS)}")
    return copy.deepcopy(_PRESETS[name])


def list_presets():
    return sorted(_PRESETS)
