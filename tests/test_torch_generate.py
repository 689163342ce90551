"""End to end: the port's generate_joints vs JAX's on a small text config.

JAX runs its serving path with the fused denoiser forced on
(MLD_TPU_FUSED_DENOISER=1, the Pallas kernel in interpret mode), so both
sides use LayerNorm eps 1e-5 in the denoiser stack. The port is fed the
initial latents JAX draws (mld.py:463-464). f32 throughout, text tower
included; the bar is tests/test_full_sampler_parity.py's: max |diff| of the
joints <= 1e-3 x max(scale, 1).

The kernel configuration (the port's fused_decode=True; its text tower
always takes the causal-attention wrapper) is held against JAX under
MLD_TPU_FUSED_DECODE=1 and MLD_TPU_CLIP_FLASH=1 too, where both packages
decode with LayerNorm eps 1e-5.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.mld import lengths_to_mask as jax_lengths_to_mask

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.utils import trace

SMALL = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                   "denoiser_num_layers": 3, "num_heads": 4,
                   "text_encoded_dim": 48, "clip_layers": 2,
                   "clip_heads": 2, "clip_compute_dtype": "float32"},
         "dataset": {"max_motion_len": 40}}
TEXTS = ["a man kicks something with his left leg.",
         "a person walks backward slowly.", "someone jumps"]
LENGTHS = [40, 23, 31]


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    mean = (0.1 * rng.randn(263)).astype(np.float32)
    std = (0.5 + rng.rand(263)).astype(np.float32)
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=SMALL),
                  mean=mean, std=std)
    params = jmld.init_params(jax.random.PRNGKey(0))
    tmld = MLD(load_config(preset="mld_humanml3d", overrides=SMALL),
               mean=mean, std=std, device="cpu")
    tmld.load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    return jmld, params, tmld


def test_generate_joints_matches_jax(pair, monkeypatch):
    monkeypatch.setenv("MLD_TPU_FUSED_DENOISER", "1")
    jmld, params, tmld = pair
    assert jmld._use_fused_denoiser()
    ids = tmld.tokenize(TEXTS)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jmld.tokenize(TEXTS)))
    mask = jax_lengths_to_mask(jnp.asarray(LENGTHS), jmld.max_frames)
    rng = jax.random.PRNGKey(3)
    ref = np.asarray(jmld.generate_joints(params, jnp.asarray(ids.numpy()),
                                          mask, rng))
    # the initial latents JAX's diffusion_reverse draws from the same key
    _, init_rng = jax.random.split(rng)
    init = np.asarray(jmld._init_latents(init_rng, len(TEXTS), mask))

    before = trace.total("launch.k1")
    out = tmld.generate_joints(ids, lengths_to_mask(LENGTHS, tmld.max_frames, "cpu"),
                               init_latents=torch.from_numpy(init.copy())).numpy()
    assert trace.total("launch.k1") == before  # CPU tensors: plain version
    assert out.shape == ref.shape == (3, 40, 22, 3)
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= 1e-3 * max(scale, 1.0), (err, scale)


def test_kernel_configuration_matches_jax(pair, monkeypatch):
    for name in ("MLD_TPU_FUSED_DENOISER", "MLD_TPU_FUSED_DECODE",
                 "MLD_TPU_CLIP_FLASH"):
        monkeypatch.setenv(name, "1")
    _, params, _ = pair
    rng = np.random.RandomState(0)
    mean = (0.1 * rng.randn(263)).astype(np.float32)
    std = (0.5 + rng.rand(263)).astype(np.float32)
    # a fresh JAX instance: generate_joints is jitted with self static and
    # reads the switches when it traces, so a traced instance keeps its path
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=SMALL),
                  mean=mean, std=std)
    assert jmld._use_fused_decode() and jmld._use_fused_denoiser()
    tmld = MLD(load_config(preset="mld_humanml3d", overrides=SMALL),
               mean=mean, std=std, fused_decode=True,
               device="cpu")
    tmld.load_flax_params(jax.tree_util.tree_map(np.asarray, params))
    ids = tmld.tokenize(TEXTS)
    mask = jax_lengths_to_mask(jnp.asarray(LENGTHS), jmld.max_frames)
    rng_key = jax.random.PRNGKey(4)
    ref = np.asarray(jmld.generate_joints(params, jnp.asarray(ids.numpy()),
                                          mask, rng_key))
    _, init_rng = jax.random.split(rng_key)
    init = np.asarray(jmld._init_latents(init_rng, len(TEXTS), mask))

    counts = (trace.total("launch.k1"), trace.total("launch.k5"),
              trace.total("launch.k4"))
    out = tmld.generate_joints(ids, lengths_to_mask(LENGTHS, tmld.max_frames, "cpu"),
                               init_latents=torch.from_numpy(init.copy())).numpy()
    # CPU tensors: every wrapper took its plain version
    assert (trace.total("launch.k1"), trace.total("launch.k5"),
            trace.total("launch.k4")) == counts
    assert out.shape == ref.shape == (3, 40, 22, 3)
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= 1e-3 * max(scale, 1.0), (err, scale)


def test_generate_returns_motions_per_prompt(pair):
    _, _, tmld = pair
    before = trace.total("launch.k1")
    motions = tmld.generate(TEXTS, LENGTHS,
                            generator=torch.Generator().manual_seed(1))
    assert [m.shape for m in motions] == [(n, 22, 3) for n in LENGTHS]
    assert all(np.isfinite(m).all() for m in motions)
    assert trace.total("launch.k1") == before
    again = tmld.generate(TEXTS, LENGTHS,
                          generator=torch.Generator().manual_seed(1))
    for a, b in zip(motions, again):
        np.testing.assert_array_equal(a, b)


def test_guidance_off_and_config_checks():
    cfg = load_config(preset="mld_humanml3d", overrides={
        **SMALL, "model": {**SMALL["model"], "guidance_scale": 1.0,
                           "scheduler": {"num_inference_timesteps": 5}}})
    mld = MLD(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert not mld.do_cfg
    joints = mld.generate_joints(mld.tokenize(["walk"]),
                                 lengths_to_mask([12], mld.max_frames, "cpu"),
                                 generator=torch.Generator().manual_seed(0))
    assert joints.shape == (1, 40, 22, 3) and not joints[0, 12:].any()
    # the action family builds (its generation: tests/test_torch_a2m.py)
    a2m = MLD(load_config(preset="mld_humanact12"), device="cpu")
    assert a2m.condition == "action" and a2m.clip is None
    # an action with the MLD VAE builds as the JAX package builds it
    a2m = MLD(load_config(preset="mld_humanact12",
                          overrides={"model": {"vae_type": "mld"}}),
              device="cpu")
    assert type(a2m.vae).__name__ == "MldVae"
    # the trans_dec denoiser also serves the VAE's latents (K1 does not);
    # its generation is held to JAX in tests/test_torch_text_options.py
    dec = MLD(load_config(preset="mld_humanml3d", overrides={
        **SMALL, "model": {**SMALL["model"], "denoiser_arch": "trans_dec"}}),
        device="cpu")
    assert dec.denoiser.arch == "trans_dec" and not dec.denoiser.fusable
    # only what the JAX package cannot build either is refused
    with pytest.raises(NotImplementedError,
                       match="condition=action without a VAE"):
        MLD(load_config(preset="novae_humanml3d",
                        overrides={"model": {"condition": "action"}}),
            device="cpu")
