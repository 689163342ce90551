"""The raw-motion family (``novae_humanml3d``, ``novae_stress_s512``: no VAE,
the ``trans_dec`` denoiser, DDPM-1000) in the port vs the JAX package.

The DDPM update is held to JAX's at 1e-6; the weight bridge must carry a
VAE-less param tree flax -> torch -> flax unchanged; sampling on a small
``novae_humanml3d`` (D=64, ff 128, 3 layers, T=40, CLIP 2 layers f32) with
DDPM-1000 and CFG is held to JAX's at tests/test_full_sampler_parity.py's
bar, 1e-3 x max(scale, 1), from the initial latents and per-step noise JAX
draws (``mld.py:463-487``). JAX runs its XLA attention there (its CPU
dispatch); K3 itself is held to ``sdpa_pallas`` in
tests/test_torch_flash_attention.py.

With random weights and the preset's epsilon prediction the sampled
features reach ~130 (x0 = (x - sqrt(1 - a) eps) / sqrt(a) at a = 4.7e-5),
where recover_from_ric's accumulated root rotation is ill-conditioned:
features 3e-6 apart relative to their scale give joints 0.48 apart at scale
367, above the bar (on the CPU). So the preset's own arm holds the features
(what JAX's generate_feats returns), and the joints of generate_joints are
held in the two arms whose samples stay O(1): x0 prediction
(``train.predict_epsilon=False``) and ``clip_sample``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.diffusion.schedulers import DDPMScheduler as JaxDDPM
from mld_tpu.diffusion.schedulers import DiffusionSchedule as JaxSchedule
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.mld import lengths_to_mask as jax_lengths_to_mask
from mld_tpu.utils.torch_convert import torch_state_dict_to_flax

from mld_tpu_torch.config import load_config
from mld_tpu_torch.diffusion.schedulers import DDPMScheduler, DiffusionSchedule
from mld_tpu_torch.models.denoiser import RawMotionDenoiser
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.convert import flax_to_state_dict

SMALL = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                   "denoiser_num_layers": 3, "num_heads": 4,
                   "text_encoded_dim": 48, "clip_layers": 2,
                   "clip_heads": 2, "clip_compute_dtype": "float32"},
         "dataset": {"max_motion_len": 40}}
TEXTS = ["a man kicks something with his left leg.", "someone jumps"]
LENGTHS = [40, 23]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The sampling loops here are ~1000 steps of tiny ops, for which
    intra-op threads only add overhead, and much more of it when several
    test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launches():
    return (trace.total("launch.k3"), trace.total("launch.k4"),
            trace.total("launch.k1"), trace.total("launch.k5"))


# -------------------------------------------------------------------- DDPM
@pytest.mark.parametrize("variance_type", ["fixed_small", "fixed_large"])
@pytest.mark.parametrize("prediction", ["epsilon", "sample"])
def test_ddpm_step_matches_jax(variance_type, prediction):
    jsch = JaxDDPM(JaxSchedule.create(prediction_type=prediction),
                   variance_type)
    tsch = DDPMScheduler(DiffusionSchedule.create(prediction_type=prediction),
                         variance_type)
    np.testing.assert_array_equal(tsch.timesteps(), jsch.timesteps())
    assert tsch.timesteps()[0] == 999 and tsch.timesteps()[-1] == 0
    rng = np.random.RandomState(0)
    x, out, noise = (rng.randn(3, 40, 263).astype(np.float32)
                     for _ in range(3))
    for t in (999, 500, 1, 0):
        for nz in (None, noise):
            ref = jsch.step(jnp.asarray(out), jnp.asarray(t), jnp.asarray(x),
                            None if nz is None else jnp.asarray(nz))
            got = tsch.step(torch.from_numpy(out), t, torch.from_numpy(x),
                            None if nz is None else torch.from_numpy(nz))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-6, rtol=1e-6)
    # std is 0 at t = 0: the noise does not enter the last step
    mean = tsch.step(torch.from_numpy(out), 0, torch.from_numpy(x))
    np.testing.assert_array_equal(
        tsch.step(torch.from_numpy(out), 0, torch.from_numpy(x),
                  torch.from_numpy(noise)).numpy(), mean.numpy())


def test_ddpm_variance_floor_and_large():
    sch = DiffusionSchedule.create()
    small = DDPMScheduler(sch, "fixed_small")
    large = DDPMScheduler(sch, "fixed_large")
    zero = torch.zeros(1, 4)
    one = torch.ones(1, 4)
    # with a zero model output and sample, the step is std * noise
    t = 1
    ac, b = sch.alphas_cumprod, sch.betas
    want_small = np.sqrt(b[t] * (1 - ac[t - 1]) / (1 - ac[t]))
    np.testing.assert_allclose(small.step(zero, t, zero, one).numpy(),
                               want_small, rtol=1e-6)
    np.testing.assert_allclose(large.step(zero, t, zero, one).numpy(),
                               np.sqrt(b[t]), rtol=1e-6)


# ------------------------------------------------------------ weight bridge
ARMS = {
    "preset": SMALL,
    "x0 prediction": {**SMALL, "train": {"predict_epsilon": False}},
    "clip_sample": {**SMALL, "model": {**SMALL["model"],
                                       "scheduler": {"clip_sample": True}}},
}


def _make_pair(overrides, params=None):
    """JAX's and the port's MLD on the same params (JAX's init_params
    unless given: the arms differ in sampling only, not in parameters)."""
    rng = np.random.RandomState(0)
    mean = (0.1 * rng.randn(263)).astype(np.float32)
    std = (0.5 + rng.rand(263)).astype(np.float32)
    jmld = JaxMLD(jax_load_config(preset="novae_humanml3d",
                                  overrides=overrides), mean=mean, std=std)
    if params is None:
        params = jax.tree_util.tree_map(
            np.asarray, jmld.init_params(jax.random.PRNGKey(0)))
    tmld = MLD(load_config(preset="novae_humanml3d", overrides=overrides),
               mean=mean, std=std, device="cpu")
    tmld.load_flax_params(params)
    return jmld, params, tmld


@pytest.fixture(scope="module")
def pair():
    return _make_pair(SMALL)


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key], f"{path}/{key}")
        else:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]),
                                          err_msg=f"{path}/{key}")


def test_weight_round_trip_without_vae(pair):
    _, params, tmld = pair
    assert set(params) == {"denoiser", "clip"} and tmld.vae is None
    sd = flax_to_state_dict(params["denoiser"])
    for name in ("decoder.layers.2.multihead_attn.in_proj_weight",
                 "decoder.norm.weight", "pose_embd.weight", "mem_pos.pe",
                 "emb_proj.1.weight"):
        assert name in sd, name
    back = torch_state_dict_to_flax(sd)
    back["emb_proj"] = back.pop("emb_proj_1")
    _assert_trees_equal(back, params["denoiser"])
    # and through the model: load_flax_params loaded it strictly
    loaded = {k[len("denoiser."):]: v for k, v in tmld.state_dict().items()
              if k.startswith("denoiser.")}
    back = torch_state_dict_to_flax(loaded)
    back["emb_proj"] = back.pop("emb_proj_1")
    _assert_trees_equal(back, params["denoiser"])


# ------------------------------------------------------------- end to end
class _JaxStepNoise:
    """Step i's ancestral noise as JAX's diffusion_reverse draws it
    (mld.py:463-466, 485-487), made when the port asks for it."""

    def __init__(self, rng, n_steps, shape):
        rng, _ = jax.random.split(rng)
        self.keys = jax.random.split(rng, n_steps)
        self.normal = jax.jit(
            lambda key: jax.random.normal(key, shape, jnp.float32))

    def __getitem__(self, i):
        return np.array(self.normal(self.keys[i]))


def _replay(jmld, tmld, seed):
    """JAX's mask, key, initial latents and step noise for the prompts."""
    mask = jax_lengths_to_mask(jnp.asarray(LENGTHS), jmld.max_frames)
    rng = jax.random.PRNGKey(seed)
    _, init_rng = jax.random.split(rng)
    init = np.asarray(jmld._init_latents(init_rng, len(TEXTS), mask))
    shape = (len(TEXTS), 40, 263)
    assert init.shape == shape
    return mask, rng, dict(init_latents=torch.from_numpy(init.copy()),
                           step_noise=_JaxStepNoise(rng, 1000, shape))


def _assert_close(out, ref):
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= 1e-3 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("arm", ["x0 prediction", "clip_sample"])
def test_generate_joints_matches_jax(pair, arm):
    jmld, params, tmld = _make_pair(ARMS[arm], pair[1])
    ids = tmld.tokenize(TEXTS)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jmld.tokenize(TEXTS)))
    mask, rng, replay = _replay(jmld, tmld, 3)
    ref = np.asarray(jmld.generate_joints(params, jnp.asarray(ids.numpy()),
                                          mask, rng))
    before = _launches()
    out = tmld.generate_joints(
        ids, lengths_to_mask(LENGTHS, tmld.max_frames, "cpu"), **replay).numpy()
    assert _launches() == before        # CPU tensors: every plain version
    assert out.shape == ref.shape == (2, 40, 22, 3)
    assert not out[1, 23:].any()
    _assert_close(out, ref)


def test_sampled_features_match_jax(pair):
    # the preset's epsilon prediction: the features generate_joints turns
    # into joints, as JAX's generate_feats returns them
    jmld, params, tmld = pair
    ids = tmld.tokenize(TEXTS)
    mask, rng, replay = _replay(jmld, tmld, 3)
    ref = np.asarray(jmld.generate_feats(params, jnp.asarray(ids.numpy()),
                                         mask, rng))
    tmask = lengths_to_mask(LENGTHS, tmld.max_frames, "cpu")
    cond = tmld.encode_text_tokens(ids)
    uncond = tmld.encode_text_tokens(torch.as_tensor(tmld.uncond_ids))
    cond = torch.cat([uncond.expand_as(cond), cond])
    z = (tmld.diffusion_reverse(cond, mask=tmask, **replay)
         * tmask[..., None]).numpy()
    _assert_close(z, ref)
    # the features reach ~130, where the 1e-3 x scale bar is loose: they
    # also agree to 2e-5 of their scale (3.1e-6 measured on the CPU)
    scale = np.abs(ref).max()
    assert np.abs(z - ref).max() <= 2e-5 * scale, scale


def test_generate_returns_motions_per_prompt(pair):
    _, _, tmld = pair
    assert isinstance(tmld.denoiser, RawMotionDenoiser)
    assert isinstance(tmld.scheduler, DDPMScheduler)
    assert len(tmld.scheduler.timesteps()) == 1000
    # the same model over a 10-step schedule: shapes, determinism, no kernel
    tmld = MLD(load_config(preset="novae_humanml3d", overrides={
        **SMALL, "model": {**SMALL["model"],
                           "scheduler": {"num_train_timesteps": 10}}}),
        device="cpu")
    before = _launches()
    motions = tmld.generate(TEXTS, LENGTHS,
                            generator=torch.Generator().manual_seed(1))
    assert [m.shape for m in motions] == [(n, 22, 3) for n in LENGTHS]
    assert all(np.isfinite(m).all() for m in motions)
    assert _launches() == before
    again = tmld.generate(TEXTS, LENGTHS,
                          generator=torch.Generator().manual_seed(1))
    for a, b in zip(motions, again):
        np.testing.assert_array_equal(a, b)


def test_raw_motion_needs_a_mask_and_has_no_decode(monkeypatch):
    cfg = load_config(preset="novae_humanml3d", overrides={
        **SMALL, "model": {**SMALL["model"], "guidance_scale": 1.0,
                           "scheduler": {"num_train_timesteps": 4}}})
    mld = MLD(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert not mld.do_cfg and list(mld.scheduler.timesteps()) == [3, 2, 1, 0]
    cond = mld.encode_text_tokens(mld.tokenize(["walk"]))
    with pytest.raises(ValueError, match="needs the frame mask"):
        mld.diffusion_reverse(cond)
    z = mld.diffusion_reverse(cond, torch.Generator().manual_seed(0),
                              mask=lengths_to_mask([12], mld.max_frames, "cpu"))
    assert z.shape == (1, 40, 263)
    with pytest.raises(ValueError, match="fused_decode needs the MLD VAE"):
        MLD(cfg, fused_decode=True, device="cpu")
    monkeypatch.setenv("MLD_TPU_FUSED_DECODE", "1")
    assert not MLD(cfg, device="cpu").fused_decode     # as JAX: no VAE, no fused decode


def test_stress_preset_builds_at_512_frames():
    over = {**SMALL, "dataset": {}}
    mld = MLD(load_config(preset="novae_stress_s512", overrides=over),
              device="cpu")
    assert mld.max_frames == 512 and mld.denoiser.query_pos.pe.shape[0] == 520
    assert isinstance(mld.scheduler, DDPMScheduler)


@pytest.mark.parametrize("preset,over,match", [
    ("novae_humanml3d", {"denoiser_arch": "trans_enc"},
     "denoiser_arch=trans_enc with diffusion_only"),
    ("mld_humanml3d", {"denoiser_arch": "trans_dec"},
     "denoiser_arch=trans_dec in latent mode"),
    ("novae_humanml3d", {"scheduler": {"kind": "ddim"}},
     "scheduler=ddim without a VAE"),
    ("mld_humanml3d", {"scheduler": {"kind": "ddpm"}},
     "scheduler=ddpm with a VAE"),
])
def test_unsupported_combinations_are_rejected(preset, over, match):
    # these combinations, once refused, are built as the JAX package builds
    # them: the denoiser's arch and the sampler follow the config with or
    # without a VAE (their generation is held to JAX in
    # tests/test_torch_text_options.py)
    cfg = load_config(preset=preset,
                      overrides={**SMALL, "model": {**SMALL["model"], **over}})
    mld = MLD(cfg, device="cpu")
    m = cfg.model
    assert mld.denoiser.arch == m.denoiser_arch
    assert isinstance(mld.scheduler, DDPMScheduler) == (
        m.scheduler.kind == "ddpm")
    assert isinstance(mld.denoiser, RawMotionDenoiser) == (
        preset == "novae_humanml3d")
