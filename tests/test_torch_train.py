"""Training in the port vs the JAX package: one step of each stage.

The tiny config of tests/test_data_training.py (D=32, ff 64, 3 layers, CLIP
2 layers, 64 frames, B=4) on a 24-clip synthetic corpus, and for the action
presets the same widths at 16 frames on a synthetic pose archive, with
dropout 0 and the text tower in f32 on both sides, and JAX's random draws
replayed through ``draws=`` (the VAE eps, the CFG drop or EmbedAction's
keep, the noise, the timesteps and the generation pass's initial latents).
Tolerances:
- every log value within 1e-5 x max(|v|, 1);
- every gradient leaf within 1e-4 x max(max |g_jax|, 1e-6): f32 through two
  packages' summation orders over the 3-layer stacks;
- AdamW on the same gradients (JAX's, bridged by flax_to_state_dict) equal
  to ``make_optimizer``'s update within 1e-7, but for the ACTOR VAE's
  normal(1) mu and logvar tokens, held within the larger of 1e-7 and one
  f32 ulp of the parameter (past 2 in magnitude the rounding of p + u
  alone exceeds 1e-7). Adam's first step is nearly
  sign(g), so gradients 1e-7 apart around zero would give updates 2 x lr
  apart: the optimizer is compared on one set of gradients.

bf16 mixed precision (``model.dtype: bfloat16``) is held to JAX's
``_compute_cast`` step at bf16 bars: each log within 2e-2 x max(|v|, 1)
and each gradient leaf within 5e-2 relative L2 error, 1.2e-1 in the MLD
VAE's vae stage. Both packages round the same f32 weights and inputs to
bf16 (a relative step of 2^-8), but round their activations at different
points (JAX's attention casts the probabilities to bf16 before P.V, the
port's plain attention keeps them in f32; XLA and torch sum bf16
cotangents and round GELU and LayerNorm outputs apart), and the layers and
their backward carry each such difference on. Measured on these inputs,
worst logs 1.6e-3, worst leaves 1.5e-2 (diffusion), 1.1e-2 (the ACTOR
VAE, which like JAX's computes in f32 after its f32 sine PE) and 8.7e-2
(the MLD VAE, whose joints loss runs through recover_from_ric's rotation
chain: there JAX's own bf16 step is 7.8e-2 from its f32 step on its worst
leaf, the port's 5.2e-2 from its own, so two bf16 steps cannot agree much
closer). Those bars would pass an f32 step too, so a forward hook on every
Linear of the trained module holds that it ran on its weight's bf16 copy
and on bf16 activations. A validation step in bf16 (``eval_step``) takes
K1, and K5 with the fused decode on, on the bf16 copies, as JAX's fused
paths read the cast params: its logs are held to JAX's at the log bar.
``train.remat`` with dropout 0.1 is held to the same step without it:
logs and gradients equal, and the generator in the same state after it.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data.datamodule import get_datamodule as jax_get_datamodule
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.clip_text import convert_hf_clip_text
from mld_tpu.train import steps as jsteps
from mld_tpu.utils.torch_convert import torch_state_dict_to_flax

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data.a2m import synth_humanact12_pkl
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.data.synthetic import build_synthetic_dataset
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.ops import dropout as tdropout
from mld_tpu_torch.ops.fused_layer import stack_skip_encoder
from mld_tpu_torch.train import steps
from mld_tpu_torch.utils.convert import flax_to_state_dict

LOG_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_ATOL = 1e-7
BF16_LOG_RTOL = 2e-2
BF16_GRAD_RTOL = 5e-2
BF16_VAE_GRAD_RTOL = 1.2e-1
REMAT_RTOL = 1e-6
A2M_PRESETS = ("mld_humanact12", "mld_uestc")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: intra-op threads only add overhead, much more of it when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_humanml3d_torch_train")
    build_synthetic_dataset(str(root), n_samples=24, seed=0)
    return str(root)


@pytest.fixture(scope="module")
def a2m_roots(tmp_path_factory):
    """A synthetic pose archive for each action preset, each in a root of
    its own (the UESTC dataset copies its pkl within its root)."""
    roots = {}
    for preset in A2M_PRESETS:
        root = tmp_path_factory.mktemp(f"synth_{preset}_torch_train")
        pkl = root / "humanact12poses.pkl"
        if preset == "mld_uestc":
            synth_humanact12_pkl(str(pkl), n_per_class=1, num_classes=40)
            os.rename(pkl, root / "uestc_poses.pkl")
        else:
            synth_humanact12_pkl(str(pkl), n_per_class=2)
        roots[preset] = str(root)
    return roots


def root_of(preset, synth_root, a2m_roots):
    return a2m_roots[preset] if preset in A2M_PRESETS else synth_root


def tiny_over(synth_root, stage, preset="mld_humanml3d", dropout=0.0,
              dtype="float32", remat=False):
    model = {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
             "denoiser_num_layers": 3, "num_heads": 4,
             "text_encoded_dim": 32, "clip_layers": 2, "clip_heads": 2,
             "clip_compute_dtype": "float32", "dropout": dropout,
             "dtype": dtype, "scheduler": {"num_inference_timesteps": 3}}
    if preset == "novae_humanml3d":
        model["denoiser_num_layers"] = 2
    dataset = ({"root": synth_root, "num_frames": 16}
               if preset in A2M_PRESETS else
               {"root": synth_root, "max_motion_len": 64,
                "min_motion_len": 16, "native_loader": False})
    return {"debug": True, "model": model, "dataset": dataset,
            "train": {"stage": stage, "batch_size": 4, "remat": remat}}


def jax_params_of(tmld):
    """The port model's weights as the JAX package's param tree (the
    inverse bridges of tests/test_torch_weights.py): the port initialises,
    JAX loads, so no flax init has to run."""
    # copies: JAX on the CPU may alias a numpy buffer, which the port's
    # in-place optimizer step would then change under it
    sd = {k: v.detach().numpy().copy() for k, v in tmld.state_dict().items()}
    params = {}
    if tmld.clip is not None:
        params["clip"] = convert_hf_clip_text(
            {k[5:]: v for k, v in sd.items() if k.startswith("clip.")})
    for top in ("vae", "denoiser"):
        sub = {k[len(top) + 1:]: v for k, v in sd.items()
               if k.startswith(top + ".")}
        if sub:
            tree = torch_state_dict_to_flax(sub)
            if "emb_proj_1" in tree:
                tree["emb_proj"] = tree.pop("emb_proj_1")
            elif top == "denoiser" and tmld.condition == "action":
                tree["emb_proj_action"] = tree.pop("emb_proj")
            params[top] = jax.tree_util.tree_map(jnp.asarray, tree)
    return params


def make_pair(synth_root, stage, preset="mld_humanml3d", **over_kw):
    over = tiny_over(synth_root, stage, preset, **over_kw)
    jcfg = jax_load_config(preset=preset, overrides=over)
    tcfg = load_config(preset=preset, overrides=over)
    if preset in A2M_PRESETS:
        # rot6d features: no statistics; the port's loader (its batches
        # are the JAX package's, tests/test_torch_a2m.py)
        mean = std = None
        batch = next(iter(get_datamodule(tcfg).loader(
            "train", batch_size=4, prefetch=0)))
        keys = ("motion", "mask", "action")
    else:
        # the corpus's statistics, as training uses them: feats2joints of
        # a random model's features then stays well conditioned
        mean = np.load(f"{synth_root}/Mean.npy")
        std = np.load(f"{synth_root}/Std.npy")
        batch = None
        keys = ("motion", "mask", "text_ids")
    jmld = JaxMLD(jcfg, mean=mean, std=std)
    tmld = MLD(tcfg, mean=mean, std=std, device="cpu",
               generator=torch.Generator().manual_seed(0))
    params = jax_params_of(tmld)
    if batch is None:
        dm = jax_get_datamodule(jcfg, tokenizer=jmld.tokenizer)
        batch = next(iter(dm.loader("train", batch_size=4, prefetch=0)))
    jbatch = {k: jnp.asarray(batch[k]) for k in keys}
    jbatch["row_valid"] = jnp.ones(4, bool)
    return jmld, params, tmld, jbatch, steps.batch_to_device(batch, "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_draws(jmld, stage, rng, batch):
    """The draws JAX's loss functions make from `rng` (steps.py:118-245)."""
    B = batch["motion"].shape[0]
    lat = (B, jmld.latent_size, jmld.latent_dim)

    def vae(r):
        rng_z, _ = jax.random.split(r)
        return {"eps": _t(jax.random.normal(rng_z, lat))}

    def diffusion(r):
        rng_z, rng_drop, rng_noise, rng_t, rng_cond = jax.random.split(r, 5)
        z_shape = lat if jmld.is_vae else batch["motion"].shape
        p = jmld.cfg.model.guidance_uncondp
        d = {"noise": _t(jax.random.normal(rng_noise, z_shape)),
             "t": _t(jax.random.randint(
                 rng_t, (B,), 0, jmld.schedule.num_train_timesteps))}
        if jmld.condition == "action":
            # EmbedAction's draw (denoiser.py:57-60)
            d["keep"] = _t(jax.random.bernoulli(
                rng_cond, 1.0 - p, (B, 1)))[:, 0]
        else:
            d["cfg_drop"] = _t(jax.random.bernoulli(
                rng_drop, p, (B, 1, 1)))[:, 0, 0]
        if jmld.is_vae:
            d["eps"] = _t(jax.random.normal(rng_z, lat))
        return d

    if stage == "vae":
        return vae(rng)
    if stage == "diffusion":
        return diffusion(rng)
    rng_v, rng_d, rng_g = jax.random.split(rng, 3)
    _, init_rng = jax.random.split(rng_g)
    return {"vae": vae(rng_v), "diffusion": diffusion(rng_d),
            "gen_init": _t(jmld._init_latents(init_rng, B, batch["mask"]))}


def jax_grads(jmld, params, stage, jbatch, rng):
    state = jsteps.create_train_state(jmld, params, stage)
    loss_fn = jsteps._STAGE_LOSSES[stage]
    (_, logs), grads = jax.jit(jax.value_and_grad(
        lambda p, frozen, batch, r: loss_fn(jmld, p, frozen, batch, r),
        has_aux=True))(state.params, state.frozen, jbatch, rng)
    logs = dict(logs)
    logs["grad_norm"] = optax.global_norm(grads)
    return state, logs, grads


def torch_named(tree):
    """A JAX trainable tree {top: flax params} -> {torch name: tensor}."""
    return {f"{top}.{k}": v for top, sub in tree.items()
            for k, v in flax_to_state_dict(
                jax.tree_util.tree_map(np.asarray, sub)).items()}


CASES = [("mld_humanml3d", "vae"), ("mld_humanml3d", "diffusion"),
         ("mld_humanml3d", "vae_diffusion"), ("novae_humanml3d", "diffusion"),
         ("mld_humanact12", "vae"), ("mld_humanact12", "diffusion"),
         ("mld_humanact12", "vae_diffusion"), ("mld_uestc", "diffusion")]


@pytest.mark.parametrize("preset,stage", CASES)
def test_step_matches_jax(synth_root, a2m_roots, preset, stage):
    jmld, params, tmld, jbatch, tbatch = make_pair(
        root_of(preset, synth_root, a2m_roots), stage, preset)
    rng = jax.random.PRNGKey(7)
    jstate, jlogs, jgrads = jax_grads(jmld, params, stage, jbatch, rng)

    state = steps.create_train_state(tmld, stage)
    frozen = {k: v.detach().clone() for k, v in state.frozen().items()}
    draws = jax_draws(jmld, stage, rng, jbatch)
    logs, grads = steps.compute_grads(state, tbatch, None, draws)

    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        v = float(v)
        assert abs(float(logs[k]) - v) <= LOG_RTOL * max(abs(v), 1.0), (
            k, float(logs[k]), v)

    want = torch_named(jgrads)
    assert set(grads) == set(want)
    for k, g in want.items():
        scale = max(float(g.abs().max()), 1e-6)
        err = float((grads[k] - g).abs().max())
        assert err <= GRAD_RTOL * scale, (k, err, scale)

    # AdamW (skipping non-finite steps) on JAX's gradients
    before = {k: p.detach().clone() for k, p in state.params.items()}
    for k, p in state.params.items():
        p.grad = want[k].clone()
    assert steps.apply_grads(state)
    updates, _ = jstate.tx.update(jgrads, jstate.opt_state, jstate.params)
    new = torch_named(optax.apply_updates(jstate.params, updates))
    for k, p in state.params.items():
        upd = (p.detach().double() - before[k].double()).numpy()
        ref = (new[k].double() - before[k].double()).numpy()
        if k.rsplit(".", 1)[-1] in ("mu_token", "logvar_token"):
            # the ACTOR VAE's mu and logvar tokens are normal(1), as JAX
            # initialises them: where one lies past 2 in magnitude, one f32
            # ulp of the rounded p + u alone exceeds 1e-7, so the bar for
            # these two leaves is the larger of that ulp and 1e-7
            mag = np.maximum(before[k].abs().numpy(), np.abs(new[k].numpy()))
            atol = np.maximum(np.spacing(mag.astype(np.float32)), ADAM_ATOL)
            err = np.abs(upd - ref)
            assert (err <= atol).all(), (k, float((err - atol).max()))
        else:
            np.testing.assert_allclose(upd, ref, rtol=0, atol=ADAM_ATOL,
                                       err_msg=k)
        assert not np.array_equal(upd, np.zeros_like(upd)), k

    # the frozen subtree is untouched
    for k, v in state.frozen().items():
        assert torch.equal(v, frozen[k]), k
        assert not v.requires_grad


def test_restack_after_step(synth_root):
    """After an optimizer step K1's stack is rebuilt from the updated
    encoder, not left at the old weights."""
    _, _, tmld, _, tbatch = make_pair(synth_root, "diffusion")
    old = tmld.denoiser.stacked_encoder()
    state = steps.create_train_state(tmld, "diffusion")
    steps.train_step(state, tbatch, torch.Generator().manual_seed(0))
    new = tmld.denoiser.stacked_encoder()
    want = stack_skip_encoder(tmld.denoiser.encoder)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(new, name).numpy(),
                                      getattr(want, name).numpy(), name)
    assert not torch.equal(new.w1, old.w1)


def _optax_and_port(grads_seq, lr=1e-3):
    """Run optax's make_optimizer and the port's on the same gradient
    sequence over two small tensors; return both params after each step
    and the port's optimizer. The params lie in (-1, 1], as the model's do,
    where one f32 ulp is at most 1.2e-7; before each step the port's params
    are set to JAX's, so that each step's update is compared alone, not
    the rounding the steps before it left."""
    rng = np.random.RandomState(3)
    init = {"a": np.tanh(rng.randn(5, 3)).astype(np.float32),
            "b": np.ones(7, np.float32)}
    tx = jsteps.make_optimizer(lr)
    update = jax.jit(tx.update)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = steps.make_optimizer(list(tp.values()), lr)
    out = []
    for g in grads_seq:
        start = jp
        upd, opt_state = update({k: jnp.asarray(v) for k, v in g.items()},
                                opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        with torch.no_grad():
            for k, p in tp.items():
                p.copy_(torch.from_numpy(np.array(start[k])))
                p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        out.append(({k: np.asarray(v) for k, v in jp.items()},
                    {k: p.detach().numpy().copy() for k, p in tp.items()}))
    return out, opt


def test_adamw_skips_nonfinite_like_optax():
    rng = np.random.RandomState(4)
    good = [{"a": rng.randn(5, 3).astype(np.float32),
             "b": rng.randn(7).astype(np.float32)} for _ in range(3)]
    bad = {"a": good[0]["a"].copy(), "b": good[0]["b"].copy()}
    bad["a"][1, 2] = np.nan
    bad["b"][0] = np.inf
    seq = [good[0], bad, good[1], bad, good[2]]
    out, opt = _optax_and_port(seq)
    for i, (j, t) in enumerate(out):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=ADAM_ATOL,
                                       err_msg=f"step {i} {k}")
    # the skipped steps left params (started from JAX's after step 0) and
    # moments as they were
    np.testing.assert_array_equal(out[1][1]["a"], out[0][0]["a"])
    state = opt.optimizer.state[opt.param_groups[0]["params"][0]]
    assert int(state["step"]) == 3
    assert opt.total_notfinite == 2 and opt.notfinite_count == 0


def test_adamw_applies_after_100_nonfinite_in_a_row():
    g = {"a": np.full((5, 3), np.nan, np.float32),
         "b": np.ones(7, np.float32)}
    out, opt = _optax_and_port([g] * 101)
    for i in (0, 99):      # 100 in a row: all skipped, params unchanged
        assert np.isfinite(out[i][0]["a"]).all()
        assert np.isfinite(out[i][1]["a"]).all()
    # the 101st is applied anyway, by both
    assert np.isnan(out[100][0]["a"]).all() and np.isnan(out[100][1]["a"]).all()
    np.testing.assert_allclose(out[100][1]["b"], out[100][0]["b"], rtol=0,
                               atol=ADAM_ATOL)
    assert opt.notfinite_count == 101


def test_adamw_applies_when_only_the_norm_overflows():
    """Finite gradients whose global norm overflows f32 are finite to optax
    (it checks the leaves): the step is applied, not skipped. Each square
    stays finite (1.44e38), so both optimizers' second moments do; only
    the sum of 15 overflows."""
    g = {"a": np.full((5, 3), 1.2e19, np.float32),
         "b": np.ones(7, np.float32)}
    assert not torch.isfinite(steps.global_norm(
        [torch.from_numpy(v) for v in g.values()]))
    out, opt = _optax_and_port([g])
    for k in out[0][0]:
        np.testing.assert_allclose(out[0][1][k], out[0][0][k], rtol=0,
                                   atol=ADAM_ATOL, err_msg=k)
    assert opt.total_notfinite == 0
    assert int(opt.optimizer.state[opt.param_groups[0]["params"][0]]
               ["step"]) == 1


def test_dropout_masks_reproducible_and_at_rate(synth_root):
    x = torch.ones(200_000)
    a = tdropout.dropout(x, 0.1, torch.Generator().manual_seed(5))
    b = tdropout.dropout(x, 0.1, torch.Generator().manual_seed(5))
    c = tdropout.dropout(x, 0.1, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    share = float((a == 0).float().mean())
    assert abs(share - 0.1) < 0.005, share
    np.testing.assert_allclose(a[a != 0].numpy(), 1 / 0.9, rtol=1e-6)
    assert torch.equal(tdropout.dropout(x, 0.1, None), x)

    # a whole training step with dropout 0.1: replayed by the same seed,
    # changed by another, and different from the step without dropout
    over = tiny_over(synth_root, "vae", dropout=0.1)
    mld = MLD(load_config(preset="mld_humanml3d", overrides=over),
              device="cpu")
    _, _, _, _, tbatch = make_pair(synth_root, "vae")
    state = steps.create_train_state(mld, "vae")
    eps = {"eps": torch.zeros(4, 1, 32)}

    def loss(seed):
        return float(steps.compute_grads(
            state, tbatch, torch.Generator().manual_seed(seed), eps)[0]
            ["total"])

    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    ev = steps.eval_step(state, tbatch, None, eps)["total"]
    assert float(ev) == float(steps.eval_step(state, tbatch, None,
                                              eps)["total"])
    assert loss(1) != float(ev)


def test_action_validation_loss_is_jaxs(a2m_roots):
    """The validation diffusion loss of an action preset: JAX's eval step
    calls the denoiser with training=False, so EmbedAction zeroes the first
    half of the batch's condition under guidance_scale > 1
    (denoiser.py:61-64); the port's eval_step does the same."""
    jmld, params, tmld, jbatch, tbatch = make_pair(
        a2m_roots["mld_humanact12"], "diffusion", "mld_humanact12")
    rng = jax.random.PRNGKey(9)
    jstate = jsteps.create_train_state(jmld, params, "diffusion")
    jlogs = jsteps.make_eval_step(jmld, "diffusion")(jstate, jbatch, rng)
    draws = jax_draws(jmld, "diffusion", rng, jbatch)
    del draws["keep"]       # no drop outside training
    state = steps.create_train_state(tmld, "diffusion")
    seen = []
    hook = tmld.denoiser.emb_proj.register_forward_hook(
        lambda m, i, out: seen.append(out.detach().clone()))
    try:
        logs = steps.eval_step(state, tbatch, None, draws)
    finally:
        hook.remove()
    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        v = float(v)
        assert abs(float(logs[k]) - v) <= LOG_RTOL * max(abs(v), 1.0), (
            k, float(logs[k]), v)
    (cond,) = seen
    assert tmld.guidance_scale > 1.0
    assert not cond[:2].any() and cond[2:].abs().min() > 0


BF16_CASES = [("mld_humanml3d", "vae"), ("mld_humanml3d", "diffusion"),
              ("mld_humanact12", "vae"), ("mld_humanact12", "diffusion")]


@pytest.mark.parametrize("preset,stage", BF16_CASES)
def test_bf16_step_matches_jax_compute_cast(synth_root, a2m_roots, preset,
                                            stage):
    """One step with model.dtype bfloat16 against JAX's _compute_cast step
    (steps.py:104-121): logs and gradients at the bf16 bars of the module
    docstring; every Linear of the trained module ran on its bf16 copy and
    on bf16 activations (those bars alone would pass an f32 step);
    gradients, masters and AdamW's moments stay f32."""
    jmld, params, tmld, jbatch, tbatch = make_pair(
        root_of(preset, synth_root, a2m_roots), stage, preset,
        dtype="bfloat16")
    assert jmld.dtype == jnp.bfloat16 and tmld.dtype == torch.bfloat16
    rng = jax.random.PRNGKey(7)
    _, jlogs, jgrads = jax_grads(jmld, params, stage, jbatch, rng)

    state = steps.create_train_state(tmld, stage)
    # every Linear of the module the stage trains, seen by a forward hook
    top = tmld.vae if stage == "vae" else tmld.denoiser
    linears = {name: m for name, m in top.named_modules()
               if isinstance(m, torch.nn.Linear)}
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, i, out, name=name: seen.setdefault(name, []).append(
            (i[0].dtype, m.weight.dtype, out.dtype)))
        for name, m in linears.items()]
    try:
        logs, grads = steps.compute_grads(
            state, tbatch, None, jax_draws(jmld, stage, rng, jbatch))
    finally:
        for hook in hooks:
            hook.remove()
    # each ran on its weight's bf16 copy, on bf16 activations; in the ACTOR
    # VAE the f32 sine PE promotes the activations after skel_embedding to
    # f32, as in JAX's, so every later layer there computes in f32
    assert set(seen) == set(linears)
    bf16, f32 = torch.bfloat16, torch.float32
    for name, calls in seen.items():
        act = (f32 if preset in A2M_PRESETS and stage == "vae"
               and name != "encoder.skel_embedding" else bf16)
        assert set(calls) == {(act, bf16, act)}, (name, calls)

    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        v = float(v)
        assert abs(float(logs[k]) - v) <= BF16_LOG_RTOL * max(abs(v), 1.0), (
            k, float(logs[k]), v)
    want = torch_named(jgrads)
    assert set(grads) == set(want)
    bar = (BF16_VAE_GRAD_RTOL if (preset, stage) == ("mld_humanml3d", "vae")
           else BF16_GRAD_RTOL)
    for k, g in want.items():
        assert grads[k].dtype == torch.float32, k
        ref = g.double()
        err = float((grads[k].double() - ref).norm()
                    / max(float(ref.norm()), 1e-30))
        assert err <= bar, (k, err)

    assert steps.apply_grads(state, logs["grad_norm"])
    for k, p in tmld.named_parameters():
        assert p.dtype == torch.float32, k
    moments = state.optimizer.optimizer.state
    assert moments and all(
        v.dtype == torch.float32 for st in moments.values()
        for key, v in st.items() if key in ("exp_avg", "exp_avg_sq"))


BF16_EVAL_CASES = [("mld_humanml3d", "vae"), ("mld_humanml3d", "diffusion"),
                   ("mld_humanact12", "diffusion")]


@pytest.mark.parametrize("preset,stage", BF16_EVAL_CASES)
def test_bf16_validation_takes_the_kernels(synth_root, a2m_roots, monkeypatch,
                                           preset, stage):
    """A bf16 validation step with the fused denoiser and the fused decode
    on, against JAX's eval_step on the cast params (its fused paths, Pallas
    in interpret mode): the logs within the bf16 log bar, and the port's
    call went through K1's wrapper (diffusion) or K5's (vae) with f32
    activations and the bf16 copies' matrices."""
    from mld_tpu_torch.ops import fused_denoiser, fused_seq_decoder

    monkeypatch.setenv("MLD_TPU_FUSED_DENOISER", "1")
    monkeypatch.setenv("MLD_TPU_FUSED_DECODE", "1")
    jmld, params, tmld, jbatch, tbatch = make_pair(
        root_of(preset, synth_root, a2m_roots), stage, preset,
        dtype="bfloat16")
    assert tmld.use_fused_denoiser()
    assert tmld.fused_decode == (preset not in A2M_PRESETS)
    rng = jax.random.PRNGKey(5)
    jstate = jsteps.create_train_state(jmld, params, stage)
    jlogs = jsteps.make_eval_step(jmld, stage)(jstate, jbatch, rng)

    seen = []
    for mod, name, field in ((fused_denoiser, "skip_encoder_stack", "wqkv"),
                             (fused_seq_decoder, "skip_decoder_stack",
                              "wqkv_s")):
        inner = getattr(mod, name)

        def spy(x, *a, inner=inner, name=name, field=field):
            stacked = next(v for v in a if hasattr(v, field))
            seen.append((name, x.dtype, getattr(stacked, field).dtype))
            return inner(x, *a)

        monkeypatch.setattr(mod, name, spy)
    state = steps.create_train_state(tmld, stage)
    logs = steps.eval_step(state, tbatch, None,
                           jax_draws(jmld, stage, rng, jbatch))
    kernel = "skip_decoder_stack" if stage == "vae" else "skip_encoder_stack"
    assert seen == [(kernel, torch.float32, torch.bfloat16)]
    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        v = float(v)
        assert abs(float(logs[k]) - v) <= BF16_LOG_RTOL * max(abs(v), 1.0), (
            k, float(logs[k]), v)


REMAT_CASES = [("mld_humanml3d", "vae"), ("mld_humanml3d", "diffusion"),
               ("mld_humanml3d", "vae_diffusion"), ("mld_humanact12", "vae")]


@pytest.mark.parametrize("preset,stage", REMAT_CASES)
def test_remat_equals_no_remat(synth_root, a2m_roots, preset, stage):
    """train.remat recomputes its segments in the backward (the stack
    under grad runs twice) and replays their dropout masks: with dropout
    0.1 and one seeded generator the logs and every gradient leaf equal the
    step without it, and the generator ends in the same state."""
    root = root_of(preset, synth_root, a2m_roots)
    out = {}
    for remat in (False, True):
        over = tiny_over(root, stage, preset, dropout=0.1, remat=remat)
        tcfg = load_config(preset=preset, overrides=over)
        mean = std = None
        if preset not in A2M_PRESETS:
            mean = np.load(f"{root}/Mean.npy")
            std = np.load(f"{root}/Std.npy")
        tmld = MLD(tcfg, mean=mean, std=std, device="cpu",
                   generator=torch.Generator().manual_seed(0))
        if preset in A2M_PRESETS:
            batch = next(iter(get_datamodule(tcfg).loader(
                "train", batch_size=4, prefetch=0)))
        else:
            batch = next(iter(get_datamodule(tcfg, tmld.tokenizer).loader(
                "train", batch_size=4, prefetch=0)))
        state = steps.create_train_state(tmld, stage)
        segment = (tmld.vae.encoder if stage == "vae"
                   else tmld.denoiser.encoder)
        calls = []
        hook = segment.register_forward_pre_hook(
            lambda *a: calls.append(None) if torch.is_grad_enabled()
            else None)
        g = torch.Generator().manual_seed(11)
        try:
            logs, grads = steps.compute_grads(
                state, steps.batch_to_device(batch, "cpu"), g)
        finally:
            hook.remove()
        out[remat] = (logs, {k: v.clone() for k, v in grads.items()},
                      g.get_state(), len(calls))
    (logs, grads, g_state, n), (r_logs, r_grads, r_state, r_n) = (
        out[False], out[True])
    assert r_n == 2 * n
    assert torch.equal(r_state, g_state)
    for k, v in logs.items():
        assert abs(float(r_logs[k]) - float(v)) <= REMAT_RTOL * max(
            abs(float(v)), 1.0), (k, float(r_logs[k]), float(v))
    assert set(r_grads) == set(grads)
    for k, g in grads.items():
        scale = max(float(g.abs().max()), 1e-12)
        assert float((r_grads[k] - g).abs().max()) <= REMAT_RTOL * scale, k
