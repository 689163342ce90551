"""Training in the port vs the JAX package: one step of each stage.

The tiny config of tests/test_data_training.py (D=32, ff 64, 3 layers, CLIP
2 layers, 64 frames, B=4) on a 24-clip synthetic corpus, with dropout 0 and
the text tower in f32 on both sides, and JAX's random draws replayed
through ``draws=`` (the VAE eps, the CFG drop, the noise, the timesteps and
the generation pass's initial latents). Tolerances:
- every log value within 1e-5 x max(|v|, 1);
- every gradient leaf within 1e-4 x max(max |g_jax|, 1e-6): f32 through two
  packages' summation orders over the 3-layer stacks;
- AdamW on the same gradients (JAX's, bridged by flax_to_state_dict) equal
  to ``make_optimizer``'s update within 1e-7. Adam's first step is nearly
  sign(g), so gradients 1e-7 apart around zero would give updates 2 x lr
  apart: the optimizer is compared on one set of gradients.
"""
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
from mld_tpu_torch.data.synthetic import build_synthetic_dataset
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.ops import dropout as tdropout
from mld_tpu_torch.ops.fused_layer import stack_skip_encoder
from mld_tpu_torch.train import steps
from mld_tpu_torch.utils.convert import flax_to_state_dict

LOG_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_ATOL = 1e-7


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


def tiny_over(synth_root, stage, preset="mld_humanml3d", dropout=0.0):
    model = {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
             "denoiser_num_layers": 3, "num_heads": 4,
             "text_encoded_dim": 32, "clip_layers": 2, "clip_heads": 2,
             "clip_compute_dtype": "float32", "dropout": dropout,
             "scheduler": {"num_inference_timesteps": 3}}
    if preset == "novae_humanml3d":
        model["denoiser_num_layers"] = 2
    return {"debug": True, "model": model,
            "dataset": {"root": synth_root, "max_motion_len": 64,
                        "min_motion_len": 16, "native_loader": False},
            "train": {"stage": stage, "batch_size": 4}}


def jax_params_of(tmld):
    """The port model's weights as the JAX package's param tree (the
    inverse bridges of tests/test_torch_weights.py): the port initialises,
    JAX loads, so no flax init has to run."""
    # copies: JAX on the CPU may alias a numpy buffer, which the port's
    # in-place optimizer step would then change under it
    sd = {k: v.detach().numpy().copy() for k, v in tmld.state_dict().items()}
    params = {"clip": convert_hf_clip_text(
        {k[5:]: v for k, v in sd.items() if k.startswith("clip.")})}
    for top in ("vae", "denoiser"):
        sub = {k[len(top) + 1:]: v for k, v in sd.items()
               if k.startswith(top + ".")}
        if sub:
            tree = torch_state_dict_to_flax(sub)
            if "emb_proj_1" in tree:
                tree["emb_proj"] = tree.pop("emb_proj_1")
            params[top] = jax.tree_util.tree_map(jnp.asarray, tree)
    return params


def make_pair(synth_root, stage, preset="mld_humanml3d"):
    over = tiny_over(synth_root, stage, preset)
    jcfg = jax_load_config(preset=preset, overrides=over)
    # the corpus's statistics, as training uses them: feats2joints of a
    # random model's features then stays well conditioned
    mean = np.load(f"{synth_root}/Mean.npy")
    std = np.load(f"{synth_root}/Std.npy")
    jmld = JaxMLD(jcfg, mean=mean, std=std)
    tmld = MLD(load_config(preset=preset, overrides=over), mean=mean,
               std=std, device="cpu",
               generator=torch.Generator().manual_seed(0))
    params = jax_params_of(tmld)
    dm = jax_get_datamodule(jcfg, tokenizer=jmld.tokenizer)
    batch = next(iter(dm.loader("train", batch_size=4, prefetch=0)))
    jbatch = {k: jnp.asarray(batch[k]) for k in ("motion", "mask",
                                                  "text_ids")}
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
        rng_z, rng_drop, rng_noise, rng_t, _ = jax.random.split(r, 5)
        z_shape = lat if jmld.is_vae else batch["motion"].shape
        d = {"cfg_drop": _t(jax.random.bernoulli(
                rng_drop, jmld.cfg.model.guidance_uncondp, (B, 1, 1)))[:, 0, 0],
             "noise": _t(jax.random.normal(rng_noise, z_shape)),
             "t": _t(jax.random.randint(
                 rng_t, (B,), 0, jmld.schedule.num_train_timesteps))}
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
         ("mld_humanml3d", "vae_diffusion"), ("novae_humanml3d", "diffusion")]


@pytest.mark.parametrize("preset,stage", CASES)
def test_step_matches_jax(synth_root, preset, stage):
    jmld, params, tmld, jbatch, tbatch = make_pair(synth_root, stage, preset)
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
