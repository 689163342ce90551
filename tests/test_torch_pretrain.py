"""The port's CLIP text-tower pretraining (``train/pretrain.py``) against the
JAX package's (``mld_tpu/train/pretrain.py``), on the CPU.

A tiny tower (2 layers, width 64, 2 heads) starts from the port's seeded
init in both packages (JAX's through ``MLD.params_tree``) and is fed the same
loader batches (each package iterates its own data module once, in step).
The bars are the evaluator trainer's (``tests/test_torch_eval_train.py``):
- f32 compute: each step's loss over a 21-step run (optax's shortest:
  its cosine needs steps past the 20-step warmup) within 1e-5 relative;
  the first step's gradients within 1e-4 of each leaf's largest |g| (the
  k_proj biases' gradient is zero: a shift common to all keys leaves the
  softmax as it was, so there both packages' roundoff must stay under
  1e-6 of the tower's largest |g|); the
  port's clip + Adam + schedule applied to JAX's gradients gives JAX's
  updated leaves within 1e-6 of each leaf's scale (Adam's first step is
  nearly lr x sign(g): two gradients 1e-7 apart around zero would give
  updates 2 x lr apart, so the optimizer is compared on one set of
  gradients);
- bf16 compute (the presets' tower): each step's loss over the same
  21-step run within 5e-3 relative: bf16 rounds the activations at every
  layer (8 bits of mantissa, 3.9e-3 a rounding) after GEMMs whose f32 sums
  the two packages order apart, so a rounding can flip and move a step's
  loss by about one rounding. At this width the losses are that close to
  the f32 tower's too, so the case holds the bf16 run (its casts under
  autograd, its updates) to JAX's; the rounding itself is held per layer
  (K4 in bf16: tests/test_torch_flash_causal.py, chip_smoke.py phase 3);
- the three warmup-cosine schedules within 1e-9 of optax's;
- the tower's ``requires_grad`` restored, and the vae and diffusion stages
  after it keep the tower frozen and out of their optimizers.
"""
import numpy as np
import optax
import pytest
import jax
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data.datamodule import get_datamodule as jax_get_datamodule
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.train.pretrain import pretrain_clip_text as jax_pretrain

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.data.synthetic import build_synthetic_dataset
from mld_tpu_torch.eval.t2m_train import ClippedAdam, warmup_cosine
from mld_tpu_torch.models.clip_text import ClipTokenizer
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.train.pretrain import (batch_ids_style, make_probe,
                                          pretrain_clip_text, style_loss)
from mld_tpu_torch.train.steps import create_train_state
from mld_tpu_torch.utils.convert import flax_clip_to_state_dict

N_CLIPS = 64
B = 8
STEPS = 21
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 1e-6
BF16_LOSS_RTOL = 5e-3
TINY = {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
        "denoiser_num_layers": 3, "num_heads": 4, "text_encoded_dim": 64,
        "clip_layers": 2, "clip_heads": 2, "clip_compute_dtype": "float32",
        "scheduler": {"num_inference_timesteps": 2}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_pretrain"))
    build_synthetic_dataset(root, n_samples=N_CLIPS, seed=0)
    return root


def _over(root, **model):
    return {"debug": True, "model": {**TINY, **model},
            "dataset": {"root": root, "max_motion_len": 64,
                        "min_motion_len": 16, "native_loader": False},
            "train": {"batch_size": B}}


def _port(root, **model):
    cfg = load_config(preset="mld_humanml3d", overrides=_over(root, **model))
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    mld = MLD(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    return cfg, dm, mld


def _jax(root, **model):
    jcfg = jax_load_config(preset="mld_humanml3d",
                           overrides=_over(root, **model))
    jmld = JaxMLD(jcfg)
    return jcfg, jax_get_datamodule(jcfg, tokenizer=jmld.tokenizer), jmld


def _jax_losses(root, tree, steps, **model):
    """JAX's run from `tree`: each step's loss, read through a spy on
    jax.jit (the trainer jits its step when it runs)."""
    jcfg, jdm, jmld = _jax(root, **model)
    seen = []
    real_jit = jax.jit

    def spy_jit(fn, **kw):
        inner = real_jit(fn, **kw)

        def run(*args):
            out = inner(*args)
            seen.append(float(out[2]))
            return out
        return run

    jax.jit = spy_jit
    try:
        _, report = jax_pretrain(jcfg, jdm, jmld, tree, steps=steps,
                                 lr=LR, log_every=0)
    finally:
        jax.jit = real_jit
    return seen, report


def _port_losses(cfg, dm, mld, steps):
    seen = []
    report = pretrain_clip_text(cfg, dm, mld, steps=steps, lr=LR,
                                log_every=0,
                                on_step=lambda n, loss: seen.append(
                                    float(loss)))
    return seen, report


def test_losses_match_jax_each_step(root):
    cfg, dm, mld = _port(root)
    # frozen as the stages leave it; the run must leave it so again
    mld.clip.requires_grad_(False)
    tree = mld.params_tree()
    want, jax_report = _jax_losses(root, tree, STEPS)
    got, report = _port_losses(cfg, dm, mld, STEPS)
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert set(report) == set(jax_report) == {"steps", "style_mse_first",
                                             "style_mse_last"}
    for k, v in jax_report.items():
        assert abs(report[k] - v) <= LOSS_RTOL * abs(v), k
    assert report["style_mse_last"] < report["style_mse_first"]
    assert not any(p.requires_grad for p in mld.clip.parameters())


def test_bf16_tower_losses_match_jax(root):
    cfg, dm, mld = _port(root, clip_compute_dtype="bfloat16")
    assert mld.clip.compute_dtype == torch.bfloat16
    tree = mld.params_tree()
    want, _ = _jax_losses(root, tree, STEPS, clip_compute_dtype="bfloat16")
    got, _ = _port_losses(cfg, dm, mld, STEPS)
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL, atol=0)


class _FirstStepDone(Exception):
    pass


@pytest.fixture(scope="module")
def first_step(root):
    """JAX's first step from the port's init, eagerly: its gradients and the
    tree its first update gives (spies on jax.value_and_grad and
    optax.chain)."""
    cfg, dm, mld = _port(root)
    tree = mld.params_tree()
    jcfg, jdm, jmld = _jax(root)
    seen = {}
    real_chain, real_vg = optax.chain, jax.value_and_grad

    def spy_vg(fn, **kw):
        inner = real_vg(fn, **kw)

        def run(*args):
            loss, grads = inner(*args)
            seen["loss"] = float(loss)
            return loss, grads
        return run

    def spy_chain(*txs):
        inner = real_chain(*txs)

        def update(grads, state, params=None):
            updates, _ = inner.update(grads, state, params)
            seen["grads"] = jax.tree_util.tree_map(np.asarray, grads)
            seen["params"] = jax.tree_util.tree_map(
                np.asarray, optax.apply_updates(params, updates))
            raise _FirstStepDone
        return optax.GradientTransformation(inner.init, update)

    optax.chain, jax.value_and_grad = spy_chain, spy_vg
    try:
        with jax.disable_jit(), pytest.raises(_FirstStepDone):
            jax_pretrain(jcfg, jdm, jmld, tree, steps=800, lr=LR,
                         log_every=0)
    finally:
        optax.chain, jax.value_and_grad = real_chain, real_vg
    return cfg, dm, mld, seen


def _named(tree):
    """{"clip", "probe"} flax tree -> {torch name: tensor}."""
    out = {f"clip.{k}": v for k, v in
           flax_clip_to_state_dict(tree["clip"]).items()}
    out["probe.w"] = torch.tensor(np.asarray(tree["probe"]["w"]))
    out["probe.b"] = torch.tensor(np.asarray(tree["probe"]["b"]))
    return out


def _port_params(mld):
    w, b = make_probe(mld.cfg.model.text_encoded_dim, 0, "cpu")
    params = {f"clip.{k}": p for k, p in mld.clip.named_parameters()}
    params.update({"probe.w": w, "probe.b": b})
    for p in params.values():
        p.requires_grad_(True)
    return params


def test_first_step_gradients_match_jax(first_step):
    cfg, dm, mld, seen = first_step
    params = _port_params(mld)
    ids, style = batch_ids_style(
        next(iter(dm.loader("train", seed=0, drop_last=True))), "cpu")
    loss = style_loss(mld.clip, params["probe.w"], params["probe.b"], ids,
                      style)
    loss.backward()
    assert abs(loss.item() - seen["loss"]) <= LOSS_RTOL * seen["loss"]
    ref = _named(seen["grads"])
    assert set(ref) == set(params)
    top = max(g.abs().max().item() for g in ref.values())
    for name, g in ref.items():
        if name.endswith("k_proj.bias"):
            # zero: the softmax over keys ignores a shift common to all of
            # them; both packages leave roundoff of the other terms
            assert max(params[name].grad.abs().max().item(),
                       g.abs().max().item()) <= 1e-6 * top, name
            continue
        err = (params[name].grad - g).abs().max().item()
        assert err <= GRAD_RTOL * max(g.abs().max().item(), 1e-6), name


def test_first_update_matches_optax(first_step):
    _, _, mld, seen = first_step
    params = _port_params(mld)
    for name, g in _named(seen["grads"]).items():
        params[name].grad = g.clone()
    with torch.no_grad():
        ClippedAdam(list(params.values()), 800, LR,
                    warmup=max(20, 800 // 10), end=0.05).step()
    for name, want in _named(seen["params"]).items():
        err = (params[name].detach() - want).abs().max().item()
        assert err <= ADAM_RTOL * max(want.abs().max().item(), 1e-6), name


# (init fraction of lr, warmup, end fraction of lr) of the three users
SCHEDULES = {"evaluator": (lambda n: max(20, n // 10), 0.1),
             "pretrain": (lambda n: max(20, n // 10), 0.05),
             "e2e": (lambda n: max(50, n // 20), 0.02)}


@pytest.mark.parametrize("steps", [60, 150, 800, 12000])
@pytest.mark.parametrize("user", sorted(SCHEDULES))
def test_schedules_match_optax(user, steps):
    warmup_of, end = SCHEDULES[user]
    warmup = warmup_of(steps)
    lr = 3e-4
    sched = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.05, peak_value=lr, warmup_steps=warmup,
        decay_steps=steps, end_value=lr * end)
    for k in sorted({0, 1, warmup - 1, warmup, warmup + 1, steps // 2,
                     steps - 1, steps, steps + 5}):
        got = warmup_cosine(k, steps, lr, warmup, end)
        assert abs(got - float(sched(k))) <= 1e-9, k


def test_stages_after_pretraining_keep_the_tower_frozen(root):
    cfg, dm, mld = _port(root)
    before = {k: p.detach().clone() for k, p in mld.clip.named_parameters()}
    pretrain_clip_text(cfg, dm, mld, steps=2, log_every=0)
    # a fresh model's flags (on) restored
    assert all(p.requires_grad for p in mld.clip.parameters())
    assert any(not torch.equal(p, before[k])
               for k, p in mld.clip.named_parameters())
    clip_ids = {id(p) for p in mld.clip.parameters()}
    for stage in ("vae", "diffusion"):
        state = create_train_state(mld, stage)
        assert not any(p.requires_grad for p in mld.clip.parameters())
        held = [p for g in state.optimizer.param_groups for p in g["params"]]
        assert held and not any(id(p) in clip_ids for p in held)
        assert not any(k.startswith("clip.") for k in state.params)
