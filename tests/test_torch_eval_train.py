"""The evaluator trainer, the metrics during training and the evaluation CLI
of the port, on the CPU.

- ``eval/t2m_train.py`` vs ``mld_tpu/eval/t2m_train.py``: from the same
  bundle weights (the port's, through the npz both packages read) and the
  same first batch, the loss terms within 1e-5 relative and the gradients
  within 1e-4 of each leaf's largest |g| (f32 through two packages' GRUs
  and convolutions); then the port's clip + Adam + schedule applied to
  JAX's gradients gives JAX's updated weights within 1e-6 of each leaf's
  scale. Adam's first step is nearly lr x sign(g), so gradients 1e-7 apart
  around zero would give updates 2 x lr apart: the optimizer is compared on
  one set of gradients. The schedule is held to optax's over a whole run.
- ``train()`` with ``logger.val_metrics`` logs the val split's metrics and
  records the best-FID checkpoint in ``best_checkpoint.json``.
- ``python -m mld_tpu_torch.eval --device cpu`` loads a port checkpoint and
  writes finite metrics.
- The bundle's npz round trip between the packages.
"""
import json
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import jax
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data.datamodule import get_datamodule as jax_get_datamodule
from mld_tpu.eval.pipeline import T2MEvaluatorBundle as JaxBundle
from mld_tpu.eval.t2m_train import train_t2m_evaluator as jax_train
from mld_tpu.utils.checkpoint import save_params_npz as jax_save_npz

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.data.synthetic import build_synthetic_dataset
from mld_tpu_torch.eval.pipeline import T2MEvaluatorBundle
from mld_tpu_torch.eval.t2m_train import (ClippedAdam, batch_to,
                                          contrastive_loss,
                                          save_t2m_params,
                                          train_t2m_evaluator, warmup_cosine)
from mld_tpu_torch.models.clip_text import ClipTokenizer
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.train.loop import train
from mld_tpu_torch.utils.checkpoint import CheckpointManager
from mld_tpu_torch.utils.convert import flax_t2m_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLIPS = 64
B = 8
STEPS = 600   # the trainer's default run, for its schedule
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 1e-6
TINY_MODEL = {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
              "denoiser_num_layers": 3, "num_heads": 4,
              "text_encoded_dim": 32, "clip_layers": 2, "clip_heads": 2,
              "scheduler": {"num_inference_timesteps": 3}}
TINY_EVAL = {"batch_size": 8, "diversity_times": 4, "r_size": 4,
             "mm_num_samples": 2, "mm_num_repeats": 4, "mm_num_times": 2}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_eval_train"))
    build_synthetic_dataset(root, n_samples=N_CLIPS, seed=0)
    return root


def _over(root, **more):
    return {"debug": True,
            "dataset": {"root": root, "max_motion_len": 64,
                        "min_motion_len": 16, "native_loader": False},
            **more}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


class _FirstStepDone(Exception):
    pass


@pytest.fixture(scope="module")
def one_step(root, tmp_path_factory):
    """JAX's trainer from the port's random bundle, run eagerly up to its
    first update: the loss terms, the gradients it fed its optimizer and
    the weights that update gives, recorded through spies on
    jax.value_and_grad and optax.chain (the trainer looks both up when it
    runs)."""
    npz = str(tmp_path_factory.mktemp("t2m") / "start.npz")
    cfg = load_config(preset="mld_humanml3d", overrides=_over(root))
    save_t2m_params(npz, T2MEvaluatorBundle(cfg, device="cpu", seed=4))
    jcfg = jax_load_config(preset="mld_humanml3d", overrides=_over(
        root, eval={"t2m_params_path": npz}))
    jdm = jax_get_datamodule(jcfg)
    seen = {}
    real_chain, real_vg = optax.chain, jax.value_and_grad

    def spy_vg(fn, **kw):
        inner = real_vg(fn, **kw)

        def run(*args):
            (loss, aux), grads = inner(*args)
            seen["loss"] = float(loss)
            seen["acc"], seen["nce"], seen["mse"] = (float(a) for a in aux)
            return (loss, aux), grads
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
            jax_train(jcfg, jdm, steps=STEPS, batch_size=B, log_every=0)
    finally:
        optax.chain, jax.value_and_grad = real_chain, real_vg
    cfg = load_config(preset="mld_humanml3d", overrides=_over(
        root, eval={"t2m_params_path": npz}))
    return cfg, npz, seen


def _by_torch_name(tree):
    """{"text", "move", "motion"} flax tree -> the bundle's torch names."""
    attr = {"text": "textencoder", "move": "moveencoder",
            "motion": "motionencoder"}
    return {f"{attr[k]}.{n}": v for k in attr
            for n, v in flax_t2m_to_state_dict(tree[k]).items()}


def test_trainer_step_matches_jax(one_step):
    cfg, _, seen = one_step
    dm = get_datamodule(cfg)
    bundle = T2MEvaluatorBundle(cfg, device="cpu")
    bundle.train()
    bundle.requires_grad_(True)
    batch, style = batch_to(
        next(iter(dm.eval_embedding_loader("train", batch_size=B))), "cpu")
    stats = tuple(torch.as_tensor(a, dtype=torch.float32)
                  for a in (dm.mean, dm.std, dm.mean_eval, dm.std_eval))
    loss, acc, nce, mse = contrastive_loss(bundle, batch, style, stats,
                                           cfg.dataset.unit_len)
    loss.backward()
    for name, got in (("loss", loss), ("nce", nce), ("mse", mse)):
        assert abs(got.item() - seen[name]) <= LOSS_RTOL * abs(seen[name])
    assert acc.item() == seen["acc"]
    ref = _by_torch_name(seen["grads"])
    grads = dict(bundle.named_parameters())
    assert set(ref) == set(grads)
    for name, g in ref.items():
        err = (grads[name].grad - g).abs().max().item()
        assert err <= GRAD_RTOL * max(g.abs().max().item(), 1e-6), name


def test_trainer_update_matches_optax(one_step):
    cfg, _, seen = one_step
    bundle = T2MEvaluatorBundle(cfg, device="cpu")
    bundle.requires_grad_(True)
    params = dict(bundle.named_parameters())
    for name, g in _by_torch_name(seen["grads"]).items():
        params[name].grad = g.clone()
    ClippedAdam(list(params.values()), STEPS, 5e-4).step()
    for name, want in _by_torch_name(seen["params"]).items():
        err = (params[name].detach() - want).abs().max().item()
        assert err <= ADAM_RTOL * max(want.abs().max().item(), 1e-6), name


@pytest.mark.parametrize("steps", [21, 50, 600])
def test_schedule_matches_optax(steps):
    sched = optax.warmup_cosine_decay_schedule(
        init_value=5e-4 * 0.05, peak_value=5e-4,
        warmup_steps=max(20, steps // 10), decay_steps=steps,
        end_value=5e-4 * 0.1)
    for k in sorted({0, 1, 19, 20, 21, steps // 2, steps - 1, steps,
                     steps + 5}):
        assert abs(warmup_cosine(k, steps, 5e-4) - float(sched(k))) <= 1e-9


def test_trained_bundle_npz_reads_in_both_packages(one_step, root, tmp_path):
    cfg, _, _ = one_step
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    bundle, report = train_t2m_evaluator(cfg, dm, steps=2, batch_size=B,
                                         log_every=0, device="cpu")
    assert report["steps"] == 2 and np.isfinite(report["loss_last"])
    assert not any(p.requires_grad for p in bundle.parameters())
    path = str(tmp_path / "trained.npz")
    save_t2m_params(path, bundle)
    jcfg = jax_load_config(preset="mld_humanml3d", overrides=_over(
        root, eval={"t2m_params_path": path}))
    loaded = _flat(JaxBundle(jcfg).params)
    mine = _flat(bundle.params_tree())
    assert set(loaded) == set(mine)
    for k, v in mine.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    # and a JAX export loads into the port
    jax_path = str(tmp_path / "jax.npz")
    jax_save_npz(jax_path, JaxBundle(jcfg, seed=9).params)
    back = T2MEvaluatorBundle(load_config(preset="mld_humanml3d",
                                          overrides=_over(root, eval={
                                              "t2m_params_path": jax_path})),
                              device="cpu")
    want = _flat(JaxBundle(jcfg, seed=9).params)
    for k, v in _flat(back.params_tree()).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_train_records_val_metrics_and_best_fid(root, tmp_path):
    cfg = load_config(preset="mld_humanml3d", overrides=_over(
        root, name="val_metrics", model=TINY_MODEL, eval=TINY_EVAL,
        train={"stage": "vae", "batch_size": 8, "end_epoch": 2},
        logger={"folder": str(tmp_path), "save_checkpoint_epoch": 10,
                "val_every_epochs": 1, "val_metrics": True}))
    train(cfg, device="cpu")
    exp = tmp_path / "mld" / "val_metrics"
    with open(exp / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    vm = [r for r in recs if r["split"] == "val-metrics"]
    assert [r["step"] for r in vm] == [0, 1]
    for r in vm:
        for k in ("FID", "R_precision_top_1", "Matching_score", "Diversity",
                  "APE_root"):
            assert np.isfinite(r[k]), k
    with open(exp / "best_checkpoint.json") as f:
        best = json.load(f)
    fids = [r["FID"] for r in vm]
    assert best["epoch"] == 1 + int(np.argmin(fids))
    assert best["metrics"]["FID"] == min(fids)
    assert os.path.exists(best["checkpoint"])


def test_eval_cli_on_the_cpu(root, tmp_path):
    cfg = tmp_path / "tiny.json"
    # a YAML file; JSON is a subset of YAML
    cfg.write_text(json.dumps({
        "name": "eval_cli", "model": TINY_MODEL,
        "dataset": {"root": root, "max_motion_len": 64,
                    "min_motion_len": 16},
        "eval": TINY_EVAL, "logger": {"folder": str(tmp_path)}}))
    out = tmp_path / "metrics.json"
    # a port checkpoint of the same model, as training writes them
    ckpt_dir = str(tmp_path / "checkpoints")
    CheckpointManager(ckpt_dir).save(1, MLD(load_config(
        str(cfg), {"debug": False}), device="cpu",
        generator=torch.Generator().manual_seed(5)))
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "mld_tpu_torch.eval", "--cfg", str(cfg),
         "--device", "cpu", "--replication", "2", "--gt", "--out", str(out),
         "--checkpoint", ckpt_dir],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        res = json.load(f)
    for k in ("FID", "R_precision_top_1", "R_precision_top_2",
              "R_precision_top_3", "Matching_score", "Diversity",
              "MultiModality", "APE_root", "gt_only/FID"):
        assert np.isfinite(res[k]) and np.isfinite(res.get(f"{k}/conf95",
                                                           0.0)), k
    assert "results written to" in proc.stdout
    assert f"loaded ['denoiser', 'vae'] from {ckpt_dir}" in proc.stdout


def test_memo_word_vectorizer_gives_the_carried_vectors():
    from mld_tpu_torch.data.datamodule import MemoWordVectorizer
    from mld_tpu_torch.data.word_vectorizer import WordVectorizer
    plain, memo = WordVectorizer(""), MemoWordVectorizer("")
    for token in ("walks/VERB", "forward/ADP", "person/NOUN", "walks/VERB",
                  "unk/OTHER"):
        (v0, p0), (v1, p1) = plain[token], memo[token]
        np.testing.assert_array_equal(v0, v1)
        np.testing.assert_array_equal(p0, p1)
    assert len(memo._memo) == 4
    assert not memo["walks/VERB"][0].flags.writeable
