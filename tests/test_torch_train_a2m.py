"""Training the action presets through the port's loop and CLI, on the CPU.

- The a2m loader takes the text loader's ``drop_last`` and ``prefetch``: for
  one seed its batches are the JAX package's ``A2MDataModule.loader``'s
  (over the same dataset items), with only the short last batch dropped.
  JAX's own ``train()`` cannot run these presets: ``loop.py:217`` passes
  ``drop_last`` to that loader, which has no such parameter.
- ``train(cfg, max_steps=2, device="cpu")`` runs each stage of
  ``mld_humanact12`` (tiny widths, 16 frames, on a synthetic pose archive):
  finite logs, the validation loss on the test split, a checkpoint, frozen
  params unchanged and every trainable module moved.
- The ``pretrained_vae`` handoff loads the vae stage's ACTOR VAE into the
  diffusion stage, and ``python -m mld_tpu_torch.train --preset
  mld_humanact12`` trains and resumes.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data import a2m as jax_a2m

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data.a2m import synth_humanact12_pkl
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.train.loop import train
from mld_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "mld_humanact12"
STAGES = ("vae", "diffusion", "vae_diffusion")
MODEL = {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
         "denoiser_num_layers": 3, "num_heads": 4, "dropout": 0.1,
         "scheduler": {"num_inference_timesteps": 3}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def a2m_root(tmp_path_factory):
    """24 clips: a train split of 21 (5 batches of 4, the last of 1) and a
    test split of 3."""
    root = tmp_path_factory.mktemp("synth_humanact12_train_loop")
    synth_humanact12_pkl(str(root / "humanact12poses.pkl"), n_per_class=2)
    return str(root)


def tiny_over(root, folder, stage, **train_kw):
    return {"name": f"a2m_{stage}", "model": MODEL,
            "dataset": {"root": root, "num_frames": 16},
            "train": {"stage": stage, "batch_size": 4, **train_kw},
            "eval": {"batch_size": 2},
            "logger": {"folder": str(folder), "val_every_epochs": 1,
                       "save_checkpoint_epoch": 1}}


def test_a2m_loader_drops_only_the_short_tail_as_jax_would(a2m_root):
    over = {"dataset": {"root": a2m_root, "num_frames": 16},
            "train": {"batch_size": 5}}
    dm = get_datamodule(load_config(preset=PRESET, overrides=over))
    jdm = jax_a2m.get_a2m_datamodule(jax_load_config(preset=PRESET,
                                                     overrides=over))
    # JAX's loader over a dataset of its own, equal to the port's item for
    # item (tests/test_torch_a2m.py): each dataset draws its crops from its
    # own RNG, so each loader reads its own
    jdm._datasets["train"] = type(dm.dataset("train"))(a2m_root, 16, "train")
    n = len(dm.dataset("train"))
    assert n % 5 != 0
    jax_b = list(jdm.loader("train", seed=3))
    port = dm.loader("train", seed=3, drop_last=True)
    assert len(port) == n // 5 == len(jax_b) - 1
    port_b = list(port)
    assert len(port_b) == len(jax_b) - 1 and len(jax_b[-1]["action"]) == n % 5
    for b, jb in zip(port_b, jax_b):
        assert b.keys() == jb.keys()
        np.testing.assert_array_equal(b["motion"], jb["motion"])
        for k in ("length", "mask", "action"):
            np.testing.assert_array_equal(b[k], jb[k])
    # without drop_last, and without the prefetch thread, every batch
    whole = list(get_datamodule(load_config(preset=PRESET, overrides=over))
                 .loader("train", seed=3, prefetch=0))
    assert [len(b["action"]) for b in whole] == [5] * (n // 5) + [n % 5]


def _watch():
    seen = {"logs": []}

    def on_step(state, step, logs):
        if step == 0:
            seen["before"] = {k: p.detach().clone()
                              for k, p in state.mld.named_parameters()}
            seen["trainable"] = set(state.params)
        else:
            seen["logs"].append({k: float(v) for k, v in logs.items()})
    return seen, on_step


@pytest.mark.parametrize("stage", STAGES)
def test_train_runs_an_action_stage(a2m_root, tmp_path, stage):
    cfg = load_config(preset=PRESET,
                      overrides=tiny_over(a2m_root, tmp_path, stage))
    seen, on_step = _watch()
    mld = train(cfg, max_steps=2, device="cpu", on_step=on_step)
    assert mld.clip is None and mld.tokenizer is None
    assert len(seen["logs"]) == 2
    for logs in seen["logs"]:
        assert all(np.isfinite(v) for v in logs.values()), logs
    after = dict(mld.named_parameters())
    tops = {k.split(".", 1)[0] for k in seen["trainable"]}
    assert tops == ({"vae", "denoiser"} if stage == "vae_diffusion"
                    else {"vae" if stage == "vae" else "denoiser"})
    for k, before in seen["before"].items():
        if k not in seen["trainable"]:
            assert torch.equal(after[k], before), k
    assert {k.split(".", 1)[0] for k in seen["trainable"]
            if not torch.equal(after[k], seen["before"][k])} == tops
    exp = tmp_path / "mld" / cfg.name
    with open(exp / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["split"] for r in lines] == ["train", "val"]
    assert np.isfinite(lines[1]["total"])
    assert CheckpointManager(str(exp / "checkpoints")).steps() == [1]


def test_pretrained_vae_hands_the_actor_vae_to_diffusion(a2m_root, tmp_path):
    vae = load_config(preset=PRESET,
                      overrides=tiny_over(a2m_root, tmp_path, "vae"))
    train(vae, max_steps=1, device="cpu")
    ckpt = tmp_path / "mld" / vae.name / "checkpoints"
    saved = CheckpointManager(str(ckpt)).restore()["state_dict"]
    cfg = load_config(preset=PRESET, overrides=tiny_over(
        a2m_root, tmp_path, "diffusion", pretrained_vae=str(ckpt)))
    seen, on_step = _watch()
    mld = train(cfg, max_steps=1, device="cpu", on_step=on_step)
    for k, v in seen["before"].items():
        if k.startswith("vae."):
            assert torch.equal(v, saved[k]), k
    for k, p in mld.vae.named_parameters():
        assert torch.equal(p, saved["vae." + k]) and not p.requires_grad, k


def _run_cli(*args, cwd):
    out = subprocess.run([sys.executable, "-m", "mld_tpu_torch.train", *args],
                         cwd=cwd, env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout + out.stderr


def test_cli_trains_and_resumes_an_action_preset(a2m_root, tmp_path):
    over = tiny_over(a2m_root, tmp_path / "exp", "vae")
    over["name"] = "cli_a2m"
    cfg = tmp_path / "a2m.yaml"
    cfg.write_text(yaml.safe_dump(over))
    args = ("--preset", PRESET, "--cfg", str(cfg), "--device", "cpu")
    _run_cli(*args, "--max_steps", "1", cwd=str(tmp_path))
    exp = tmp_path / "exp" / "mld" / "cli_a2m"
    ckpt = CheckpointManager(str(exp / "checkpoints"))
    assert ckpt.steps() == [1]
    first = ckpt.restore()
    assert not any(k.startswith("clip.") for k in first["state_dict"])

    out = _run_cli(*args, "--max_steps", "1", "--resume", str(exp),
                   cwd=str(tmp_path))
    assert "resumed from epoch 1" in out
    assert ckpt.steps() == [1, 2]
    second = ckpt.restore()
    state = second["optimizer"]["optimizer"]["state"]
    assert {int(s["step"]) for s in state.values()} == {2}
    moved = [k for k in first["state_dict"]
             if not torch.equal(first["state_dict"][k],
                                second["state_dict"][k])]
    assert moved and all(k.startswith("vae.") for k in moved)
