"""The port's training data pipeline and CLI vs the JAX package, on the CPU.

- The synthetic corpus twin writes the JAX package's files: the same texts,
  splits and stamp, and features, ``Mean.npy`` and ``Std.npy`` within 1e-4
  (f32 feature codec in two packages; one f32 ulp of the quaternion
  products is ~1e-7 and the codec carries it through a few dozen steps).
- The carried ``dataset`` / ``collate`` / ``word_vectorizer`` /
  ``param_util`` copies stay equal to their originals (source text and
  constants), and give the same batches as JAX's for one seed.
- ``python -m mld_tpu_torch.train --device cpu --max_steps 2`` writes a
  checkpoint that ``--resume`` restores.
- A VAE hands off between the packages: the JAX package loads a port
  checkpoint (``load_reference_checkpoint``), the port loads a JAX
  ``save_params_npz`` export, both exactly.
"""
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data import collate as jcollate
from mld_tpu.data import dataset as jdataset
from mld_tpu.data import word_vectorizer as jwv
from mld_tpu.data.datamodule import get_datamodule as jax_get_datamodule
from mld_tpu.data.humanml import param_util as jparam
from mld_tpu.data.synthetic import build_synthetic_dataset as jax_build
from mld_tpu.utils.checkpoint import (load_reference_checkpoint,
                                      save_params_npz)
from mld_tpu.utils.torch_convert import torch_state_dict_to_flax

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data import collate, dataset, word_vectorizer
from mld_tpu_torch.data.datamodule import get_datamodule, needs_synthesis
from mld_tpu_torch.data.humanml import param_util
from mld_tpu_torch.data.synthetic import SYNTH_VERSION, build_synthetic_dataset
from mld_tpu_torch.models.clip_text import ClipTokenizer
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.utils.checkpoint import CheckpointManager, load_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLIPS = 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    jroot = str(tmp_path_factory.mktemp("synth_jax"))
    troot = str(tmp_path_factory.mktemp("synth_torch"))
    jax_build(jroot, n_samples=N_CLIPS, seed=0)
    build_synthetic_dataset(troot, n_samples=N_CLIPS, seed=0)
    return jroot, troot


def test_synthetic_twin_writes_the_jax_files(roots):
    jroot, troot = roots
    for name in ("train.txt", "val.txt", "test.txt", ".synth_version"):
        with open(os.path.join(jroot, name)) as a, \
                open(os.path.join(troot, name)) as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(os.path.join(troot, "texts"))) == sorted(
        os.listdir(os.path.join(jroot, "texts")))
    for name in os.listdir(os.path.join(jroot, "texts")):
        with open(os.path.join(jroot, "texts", name)) as a, \
                open(os.path.join(troot, "texts", name)) as b:
            assert a.read() == b.read(), name
    names = sorted(os.listdir(os.path.join(jroot, "new_joint_vecs")))
    assert len(names) == N_CLIPS
    for name in names:
        a = np.load(os.path.join(jroot, "new_joint_vecs", name))
        b = np.load(os.path.join(troot, "new_joint_vecs", name))
        assert a.shape == b.shape and b.dtype == np.float32, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=name)
    for name in ("Mean.npy", "Std.npy"):
        np.testing.assert_allclose(np.load(os.path.join(troot, name)),
                                   np.load(os.path.join(jroot, name)),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_carried_copies_equal_originals():
    for port, orig, names in (
            (dataset, jdataset, ("TextEntry", "Text2MotionDataset",
                                 "DataLoader", "PrefetchDataLoader")),
            (collate, jcollate, ("lengths_to_mask_np", "MldCollator")),
            (word_vectorizer, jwv, ("WordVectorizer",)),
            (param_util, jparam, ("parents_from_chains",))):
        for name in names:
            assert (inspect.getsource(getattr(port, name))
                    == inspect.getsource(getattr(orig, name))), name
    for name in ("POS_ENUMERATOR", "LOC_LIST", "BODY_LIST", "OBJ_LIST",
                 "ACT_LIST", "DESC_LIST", "VIP_DICT"):
        assert getattr(word_vectorizer, name) == getattr(jwv, name), name
    consts = [n for n in dir(jparam) if n.isupper()]
    assert consts
    for name in consts:
        a, b = getattr(param_util, name), getattr(jparam, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.dtype == b.dtype, name
        else:
            assert a == b, name


def _cfg_over(root):
    return {"debug": True,
            "dataset": {"root": root, "max_motion_len": 64,
                        "min_motion_len": 16, "native_loader": False},
            "train": {"batch_size": 4}}


@pytest.mark.parametrize("split", ["train", "val"])
def test_batches_equal_jax(roots, split):
    _, troot = roots
    tok = ClipTokenizer(None)
    jdm = jax_get_datamodule(jax_load_config(preset="mld_humanml3d",
                                             overrides=_cfg_over(troot)),
                             tokenizer=tok)
    tdm = get_datamodule(load_config(preset="mld_humanml3d",
                                     overrides=_cfg_over(troot)),
                         tokenizer=tok)
    np.testing.assert_array_equal(tdm.mean, jdm.mean)
    kw = dict(seed=3, drop_last=split == "train", prefetch=0)
    jb = list(jdm.loader(split, **kw))
    tb = list(tdm.loader(split, **kw))
    assert len(tb) == len(jb) > 0
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                assert b[k].dtype == a[k].dtype, k
            else:
                assert b[k] == a[k], k
    assert tb[0]["text_ids"].shape[1] == 77


def test_datamodule_synthesizes_when_missing_or_stale(tmp_path):
    root = str(tmp_path / "corpus")
    assert needs_synthesis(root)
    build_synthetic_dataset(root, n_samples=4)
    assert not needs_synthesis(root)
    with open(os.path.join(root, ".synth_version"), "w") as f:
        f.write(str(SYNTH_VERSION - 1))
    assert needs_synthesis(root)


def _run_cli(*args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "mld_tpu_torch.train", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout + proc.stderr


def test_cli_trains_and_resumes_on_the_cpu(roots, tmp_path):
    _, troot = roots
    cfg = tmp_path / "tiny.json"
    folder = tmp_path / "experiments"
    # a YAML file; JSON is a subset of YAML
    cfg.write_text(json.dumps({
        "name": "cli_test",
        "model": {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
                  "denoiser_num_layers": 3, "num_heads": 4,
                  "text_encoded_dim": 32, "clip_layers": 2,
                  "clip_heads": 2},
        "dataset": {"root": troot, "max_motion_len": 64,
                    "min_motion_len": 16},
        "train": {"batch_size": 4},
        "logger": {"folder": str(folder)}}))
    args = ("--cfg", str(cfg), "--device", "cpu", "--stage", "vae")
    _run_cli(*args, "--max_steps", "2", cwd=str(tmp_path))
    exp = folder / "mld" / "cli_test"
    ckpt = CheckpointManager(str(exp / "checkpoints"))
    assert ckpt.steps() == [1]
    first = ckpt.restore()
    assert first["step"] == 1
    assert not any(k.startswith("clip.") for k in first["state_dict"])
    state = first["optimizer"]["optimizer"]["state"]
    assert {int(s["step"]) for s in state.values()} == {2}

    out = _run_cli(*args, "--max_steps", "1", "--resume", str(exp),
                   cwd=str(tmp_path))
    assert "resumed from epoch 1" in out
    assert ckpt.steps() == [1, 2]
    second = ckpt.restore()
    state = second["optimizer"]["optimizer"]["state"]
    assert {int(s["step"]) for s in state.values()} == {3}
    moved = [k for k in first["state_dict"]
             if not torch.equal(first["state_dict"][k], second["state_dict"][k])]
    assert moved and all(k.startswith("vae.") for k in moved)
    with open(exp / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines if r["split"] == "train"] == [0, 1]


def _flax_tree(state, top):
    tree = torch_state_dict_to_flax(
        {k[len(top) + 1:]: v.numpy() for k, v in state.items()
         if k.startswith(top + ".")})
    if "emb_proj_1" in tree:
        tree["emb_proj"] = tree.pop("emb_proj_1")
    return tree


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


def test_vae_hands_off_between_packages(tmp_path):
    cfg = load_config(preset="mld_humanml3d", overrides={"model": {
        "latent_dim": 32, "ff_size": 64, "num_layers": 3,
        "denoiser_num_layers": 3, "text_encoded_dim": 32, "clip_layers": 1,
        "clip_heads": 2}, "dataset": {"max_motion_len": 32}})
    trained = MLD(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    state = {k: v.detach().clone() for k, v in trained.state_dict().items()}

    # port checkpoint -> the JAX package's diffusion-stage loader
    CheckpointManager(str(tmp_path / "ckpt")).save(3, trained)
    target = {top: _flax_tree(state, top) for top in ("vae", "denoiser")}
    loaded = load_reference_checkpoint(str(tmp_path / "ckpt" / "3.pt"),
                                       target)
    _assert_trees_equal(loaded["vae"], target["vae"])

    # a JAX save_params_npz export -> the port's pretrained_vae loader
    save_params_npz(str(tmp_path / "jax.npz"), target)
    other = MLD(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    assert load_pretrained(other, str(tmp_path / "jax.npz"),
                           only=("vae",)) == ["vae"]
    for k, v in other.state_dict().items():
        if k.startswith("vae."):
            assert torch.equal(v, state[k]), k
    w = "denoiser.encoder.middle_block.linear1.weight"
    assert not torch.equal(other.state_dict()[w], state[w])
