"""The synthetic end-to-end protocol of the port against the JAX package, on
the CPU.

- ``data/sampling.py`` is a carried copy of ``mld_tpu/data/sampling.py``:
  the same source, the same outputs.
- A JAX bundle (``save_params_npz``) whose ``clip`` subtree is not the
  init's gives the port, through ``load_pretrained``, the text features
  JAX's ``_load_pretrained`` gives (f32 tower, 1e-5, the CLIP bar of
  tests/test_torch_modules.py).
- ``state_dict_to_flax`` / ``MLD.params_tree`` round-trip JAX's init tree of
  every model family and option exactly (flax -> state -> flax), and a
  VPosert's batch_stats through ``module_state_to_flax``.
- A bundle the port writes (``MLD.params_tree`` through
  ``save_params_npz``) loads in JAX, whose CLIP features (1e-5) and
  generated joints (1e-3 x max(scale, 1), the bar of
  tests/test_torch_generate.py; the same initial latents) are the port's.
- Each e2e script runs end to end at the smallest budget the corpus
  splits allow, and its report has the JAX report's keys.
"""
import inspect
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data import sampling as jax_sampling
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.mld import lengths_to_mask as jax_lengths_to_mask
from mld_tpu.train.loop import _load_pretrained as jax_load_pretrained
from mld_tpu.utils.checkpoint import save_params_npz as jax_save_npz

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data import sampling
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.scripts import train_a2m_e2e, train_synthetic_e2e
from mld_tpu_torch.utils.checkpoint import (load_params_npz,
                                            load_pretrained, save_params_npz)
from mld_tpu_torch.utils.convert import (flax_to_state_dict,
                                         module_state_to_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_ATOL = 1e-5
E2E_RTOL = 1e-3
TINY = {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
        "denoiser_num_layers": 3, "num_heads": 2, "text_encoded_dim": 48,
        "clip_layers": 2, "clip_heads": 2, "clip_compute_dtype": "float32",
        "scheduler": {"num_inference_timesteps": 2}}
OVER = {"model": TINY, "dataset": {"max_motion_len": 32}}
TEXTS = ["a man kicks something with his left leg.", "someone jumps"]
LENGTHS = [32, 19]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else
                   {key: np.asarray(v)})
    return out


# ------------------------------------------------------------------ sampling
def test_sampling_is_the_carried_copy():
    for name in ("subsample", "upsample"):
        assert (inspect.getsource(getattr(sampling, name))
                == inspect.getsource(getattr(jax_sampling, name))), name
    motion = np.random.RandomState(0).randn(17, 22, 3).astype(np.float32)
    for a, b in ((100.0, 20.0), (30.0, 12.5)):
        np.testing.assert_array_equal(sampling.subsample(97, a, b),
                                      jax_sampling.subsample(97, a, b))
    for a, b in ((20.0, 60.0), (12.5, 30.0)):
        np.testing.assert_array_equal(sampling.upsample(motion, a, b),
                                      jax_sampling.upsample(motion, a, b))


# ------------------------------------------- a JAX bundle's CLIP tower (fault)
def test_jax_bundle_tower_loads_as_jax_loads_it(tmp_path):
    cfg = jax_load_config(preset="mld_humanml3d", overrides=OVER)
    jmld = JaxMLD(cfg)
    init = _np(jmld.init_params(jax.random.PRNGKey(0)))
    ids = jmld.tokenize(TEXTS)
    # a tower trained away from any init: another seed's, scaled
    bundle = dict(init, clip=jax.tree_util.tree_map(
        lambda a: 1.5 * np.asarray(a),
        jmld.clip.init({"params": jax.random.PRNGKey(5)}, ids)["params"]))
    path = str(tmp_path / "bundle.npz")
    jax_save_npz(path, bundle)

    loaded = jax_load_pretrained(path, init)
    want = np.asarray(jmld.clip.apply({"params": loaded["clip"]}, ids,
                                      mode="features"))
    mld = MLD(load_config(preset="mld_humanml3d", overrides=OVER),
              device="cpu", generator=torch.Generator().manual_seed(7))
    before = mld.clip(torch.as_tensor(np.array(ids)).long(),
                      mode="features").detach().numpy()
    assert np.abs(before - want).max() > 100 * CLIP_ATOL
    tops = load_pretrained(mld, path)
    assert sorted(tops) == ["clip", "denoiser", "vae"]
    got = mld.clip(torch.as_tensor(np.array(ids)).long(),
                   mode="features").detach().numpy()
    np.testing.assert_allclose(got, want, atol=CLIP_ATOL, rtol=0)
    # `only` names the modules, the tower among them, as in JAX
    other = MLD(load_config(preset="mld_humanml3d", overrides=OVER),
                device="cpu", generator=torch.Generator().manual_seed(8))
    assert load_pretrained(other, path, only=("clip",)) == ["clip"]
    for k, p in other.clip.named_parameters():
        assert torch.equal(p, dict(mld.clip.named_parameters())[k]), k


# --------------------------------------------------------- the flax bridge
ARMS = {
    "mld_humanml3d": ("mld_humanml3d", {}),
    "mld_humanact12": ("mld_humanact12", {}),
    "novae_humanml3d": ("novae_humanml3d", {}),
    "vposert": ("mld_humanml3d", {"vae_type": "vposert"}),
    "ablation": ("mld_humanml3d", {"vae_arch": "all_encoder",
                                   "mlp_dist": True, "normalize_before": True,
                                   "position_embedding": "sine",
                                   "skip_connect": False}),
    "trans_dec": ("mld_humanml3d", {"denoiser_arch": "trans_dec"}),
    "hidden": ("mld_humanml3d", {"clip_last_hidden": True}),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_params_tree_round_trips_jax_init_exactly(arm):
    preset, option = ARMS[arm]
    model = {**TINY, **option}
    if preset == "novae_humanml3d":
        model.pop("latent_dim")
    over = {"model": model, "dataset": {"max_motion_len": 32}}
    tree = _np(JaxMLD(jax_load_config(None, over, preset=preset))
               .init_params(jax.random.PRNGKey(0)))
    mld = MLD(load_config(None, over, preset=preset), device="cpu")
    mld.load_flax_params(tree)
    back = mld.params_tree()
    want, got = _flat(tree), _flat(back)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_vposert_batch_stats_round_trip():
    over = {"model": {**TINY, "vae_type": "vposert"},
            "dataset": {"max_motion_len": 32}}
    vae = _np(JaxMLD(jax_load_config(None, over, preset="mld_humanml3d"))
              .init_params(jax.random.PRNGKey(0)))["vae"]
    rng = np.random.RandomState(3)
    stats = {name: {"mean": rng.randn(*p["scale"].shape).astype(np.float32),
                    "var": rng.rand(*p["scale"].shape).astype(np.float32)}
             for name, p in vae.items() if name.startswith("bn")}
    assert stats
    params, back = module_state_to_flax(flax_to_state_dict(vae, stats))
    assert _flat(back).keys() == _flat(stats).keys()
    for k, v in _flat(stats).items():
        np.testing.assert_array_equal(_flat(back)[k], v, err_msg=k)
    for k, v in _flat(vae).items():
        np.testing.assert_array_equal(_flat(params)[k], v, err_msg=k)


def test_port_bundle_computes_the_same_in_jax(tmp_path):
    rng = np.random.RandomState(0)
    mean = (0.1 * rng.randn(263)).astype(np.float32)
    std = (0.5 + rng.rand(263)).astype(np.float32)
    cfg = load_config(preset="mld_humanml3d", overrides=OVER)
    mld = MLD(cfg, mean=mean, std=std, device="cpu",
              generator=torch.Generator().manual_seed(11))
    path = str(tmp_path / "trained_params.npz")
    save_params_npz(path, mld.params_tree())
    assert sorted(load_params_npz(path)) == ["clip", "denoiser", "vae"]

    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=OVER),
                  mean=mean, std=std)
    params = jax_load_pretrained(path, jmld.init_params(jax.random.PRNGKey(0)))
    ids = mld.tokenize(TEXTS)
    want = np.asarray(jmld.clip.apply({"params": params["clip"]},
                                      jnp.asarray(ids.numpy()),
                                      mode="features"))
    got = mld.clip(ids, mode="features").detach().numpy()
    np.testing.assert_allclose(got, want, atol=CLIP_ATOL, rtol=0)

    mask = jax_lengths_to_mask(jnp.asarray(LENGTHS), jmld.max_frames)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jmld.generate_joints(params, jnp.asarray(ids.numpy()),
                                          mask, key))
    _, init_rng = jax.random.split(key)
    init = np.asarray(jmld._init_latents(init_rng, len(TEXTS), mask))
    out = mld.generate_joints(
        ids, lengths_to_mask(LENGTHS, mld.max_frames, "cpu"),
        init_latents=torch.from_numpy(init.copy())).numpy()
    assert out.shape == ref.shape
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= E2E_RTOL * max(scale, 1.0), (err, scale)


# ---------------------------------------------------------- the e2e scripts
def _check_keys(got, want, where=""):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k, v in want.items():
        if isinstance(v, dict) and k != "val_fid_curve":
            _check_keys(got[k], v, f"{where}/{k}")


def test_t2m_script_end_to_end_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "report.json")
    workdir = str(tmp_path / "work")
    # the smallest corpus whose splits run every section: a test split of
    # at least one batch of 32 (drop_last) and a val split above r_size 32
    rc = train_synthetic_e2e.main([
        "--device", "cpu", "--steps", "2", "--clip-steps", "2",
        "--eval-steps", "2", "--samples", "220", "--workdir", workdir,
        "--out", out])
    with open(out) as f:
        report = json.load(f)
    printed = capsys.readouterr().out
    ok = train_synthetic_e2e.learned(report, loop_ran=True)
    assert rc == (0 if ok else 1)
    assert f"E2E LEARNING CHECK: {'PASS' if ok else 'FAIL'}" in printed

    with open(os.path.join(REPO, "docs", "e2e_report_r5_noclip.json")) as f:
        want = json.load(f)
    with open(os.path.join(REPO, "docs", "e2e_report_r5.json")) as f:
        want["clip_pretrain"] = json.load(f)["clip_pretrain"]
    _check_keys(report, want)
    assert report["backend"] == "cpu" and report["clip_pretrain"]["steps"] == 2
    for key in ("eval_gt", "eval_random_init", "eval_trained"):
        assert all(np.isfinite(v) for v in report[key].values()), key
    assert [p["epoch"] for p in report["val_fid_curve"]] == [0, 1, 2]
    assert all(np.isfinite(p["FID"]) for p in report["val_fid_curve"])
    with open(os.path.join(workdir, "cfg.json")) as f:
        assert json.load(f)["model"]["text_encoded_dim"] == 64
    # the bundle holds all three modules, the trained tower included (JAX
    # reads such a bundle: test_port_bundle_computes_the_same_in_jax)
    assert sorted(load_params_npz(report["params_path"])) == [
        "clip", "denoiser", "vae"]


def test_a2m_script_end_to_end_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    out = str(tmp_path / "report.json")
    rc = train_a2m_e2e.main([
        "--device", "cpu", "--steps", "2", "--cls-steps", "2",
        "--replication", "1", "--workdir", str(tmp_path / "work"),
        "--out", out])
    with open(out) as f:
        report = json.load(f)
    printed = capsys.readouterr().out
    ok = train_a2m_e2e.learned(report)
    assert rc == (0 if ok else 1)
    assert f"A2M E2E LEARNING CHECK: {'PASS' if ok else 'FAIL'}" in printed
    assert set(report) == {
        "steps", "backend", "chance_accuracy", "classifier", "vae",
        "diffusion", "params_path", "trained_cls_trained_gen",
        "trained_cls_random_gen", "random_cls_trained_gen"}
    assert set(report["classifier"]) == {"steps", "loss_first", "loss_last",
                                         "train_acc_last"}
    for arm in ("trained_cls_trained_gen", "trained_cls_random_gen",
                "random_cls_trained_gen"):
        for k in ("accuracy", "gt_accuracy", "FID"):
            assert np.isfinite(report[arm][k]), (arm, k)
    assert sorted(load_params_npz(report["params_path"])) == [
        "denoiser", "vae"]
