"""The port's action-to-motion evaluation vs the JAX package's, on the CPU.

- The HumanAct12 GRU classifier (logits and features) and the UESTC ST-GCN
  (graph, random weights from the same numpy draws, forward) against the
  JAX networks with the same weights: 2e-5 f32 (1e-4 for the ST-GCN's ten
  blocks).
- ``HUMANACTMetrics`` and ``UESTCMetrics``: update on the same inputs, then
  ``compute`` with one ``RandomState``: every metric within 1e-4 relative.
- ``Evaluator.run_split_a2m`` for both presets and both stages on a tiny
  config (D=32, 3 layers, DDIM-5) over a synthetic pkl whose test split ends
  in a ragged batch, against ``mld_tpu.eval.pipeline.Evaluator`` with the
  same weights and JAX's draws replayed a batch: metrics within 1e-4
  relative, accuracies (counts of argmaxes) equal.
- 22 steps of ``train_a2m_classifier`` (three epochs of a 32-clip train
  split) against JAX's from the same initial weights: the reported losses
  and accuracy 1e-5, the weights 1e-4 of each leaf's scale.
- The checkpoint loaders (``convert_humanact12_checkpoint``,
  ``from_checkpoint``, ``convert_stgcn_checkpoint``) on seeded ``.tar``
  files against the JAX package's, and the npz the trainer writes.
- ``python -m mld_tpu_torch.eval --preset mld_humanact12 --device cpu`` on
  a tiny config in a temp root, one replication.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data import a2m as jax_a2m
from mld_tpu.eval.a2m_train import train_a2m_classifier as jax_train
from mld_tpu.eval.pipeline import Evaluator as JaxEvaluator
from mld_tpu.metrics import HUMANACTMetrics as JaxHumanAct
from mld_tpu.metrics import UESTCMetrics as JaxUestc
from mld_tpu.models import humanact12_gru as jgru
from mld_tpu.models import uestc_stgcn as jstgcn
from mld_tpu.models.mld import MLD as JaxMLD

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.eval.a2m_train import save_a2m_params, train_a2m_classifier
from mld_tpu_torch.eval.pipeline import Evaluator
from mld_tpu_torch.metrics import HUMANACTMetrics, UESTCMetrics
from mld_tpu_torch.models import humanact12_gru as tgru
from mld_tpu_torch.models import uestc_stgcn as tstgcn
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.utils.checkpoint import load_params_npz
from mld_tpu_torch.utils.convert import (flax_humanact12_to_state_dict,
                                         state_dict_to_flax_humanact12)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_ATOL = 2e-5
METRIC_RTOL = 1e-4
TINY_MODEL = {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
              "denoiser_num_layers": 3, "num_heads": 4,
              "scheduler": {"num_inference_timesteps": 5}}
TINY_EVAL = {"batch_size": 3, "diversity_times": 4, "mm_num_times": 1}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(b), 1e-12)


def jax_classifier_params(num_labels=12, seed=0):
    """The JAX HUMANACTMetrics' default weights (its PRNGKey(seed) init)."""
    model = jgru.MotionDiscriminator(output_size=num_labels)
    return _np(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 72)),
                          jnp.ones((1,), jnp.int32))["params"])


# ------------------------------------------------------------ classifiers
def test_motion_discriminator_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 20, 72).astype(np.float32)
    lengths = np.array([20, 7, 1, 20, 13])
    params = jax_classifier_params()
    model = jgru.MotionDiscriminator()
    ref_logits = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                        jnp.asarray(lengths)))
    ref_feats = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                       jnp.asarray(lengths),
                                       return_features=True))
    port = tgru.build_classifier(params, 12, "cpu")
    with torch.no_grad():
        feats, logits = port(torch.from_numpy(x), lengths)
    assert feats.shape == (5, 30) and logits.shape == (5, 12)
    np.testing.assert_allclose(feats.numpy(), ref_feats, atol=NET_ATOL)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=NET_ATOL)
    # the bridge both ways, leaf for leaf
    back = state_dict_to_flax_humanact12(port.state_dict())
    assert back.keys() == params.keys()
    for k, v in params.items():
        if isinstance(v, dict):
            for leaf in v:
                np.testing.assert_array_equal(back[k][leaf], v[leaf])
        else:
            np.testing.assert_array_equal(back[k], v)


def test_stgcn_matches_jax():
    np.testing.assert_array_equal(tstgcn.build_smpl_graph(),
                                  jstgcn.build_smpl_graph())
    np.testing.assert_array_equal(tstgcn.build_smpl_graph("uniform"),
                                  jstgcn.build_smpl_graph("uniform"))
    jnet = jstgcn.STGCN.init_random(40, seed=3)
    tnet = tstgcn.STGCN.init_random(40, seed=3)
    flat_j = jax.tree_util.tree_leaves(_np(jnet.params))
    flat_t = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), tnet.params))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    rots = np.random.RandomState(1).randn(3, 24, 6, 60).astype(np.float32)
    jf, jl = (np.asarray(a) for a in jnet(rots))
    tf, tl = (a.numpy() for a in tnet(rots))
    assert tf.shape == (3, 256) and tl.shape == (3, 40)
    np.testing.assert_allclose(tf, jf, atol=1e-4 * max(np.abs(jf).max(), 1))
    np.testing.assert_allclose(tl, jl, atol=1e-4 * max(np.abs(jl).max(), 1))


def _update_inputs(n_batches, B, T, make, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        labels = rng.randint(0, 4, B)
        out.append((labels, make(rng), make(rng), np.full(B, T)))
    return out


def _metrics_close(res, ref):
    assert res.keys() == ref.keys(), (sorted(res), sorted(ref))
    for k in ref:
        assert _close(res[k], ref[k], METRIC_RTOL), (k, res[k], ref[k])


def test_humanact_metrics_match_jax():
    params = jax_classifier_params(4)
    kw = dict(num_labels=4, diversity_times=6, multimodality_times=2)
    jm = JaxHumanAct(params=params, **kw)
    tm = HUMANACTMetrics(params=params, **kw)
    T = 12
    for labels, a, b, lengths in _update_inputs(
            4, 8, T, lambda r: r.randn(8, T, 24, 3).astype(np.float32), 0):
        jm.update(labels, a, b, lengths)
        tm.update(labels, torch.from_numpy(a), b, lengths)
    np.testing.assert_array_equal(tm.confusion, jm.confusion)
    ref = jm.compute(rng=np.random.RandomState(7))
    res = tm.compute(rng=np.random.RandomState(7))
    assert "Multimodality" in ref and "Diversity" in ref
    _metrics_close(res, ref)


def test_uestc_metrics_match_jax():
    kw = dict(num_labels=4, diversity_times=6, multimodality_times=2)
    jm = JaxUestc(jstgcn.STGCN.init_random(4), **kw)
    tm = UESTCMetrics(tstgcn.STGCN.init_random(4), **kw)
    T = 16
    for labels, a, b, lengths in _update_inputs(
            4, 8, T, lambda r: r.randn(8, 24, 6, T).astype(np.float32), 1):
        jm.update(labels, a, b, lengths)
        tm.update(labels, a, torch.from_numpy(b), lengths)
    np.testing.assert_array_equal(tm.gt_confusion, jm.gt_confusion)
    ref = jm.compute(rng=np.random.RandomState(3))
    res = tm.compute(rng=np.random.RandomState(3))
    assert "Multimodality" in ref
    _metrics_close(res, ref)


# ------------------------------------------------------------ the loaders
def test_checkpoint_loaders_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    # a humanact12_gru.tar as the reference saves it: {"model": state_dict}
    ref_net = tgru.MotionDiscriminator()
    state = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32)
                                 * 0.1)
             for k, v in ref_net.state_dict().items()}
    tar = str(tmp_path / "humanact12_gru.tar")
    torch.save({"model": state}, tar)
    jtree, ttree = (jgru.convert_humanact12_checkpoint(tar),
                    tgru.convert_humanact12_checkpoint(tar))
    assert jtree.keys() == ttree.keys()
    for k in jtree:
        a, b = jtree[k], ttree[k]
        for leaf in (a if isinstance(a, dict) else [None]):
            np.testing.assert_array_equal(
                b[leaf] if leaf else b, a[leaf] if leaf else a)
    tm = HUMANACTMetrics.from_checkpoint(tar)
    for k, v in tm.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy())

    # uestc_rot6d_stgcn.tar: the reference's module names
    net = tstgcn.STGCN.init_random(40, seed=4)
    p = jax.tree_util.tree_map(lambda t: t.numpy(), net.params)
    sd = {"data_bn.weight": p["data_bn"]["weight"] + 0.5,
          "data_bn.bias": p["data_bn"]["bias"] + 0.1,
          "data_bn.running_mean": p["data_bn"]["running_mean"] + 0.2,
          "data_bn.running_var": p["data_bn"]["running_var"] * 2,
          "fcn.weight": p["fcn"]["weight"], "fcn.bias": p["fcn"]["bias"]}
    for i, (cin, cout, stride, residual) in enumerate(tstgcn._CHANNELS):
        blk, pre = p[f"st_gcn_networks_{i}"], f"st_gcn_networks.{i}"
        sd[f"{pre}.gcn.conv.weight"] = blk["gcn"]["conv"]["weight"]
        sd[f"{pre}.gcn.conv.bias"] = blk["gcn"]["conv"]["bias"] + 0.01
        for name, key in (("tcn.0", "bn1"), ("tcn.3", "bn2")):
            for leaf, v in blk["tcn"][key].items():
                sd[f"{pre}.{name}.{leaf}"] = v + 0.05
        sd[f"{pre}.tcn.2.weight"] = blk["tcn"]["conv"]["weight"]
        sd[f"{pre}.tcn.2.bias"] = blk["tcn"]["conv"]["bias"]
        if "residual" in blk:
            sd[f"{pre}.residual.0.weight"] = blk["residual"]["conv"]["weight"]
            sd[f"{pre}.residual.0.bias"] = blk["residual"]["conv"]["bias"]
            for leaf, v in blk["residual"]["bn"].items():
                sd[f"{pre}.residual.1.{leaf}"] = v
        sd[f"edge_importance.{i}"] = rng.rand(3, 24, 24).astype(np.float32)
    tar = str(tmp_path / "uestc_rot6d_stgcn.tar")
    torch.save({"model": {k: torch.from_numpy(np.asarray(v, np.float32))
                          for k, v in sd.items()}}, tar)
    rots = rng.randn(2, 24, 6, 30).astype(np.float32)
    jf, jl = (np.asarray(a) for a in jstgcn.convert_stgcn_checkpoint(tar)(
        rots))
    tf, tl = (a.numpy() for a in tstgcn.convert_stgcn_checkpoint(tar)(rots))
    np.testing.assert_allclose(tf, jf, atol=1e-4 * max(np.abs(jf).max(), 1))
    np.testing.assert_allclose(tl, jl, atol=1e-4 * max(np.abs(jl).max(), 1))
    um = UESTCMetrics.from_checkpoint(tar, num_labels=40)
    np.testing.assert_array_equal(
        um.classifier.params["data_bn"]["weight"].numpy(),
        sd["data_bn.weight"])


def test_trainer_npz_loads_into_the_evaluator(tmp_path):
    """The trainer's npz (keys "recurrent/weight_ih_l0", "linear1/kernel",
    ...) is what the evaluator's humanact12_gru_params.npz hook reads; read
    back, its GRU leaves nest under "recurrent", which the bridge takes."""
    params = jax_classifier_params(12, seed=4)
    path = str(tmp_path / "humanact12_gru_params.npz")
    save_a2m_params(path, params)
    tree = load_params_npz(path)
    assert set(tree) == {"recurrent", "linear1", "linear2"}
    a, b = (flax_humanact12_to_state_dict(t) for t in (params, tree))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


# ------------------------------------------------------------ the protocol
def _corpus(root, preset):
    if preset == "mld_uestc":
        jax_a2m.synth_humanact12_pkl(os.path.join(root, "humanact12poses.pkl"),
                                     n_per_class=2, num_classes=40)
        os.rename(os.path.join(root, "humanact12poses.pkl"),
                  os.path.join(root, "uestc_poses.pkl"))
    else:
        # 72 clips: a test split of 8, batches of 3, 3 and a ragged 2
        jax_a2m.synth_humanact12_pkl(os.path.join(root, "humanact12poses.pkl"),
                                     n_per_class=6)


class Pair:
    """Both packages over one corpus (each in its own root), with the same
    generator weights (JAX initialises, the port loads through the bridge)
    and the same classifier weights; `spy` records each JAX batch's rng."""

    def __init__(self, tmp, preset):
        roots = [str(tmp / side) for side in ("port", "jax")]
        for r in roots:
            _corpus(r, preset)
        rec = tmp / "actionrec"
        empty = tmp / "actionrec_none"
        for d in (rec, empty):
            d.mkdir()
        # the JAX package's default classifier weights, through the npz
        # hook for the port; the JAX side draws the same from its seed
        save_a2m_params(str(rec / "humanact12_gru_params.npz"),
                        jax_classifier_params(12))

        def over(root, rec_path):
            return {"model": {**TINY_MODEL, "humanact12_rec_path": rec_path,
                              "uestc_rec_path": rec_path},
                    "dataset": {"root": root}, "eval": TINY_EVAL}

        self.cfg = load_config(preset=preset, overrides=over(roots[0],
                                                             str(rec)))
        self.jcfg = jax_load_config(preset=preset,
                                    overrides=over(roots[1], str(empty)))
        self.dm = get_datamodule(self.cfg)
        self.jdm = jax_a2m.get_a2m_datamodule(self.jcfg)
        self.jmld = JaxMLD(self.jcfg)
        self.params = self.jmld.init_params(jax.random.PRNGKey(1))
        self.tmld = MLD(self.cfg, device="cpu")
        self.tmld.load_flax_params(_np(self.params))
        self.ev = Evaluator(self.cfg, self.tmld, self.dm)
        self.jev = JaxEvaluator(self.jcfg, self.jmld, self.jdm)
        self.rngs = []
        jit = self.jev._a2m_batch_jit

        def spy(params, actions, motion, mask, rng, stage):
            self.rngs.append((rng, actions.shape[0]))
            return jit(params, actions, motion, mask, rng, stage=stage)

        self.jev._a2m_batch_jit = spy

    def draws(self, stage):
        out = []
        for srng, rows in self.rngs:
            if stage == "vae":
                eps = jax.random.normal(srng, (rows, 1, 32))
                out.append({"eps": torch.from_numpy(np.asarray(eps).copy())})
            else:
                _, init_rng = jax.random.split(srng)
                init = self.jmld._init_latents(init_rng, rows, None)
                out.append({"init_latents": torch.from_numpy(
                    np.asarray(init).copy())})
        return out

    def run(self, stage):
        self.rngs.clear()
        jb = list(self.jdm.loader("test", shuffle=False))
        tb = list(self.dm.loader("test", shuffle=False))
        assert [len(b["action"]) for b in tb] == [len(b["action"])
                                                  for b in jb]
        jres = self.jev.run_split_a2m(self.params, jb, jax.random.PRNGKey(7),
                                      stage=stage,
                                      compute_rng=np.random.RandomState(0))
        sunk = []
        tres = self.ev.run_split_a2m(
            tb, stage=stage, draws=self.draws(stage),
            compute_rng=np.random.RandomState(0),
            prediction_sink=lambda j, n: sunk.append((j.shape, list(n))))
        return jres, tres, tb, sunk


@pytest.fixture(scope="module", params=["mld_humanact12", "mld_uestc"])
def pair(request, tmp_path_factory):
    return Pair(tmp_path_factory.mktemp(request.param), request.param)


@pytest.mark.parametrize("stage", ["diffusion", "vae"])
def test_run_split_a2m_matches_jax(pair, stage):
    jres, tres, batches, sunk = pair.run(stage)
    sizes = [len(b["action"]) for b in batches]
    assert len(sizes) > 1 and sizes[-1] < pair.cfg.eval.batch_size
    assert [s[0][0] for s in sunk] == sizes      # padding sliced off
    assert all(s[0][1:] == (60, 24, 3) for s in sunk)
    assert all(np.isfinite(v) for v in tres.values())
    for k in ("accuracy", "gt_accuracy", "FID", "Diversity"):
        assert k in tres, k
    _metrics_close(tres, jres)


def test_run_is_replications_of_the_split(pair):
    res = pair.ev.run(torch.Generator().manual_seed(0), replication_times=2)
    for k in ("accuracy", "gt_accuracy", "FID", "Diversity"):
        assert np.isfinite(res[k]) and np.isfinite(res[f"{k}/conf95"]), k
    assert len(pair.ev.times["a2m"]) >= 2 * 3


def test_train_classifier_matches_jax(tmp_path):
    roots = [str(tmp_path / s) for s in ("port", "jax")]
    for r in roots:
        jax_a2m.synth_humanact12_pkl(os.path.join(r, "humanact12poses.pkl"),
                                     n_per_class=3)
    over = lambda r: {"model": TINY_MODEL, "dataset": {"root": r},
                      "train": {"batch_size": 8}}
    cfg = load_config(preset="mld_humanact12", overrides=over(roots[0]))
    jcfg = jax_load_config(preset="mld_humanact12", overrides=over(roots[1]))
    # optax's schedule needs more steps than its 20 of warm-up
    jparams, jrep = jax_train(jcfg, jax_a2m.get_a2m_datamodule(jcfg),
                              JaxMLD(jcfg), steps=22, lr=1e-3, seed=2,
                              log_every=0)
    params, rep = train_a2m_classifier(
        cfg, get_datamodule(cfg), MLD(cfg, device="cpu"), steps=22, lr=1e-3,
        seed=2, log_every=0, params=jax_classifier_params(12, seed=2))
    assert rep["steps"] == jrep["steps"] == 22
    for k in ("loss_first", "loss_last", "train_acc_last"):
        assert abs(rep[k] - jrep[k]) <= 1e-5 * max(abs(jrep[k]), 1), k
    a, b = (flax_humanact12_to_state_dict(t) for t in (params, _np(jparams)))
    for k in b:
        scale = max(float(b[k].abs().max()), 1e-6)
        err = float((a[k] - b[k]).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)


def test_eval_cli_on_the_cpu(tmp_path):
    root = tmp_path / "data"
    jax_a2m.synth_humanact12_pkl(str(root / "humanact12poses.pkl"),
                                 n_per_class=4)
    cfg = tmp_path / "tiny.json"
    # a YAML file; JSON is a subset of YAML
    cfg.write_text(json.dumps({
        "name": "a2m_cli", "model": {**TINY_MODEL,
                                     "humanact12_rec_path": str(tmp_path)},
        "dataset": {"root": str(root)}, "eval": TINY_EVAL,
        "logger": {"folder": str(tmp_path)}}))
    out = tmp_path / "metrics.json"
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "mld_tpu_torch.eval", "--preset",
         "mld_humanact12", "--cfg", str(cfg), "--device", "cpu",
         "--replication", "1", "--gt", "--out", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        res = json.load(f)
    for k in ("accuracy", "gt_accuracy", "FID", "Diversity"):
        assert np.isfinite(res[k]) and res[f"{k}/conf95"] == 0.0, k
    assert not any(k.startswith("gt_only/") for k in res)
    assert "flag ignored" in proc.stdout
