"""Data parallelism in the port on the CPU: the data-parallel step, the
sharded evaluation, the metric gather and the train CLI's flags.

Two gloo ranks are spawned once (``tests/_torch_ddp_ranks.py``: the ranks
import only the port) on a free port of this host, run every case the
parent wrote and save what they saw; the parametrised cases below read it.
JAX's side runs here, on the 8 virtual CPU devices of tests/conftest.py:
``make_train_step`` on ``make_mesh(num_data=2)`` with the port model's
weights, the same batch and its draws replayed into the port
(``tests/test_torch_train.py:jax_draws``). The tiny config of
tests/test_torch_train.py, dropout 0, B=8 (B=7 plus one ghost row).

Bars: each log within 2e-4 relative and each parameter after the step
within 2e-4 (JAX's data-parallel bars, tests/test_parallel.py:69-75) of
JAX's mesh step and of the port's single-process step; the ranks'
reduced gradients within 1e-4 of each leaf's largest |g| of the
single-process step's (tests/test_torch_train.py's bar: f32 over two
summation orders), and every rank's parameters bit-identical after the
step. The sharded run_split's metrics within 1e-6 relative of the
unsharded pass's (FID's sqrtm is in float64).
"""
import json
import os
import runpy
import sys

import numpy as np
import pytest
import jax
import torch
import yaml

import mld_tpu  # noqa: F401
from mld_tpu.config import config_to_dict as jax_config_to_dict
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.parallel.mesh import (make_mesh, pad_batch_to_devices,
                                   replicate_tree, shard_batch)
from mld_tpu.train import steps as jsteps

from mld_tpu_torch.config import config_to_dict, load_config
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.data.synthetic import build_synthetic_dataset
from mld_tpu_torch.eval.pipeline import Evaluator, T2MEvaluatorBundle
from mld_tpu_torch.models.clip_text import ClipTokenizer
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.parallel import ddp
from mld_tpu_torch.parallel.multihost import make_metric_sync
from mld_tpu_torch.train import __main__ as cli
from mld_tpu_torch.train import loop, steps
from mld_tpu_torch.utils.checkpoint import CheckpointManager

import _torch_ddp_ranks
from _torch_ddp_ranks import NoiseSpy
from test_torch_train import jax_draws, jax_params_of, tiny_over, torch_named

TRAIN_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "train.py")
LOG_RTOL = 2e-4
PARAM_ATOL = 2e-4
GRAD_RTOL = 1e-4
METRIC_RTOL = 1e-6
WORLD = 2
EVAL = {"batch_size": 8, "diversity_times": 4, "r_size": 4,
        "mm_num_samples": 2, "mm_num_repeats": 4, "mm_num_times": 2}
# (stage, real rows of the global batch)
TRAIN_CASES = {"diffusion": ("diffusion", 8), "vae": ("vae", 8),
               "diffusion_ghost": ("diffusion", 7), "vae_ghost": ("vae", 7)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_torch_ddp"))
    build_synthetic_dataset(root, n_samples=64, seed=0)
    return root


def _over(root, stage, dropout=0.0):
    over = tiny_over(root, stage, dropout=dropout)
    over["dataset"]["native_loader"] = True
    return over


def _cfg(over):
    return load_config(preset="mld_humanml3d", overrides=over)


def _model(cfg, dm):
    return MLD(cfg, mean=dm.mean, std=dm.std, mean_eval=dm.mean_eval,
               std_eval=dm.std_eval, device="cpu",
               generator=torch.Generator().manual_seed(0))


class Inputs:
    """The cases both sides run: the port model, the global batches and
    JAX's draws, and the evaluation's model and evaluator weights."""

    def __init__(self, root):
        self.root = root
        over = _over(root, "diffusion")
        self.cfg = _cfg(over)
        self.dm = get_datamodule(self.cfg,
                                 tokenizer=ClipTokenizer(self.cfg.model.clip_path))
        self.tmld = _model(self.cfg, self.dm)
        self.state = {k: v.clone() for k, v in self.tmld.state_dict().items()}
        full = next(iter(self.dm.loader("train", batch_size=8, prefetch=0,
                                        drop_last=True)))
        keys = ("motion", "mask", "text_ids")
        self.batches = {n: {k: np.asarray(full[k])[:n] for k in keys}
                        for n in (7, 8)}
        self.jmld = JaxMLD(jax_load_config(preset="mld_humanml3d",
                                           overrides=over),
                           mean=self.dm.mean, std=self.dm.std)
        self.params = jax_params_of(self.tmld)
        self.rng = jax.random.PRNGKey(7)
        self.stats = dict(mean=self.dm.mean, std=self.dm.std,
                          mean_eval=self.dm.mean_eval,
                          std_eval=self.dm.std_eval)
        self.over = {}
        self.draws = {}
        for name, (stage, n) in TRAIN_CASES.items():
            self.over[name] = _over(root, stage)
            self.draws[name] = jax_draws(self.jmld, stage, self.rng,
                                         self.padded(n))
        self.eval_over = {**_over(root, "diffusion"), "eval": EVAL}
        # the joint stage with an ancestral sampler in its generation pass:
        # every draw of the step made from the generator
        self.ddpm_over = _over(root, "vae_diffusion")
        self.ddpm_over["model"]["scheduler"] = {"kind": "ddpm",
                                                "num_train_timesteps": 20}
        self.t2m = T2MEvaluatorBundle(_cfg(self.eval_over), device="cpu",
                                      seed=3).params_tree()

    def padded(self, n):
        """The global batch of n rows padded to the ranks, as JAX pads it
        (``pad_batch_to_devices``), with row_valid."""
        jb = dict(self.batches[n], row_valid=np.ones(n, bool))
        return pad_batch_to_devices(jb, make_mesh(num_data=WORLD))

    def case(self, over, **kw):
        return {"over": over, "state": self.state, **self.stats, **kw}

    def write(self, path):
        train = {name: self.case(self.over[name], stage=stage,
                                 batch=self.batches[n],
                                 draws=self.draws[name])
                 for name, (stage, n) in TRAIN_CASES.items()}
        train["dropout"] = self.case(
            _over(self.root, "diffusion", dropout=0.1), stage="diffusion",
            batch=self.batches[8], seed=11, own_dropout=True)
        train["drawn"] = self.case(self.ddpm_over, stage="vae_diffusion",
                                   batch=self.batches[7], seed=5)
        torch.save({"train": train,
                    "eval": self.case(self.eval_over, t2m=self.t2m)}, path)


@pytest.fixture(scope="module")
def inputs(root):
    return Inputs(root)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each rank's results of the two-rank run."""
    d = tmp_path_factory.mktemp("ddp_ranks")
    inputs.write(str(d / "inputs.pt"))
    ddp.spawn(_rank_run(), ["cpu"] * WORLD, str(d / "inputs.pt"))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _rank_run():
    return _torch_ddp_ranks.run


def _jax_mesh_step(inputs, stage, jbatch):
    jmld = inputs.jmld
    state = jsteps.create_train_state(jmld, inputs.params, stage)
    mesh = make_mesh(num_data=WORLD)
    state = state.replace(params=replicate_tree(state.params, mesh),
                          frozen=replicate_tree(state.frozen, mesh),
                          opt_state=replicate_tree(state.opt_state, mesh))
    step = jsteps.make_train_step(jmld, stage, donate=False)
    new, logs = step(state, shard_batch(jbatch, mesh), inputs.rng)
    return ({k: float(v) for k, v in logs.items()},
            torch_named(jax.device_get(new.params)))


def _port_step(inputs, over, stage, batch, draws=None, seed=None):
    """The port's single-process step on the whole (padded) batch."""
    cfg = _cfg(over)
    mld = _model(cfg, inputs.dm)
    mld.load_state_dict(inputs.state)
    state = steps.create_train_state(mld, stage)
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    noise = []
    mld.noise_scheduler = NoiseSpy(mld.noise_scheduler, noise)
    logs, grads = steps.compute_grads(
        state, steps.batch_to_device(batch, "cpu"), gen, draws)
    grads = {k: g.clone() for k, g in grads.items()}
    steps.apply_grads(state, logs["grad_norm"])
    return ({k: float(v) for k, v in logs.items()}, grads,
            {k: p.detach().clone() for k, p in state.params.items()}, noise)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_two_rank_step_equals_jax_mesh_and_single_process(inputs, ranks,
                                                          name):
    stage, n = TRAIN_CASES[name]
    jbatch = inputs.padded(n)
    jlogs, jparams = _jax_mesh_step(inputs, stage, jbatch)
    slogs, sgrads, sparams, _ = _port_step(inputs, inputs.over[name], stage,
                                           jbatch, inputs.draws[name])
    r0, r1 = (r["train"][name] for r in ranks)
    assert r0["shard"] == (0, 4, 8, n) and r1["shard"] == (4, 8, 8, n)
    assert set(r0["logs"]) == set(jlogs) == set(slogs)
    for k, v in jlogs.items():
        for got in (r0["logs"][k], r1["logs"][k], slogs[k]):
            assert abs(got - v) <= LOG_RTOL * max(abs(v), 1e-6), (k, got, v)
    for k, g in sgrads.items():
        scale = max(float(g.abs().max()), 1e-6)
        err = float((r0["grads"][k] - g).abs().max())
        assert err <= GRAD_RTOL * scale, (k, err, scale)
    assert set(r0["params"]) == set(jparams) == set(sparams)
    for k, p in r0["params"].items():
        assert torch.equal(p, r1["params"][k]), k
        np.testing.assert_allclose(p.numpy(), jparams[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(p.numpy(), sparams[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_two_rank_step_draws_for_the_global_batch(inputs, ranks):
    """vae_diffusion with its draws from the step's generator (the VAE's
    eps, the CFG drop, the noise, the timesteps, the generation pass's
    initial latents and, DDPM, its per-step noise), B=7 and a ghost row:
    the ranks draw for the global batch and keep their rows, so the step
    is the single-process step with the same seed."""
    slogs, sgrads, sparams, _ = _port_step(
        inputs, inputs.ddpm_over, "vae_diffusion", inputs.padded(7), seed=5)
    r0, r1 = (r["train"]["drawn"] for r in ranks)
    for k, v in slogs.items():
        for got in (r0["logs"][k], r1["logs"][k]):
            assert abs(got - v) <= LOG_RTOL * max(abs(v), 1e-6), (k, got, v)
    for k, g in sgrads.items():
        scale = max(float(g.abs().max()), 1e-6)
        err = float((r0["grads"][k] - g).abs().max())
        assert err <= GRAD_RTOL * scale, (k, err, scale)
    for k, p in r0["params"].items():
        assert torch.equal(p, r1["params"][k]), k
        np.testing.assert_allclose(p.numpy(), sparams[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_ranks_draw_their_rows_and_their_own_dropout(inputs, ranks):
    """Dropout 0.1: each rank's noise and timesteps are its rows of the
    single-process step's (the same generator seed), so the ranks' rows
    differ; each rank's dropout masks come from its own generator, so they
    differ too (equal masks and noise on every rank is the bug of ranks
    drawing their shard's shape from one seed)."""
    r0, r1 = (r["train"]["dropout"] for r in ranks)
    *_, noise = _port_step(inputs, _over(inputs.root, "diffusion", 0.1),
                           "diffusion", inputs.batches[8], seed=11)
    (n_all, t_all), = noise
    for r, rows in ((r0, slice(0, 4)), (r1, slice(4, 8))):
        (n, t), = r["noise"]
        assert torch.equal(n, n_all[rows]) and torch.equal(t, t_all[rows])
    assert not torch.equal(r0["noise"][0][0], r1["noise"][0][0])
    assert len(r0["masks"]) == len(r1["masks"]) > 0
    for a, b in zip(r0["masks"], r1["masks"]):
        assert a.shape == b.shape and not torch.equal(a, b)
    for k, p in r0["params"].items():
        assert torch.equal(p, r1["params"][k]), k


@pytest.mark.parametrize("mm", [False, True], ids=["main", "mm"])
def test_sharded_run_split_equals_unsharded(inputs, ranks, mm):
    cfg = _cfg(inputs.eval_over)
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    mld = _model(cfg, dm)
    mld.load_state_dict(inputs.state)
    ev = Evaluator(cfg, mld, dm, t2m_params=inputs.t2m)
    if mm:
        # the main pass first: the dataset's RNG then stands where the
        # ranks' stood for their MultiModality pass
        ev.run_split(dm.loader("test", shuffle=False,
                               batch_size=cfg.eval.batch_size),
                     generator=torch.Generator().manual_seed(5),
                     compute_rng=np.random.RandomState(0))
        dm.mm_mode(True, cfg.eval.mm_num_samples,
                   rng=np.random.RandomState(0))
    want = ev.run_split(dm.loader("test", shuffle=False,
                                  batch_size=cfg.eval.batch_size),
                        mm=mm, generator=torch.Generator().manual_seed(5),
                        compute_rng=np.random.RandomState(0))
    for r in ranks:
        got = r["eval"]["mm" if mm else "main"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= METRIC_RTOL * max(abs(v), 1e-12), (
                k, got[k], v)


def test_metric_sync_gathers_in_rank_order(ranks):
    cache = [np.full((1 + i, 3), 10 * r + i, np.float32)
             for r in range(WORLD) for i in range(2)]
    want = np.concatenate(cache)
    for r in ranks:
        got, = r["sync"]["cache"]
        np.testing.assert_array_equal(got, want)
        empty, = r["sync"]["empty"]
        np.testing.assert_array_equal(empty, cache[0])
    # one rank (no process group): the identity
    sync = make_metric_sync()
    assert sync(cache) is cache


# -------------------------------------------------------------------- CLI
def _jax_cli_cfg(monkeypatch, argv):
    """The config JAX's train.py builds from argv (its train() caught)."""
    import mld_tpu.train.loop as jloop
    seen = {}
    monkeypatch.setattr(jloop, "train",
                        lambda cfg, **kw: seen.setdefault("cfg", cfg))
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    runpy.run_path(TRAIN_PY, run_name="__main__")
    return jax_config_to_dict(seen["cfg"])


def _assets(tmp_path):
    path = tmp_path / "assets.yaml"
    path.write_text(yaml.safe_dump({
        "train": {"pretrained_vae": "checkpoints/vae", "batch_size": 16},
        "dataset": {"root": "datasets/somewhere"},
        "model": {"t2m_path": "deps/t2m"}}))
    return str(path)


def test_cli_merges_cfg_assets_as_jax_does(monkeypatch, tmp_path):
    argv = ["--cfg_assets", _assets(tmp_path), "--batch_size", "12",
            "--stage", "diffusion"]
    seen = {}
    monkeypatch.setattr(loop, "train",
                        lambda cfg, **kw: seen.update(cfg=cfg, kw=kw))
    cli.main(argv + ["--device", "cpu"])
    got = config_to_dict(seen["cfg"])
    assert got == _jax_cli_cfg(monkeypatch, argv)
    assert got["train"]["pretrained_vae"] == "checkpoints/vae"
    assert got["train"]["batch_size"] == 12
    assert seen["kw"]["device"] == "cpu"


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_cli_device_ids_set_data_parallel(monkeypatch, tmp_path):
    _cards(monkeypatch, 2)
    seen = {}
    monkeypatch.setattr(ddp, "spawn", lambda fn, devices, cfg, **kw:
                        seen.update(fn=fn, devices=devices, cfg=cfg))
    argv = ["--cfg_assets", _assets(tmp_path), "--device", "0", "1"]
    assert cli.main(argv) is None
    assert seen["fn"] is loop.train
    assert seen["devices"] == ["cuda:0", "cuda:1"]
    assert seen["cfg"].train.data_parallel == 2
    assert config_to_dict(seen["cfg"]) == _jax_cli_cfg(monkeypatch, argv)


@pytest.mark.parametrize("cards, argv", [
    (0, ["--device", "0"]), (1, ["--device", "0", "1"]),
    (1, ["--device", "1"]), (2, ["--device", "0", "0"]),
    (0, ["--device", "cuda"])])
def test_cli_refuses_more_cuda_ranks_than_cards(monkeypatch, cards, argv):
    _cards(monkeypatch, cards)
    monkeypatch.setattr(loop, "train", lambda *a, **k: pytest.fail("ran"))
    monkeypatch.setattr(ddp, "spawn", lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)


def test_cli_refuses_cuda_data_parallel_past_the_cards(monkeypatch,
                                                       tmp_path):
    _cards(monkeypatch, 1)
    over = tmp_path / "dp.yaml"
    over.write_text(yaml.safe_dump({"train": {"data_parallel": 2}}))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--cfg_assets", str(over), "--device", "cuda"])


def test_cli_joins_a_torchrun_group(monkeypatch):
    """RANK / WORLD_SIZE / LOCAL_RANK set: this process is torchrun's rank,
    in the group the environment names (here one gloo rank)."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(ddp.free_port())}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(loop, "train", lambda cfg, device, **kw: seen.update(
        device=device, world=ddp.world_size(),
        backend=torch.distributed.get_backend()))
    monkeypatch.setattr(ddp, "spawn", lambda *a, **k: pytest.fail("spawned"))
    cli.main(["--device", "cpu"])
    assert seen == {"device": torch.device("cpu"), "world": 1,
                    "backend": "gloo"}
    assert not ddp.is_initialized()


def _tiny_yaml(tmp_path, root, name, **train):
    path = tmp_path / f"{name}.yaml"
    over = _over(root, "vae")
    over["train"].update(train)
    over["name"] = name
    over["logger"] = {"folder": str(tmp_path / "exp"), "val_every_epochs": 1}
    path.write_text(yaml.safe_dump(over))
    return str(path)


@pytest.mark.parametrize("ranks_", [1, 2])
def test_cli_trains_on_the_cpu(root, tmp_path, ranks_, capfd):
    """One rank in this process (a group of one), or two gloo ranks; the
    checkpoint, the metrics and the validation loss written once, by rank
    0."""
    cfg = _tiny_yaml(tmp_path, root, f"cli_ddp{ranks_}")
    assets = tmp_path / "assets.yaml"
    assets.write_text(yaml.safe_dump({"train": {"data_parallel": ranks_}}))
    out = cli.main(["--cfg", cfg, "--cfg_assets", str(assets), "--device",
                    "cpu", "--max_steps", "2"])
    assert (out is None) == (ranks_ > 1)
    assert not ddp.is_initialized()
    exp = tmp_path / "exp" / "mld" / f"cli_ddp{ranks_}"
    assert CheckpointManager(str(exp / "checkpoints")).steps() == [1]
    with open(exp / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["split"] for r in lines] == ["train", "val"]
    assert np.isfinite(lines[0]["total"])
    logs = capfd.readouterr()
    assert f"ranks={ranks_}" in logs.out + logs.err
    assert "collator: NativeMldCollator" in logs.out + logs.err


def test_train_refuses_data_parallel_without_ranks(root, tmp_path):
    cfg = load_config(_tiny_yaml(tmp_path, root, "no_ranks",
                                 data_parallel=2), preset="mld_humanml3d")
    with pytest.raises(ValueError, match="data_parallel=2"):
        loop.train(cfg, max_steps=1, device="cpu")
