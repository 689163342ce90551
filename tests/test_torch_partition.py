"""The model-axis layout in the port (``parallel/partition.py``) on the
CPU.

``param_spec`` is held to JAX's decision for every leaf of a tiny model,
mapped by name. Four gloo ranks (2 data x 2 model: each model rank keeps
its heads' QKV rows and half the FFN, ``tests/_torch_partition_ranks.py``)
run one diffusion step of the tiny config of tests/test_torch_train.py,
dropout 0, B=8, JAX's draws replayed, against the port's single-process
step; that step is held against JAX's step on a 4 x 2 (data x model) mesh
of the 8 virtual CPU devices of tests/conftest.py with the train state's
params placed by JAX's ``shard_params`` (tests/test_parallel.py:34-75's
set-up). Bars: loss within 2e-4 relative and every parameter after the
step within 2e-4 (tests/test_parallel.py:69-75); grad_norm within 2e-4
relative and each leaf's reassembled gradient within 1e-4 of its largest
|g| (the parameter bar alone is 2 x lr and cannot see a wrong reduction).
With dropout 0.1 the residual stream (each encoder layer's output) is
bit-identical across the two model ranks of a data group.
"""
import numpy as np
import pytest
import jax
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.parallel.mesh import make_mesh, replicate_tree, shard_batch
from mld_tpu.parallel.partition import param_spec as jax_param_spec
from mld_tpu.parallel.partition import shard_params as jax_shard_params
from mld_tpu.train import steps as jsteps
from jax.sharding import PartitionSpec as P

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.data.synthetic import build_synthetic_dataset
from mld_tpu_torch.models.clip_text import ClipTokenizer
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.parallel import ddp, partition
from mld_tpu_torch.train import steps
from mld_tpu_torch.utils.convert import state_dict_to_flax

import _torch_partition_ranks
from test_torch_train import jax_draws, jax_params_of, tiny_over, torch_named

LOSS_RTOL = 2e-4
PARAM_ATOL = 2e-4
NORM_RTOL = 2e-4
GRAD_RTOL = 1e-4
DATA, MODEL = 2, 2
B = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Inputs:
    """The port model, a batch of 8 and JAX's draws for it."""

    def __init__(self, root):
        self.over = {d: tiny_over(root, "diffusion", dropout=d)
                     for d in (0.0, 0.1)}
        self.cfg = load_config(preset="mld_humanml3d",
                               overrides=self.over[0.0])
        self.dm = get_datamodule(self.cfg, tokenizer=ClipTokenizer(
            self.cfg.model.clip_path))
        self.stats = dict(mean=self.dm.mean, std=self.dm.std,
                          mean_eval=self.dm.mean_eval,
                          std_eval=self.dm.std_eval)
        self.tmld = self.model(self.cfg)
        self.state = {k: v.clone() for k, v in self.tmld.state_dict().items()}
        full = next(iter(self.dm.loader("train", batch_size=B, prefetch=0,
                                        drop_last=True)))
        self.batch = {k: np.asarray(full[k])
                      for k in ("motion", "mask", "text_ids")}
        self.jmld = JaxMLD(jax_load_config(preset="mld_humanml3d",
                                           overrides=self.over[0.0]),
                           mean=self.dm.mean, std=self.dm.std)
        self.params = jax_params_of(self.tmld)
        self.rng = jax.random.PRNGKey(7)
        self.draws = jax_draws(self.jmld, "diffusion", self.rng,
                               dict(self.batch, row_valid=np.ones(B, bool)))

    def model(self, cfg):
        return MLD(cfg, **self.stats, device="cpu",
                   generator=torch.Generator().manual_seed(0))

    def case(self, dropout, **kw):
        return {"over": self.over[dropout], "state": self.state,
                "batch": self.batch, **self.stats, **kw}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_partition"))
    build_synthetic_dataset(root, n_samples=64, seed=0)
    return Inputs(root)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("partition_ranks")
    torch.save({"data": DATA, "model": MODEL, "cases": {
        "plain": inputs.case(0.0, draws=inputs.draws),
        "dropout": inputs.case(0.1, draws=inputs.draws, seed=11,
                               own_dropout=True)}},
        str(d / "inputs.pt"))
    ddp.spawn(_torch_partition_ranks.run, ["cpu"] * (DATA * MODEL),
              str(d / "inputs.pt"))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(DATA * MODEL)]


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process step on the whole batch, dropout 0."""
    mld = inputs.model(inputs.cfg)
    mld.load_state_dict(inputs.state)
    state = steps.create_train_state(mld, "diffusion")
    logs, grads = steps.compute_grads(
        state, steps.batch_to_device(inputs.batch, "cpu"), None,
        inputs.draws)
    grads = {k: g.clone() for k, g in grads.items()}
    steps.apply_grads(state, logs["grad_norm"])
    return ({k: float(v) for k, v in logs.items()}, grads,
            {k: p.detach().clone() for k, p in state.params.items()})


# --------------------------------------------------------------- the layout
def _jax_path(name, tensor):
    """The JAX param tree path (and leaf) of one torch-named parameter."""
    tree = state_dict_to_flax({name: tensor})
    path = []
    while isinstance(tree, dict):
        (k, tree), = tree.items()
        path.append(k)
    return path, tree


SPECS = {P(): None, P(None, "model"): partition.COLUMN,
         P("model", None): partition.ROW}


@pytest.mark.parametrize("top", ["vae", "denoiser", "clip"])
def test_param_spec_is_jaxs(inputs, top):
    seen = set()
    for name, t in inputs.tmld.state_dict().items():
        if not name.startswith(top + "."):
            continue
        path, leaf = _jax_path(name, t)
        want = SPECS[jax_param_spec(path, leaf)]
        assert partition.param_spec(name, t) == want, (name, path)
        seen.add(want)
    # each top holds split leaves (the tower's q/k/v are unpacked: replicated,
    # its out_proj and FFN split)
    assert {partition.COLUMN, partition.ROW} <= seen


def test_sharded_denoiser_takes_the_module_path(inputs, single):
    """A model axis of one rank: the same step as without one, and K1 never
    serves the sharded denoiser (it reads whole weights)."""
    mld = inputs.model(inputs.cfg)
    mld.load_state_dict(inputs.state)
    assert mld.denoiser.fusable
    axis = partition.ModelAxis(1, 1, 0, 0, None, None)
    partition.shard_params(mld, axis)
    assert not mld.denoiser.fusable and not mld.use_fused_denoiser()
    with pytest.raises(ValueError):
        mld.denoiser.fused_forward(torch.zeros(2, 1, 32), 3,
                                   torch.zeros(2, 1, 32))
    kinds = {getattr(p, "model_shard", None)
             for p in mld.denoiser.parameters()}
    assert kinds == {None, partition.QKV, partition.COLUMN, partition.ROW}
    state = steps.create_train_state(mld, "diffusion")
    logs, grads = steps.compute_grads(
        state, steps.batch_to_device(inputs.batch, "cpu"), None,
        inputs.draws)
    slogs, sgrads, _ = single
    for k, v in slogs.items():
        assert abs(float(logs[k]) - v) <= 1e-6 * max(abs(v), 1e-6), k
    for k, g in sgrads.items():
        assert float((grads[k] - g).abs().max()) <= 1e-6 * max(
            float(g.abs().max()), 1e-6), k


@pytest.mark.parametrize("stage", ["vae", "vae_diffusion"])
def test_model_axis_refuses_a_stage_training_the_vae(inputs, stage):
    """shard_params shards the denoiser, the diffusion stage's trainable
    set; a stage that trains the VAE under the axis would leave it whole,
    so its train state is refused."""
    mld = inputs.model(inputs.cfg)
    partition.shard_params(mld, partition.ModelAxis(1, 1, 0, 0, None, None))
    assert not any(hasattr(p, "model_shard") for p in mld.vae.parameters())
    with pytest.raises(NotImplementedError, match="denoiser only"):
        steps.create_train_state(mld, stage)


# ------------------------------------------------------------------- ranks
def test_model_axis_step_equals_single_process(ranks, single):
    slogs, sgrads, sparams = single
    places = sorted(r["plain"]["place"] for r in ranks)
    assert places == [(d, m) for d in range(DATA) for m in range(MODEL)]
    kinds = ranks[0]["plain"]["kinds"]
    assert set(v for v in kinds.values() if v) == {
        partition.QKV, partition.COLUMN, partition.ROW}
    for r in ranks:
        got = r["plain"]
        for k in ("total", "grad_norm"):
            v = slogs[k]
            rtol = LOSS_RTOL if k == "total" else NORM_RTOL
            assert abs(got["logs"][k] - v) <= rtol * max(abs(v), 1e-6), (
                k, got["logs"][k], v)
        for k, g in sgrads.items():
            scale = max(float(g.abs().max()), 1e-6)
            err = float((got["grads"][k] - g).abs().max())
            assert err <= GRAD_RTOL * scale, (k, err, scale)
        for k, p in sparams.items():
            np.testing.assert_allclose(got["params"][k].numpy(), p.numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=k)
            assert torch.equal(got["params"][k], ranks[0]["plain"]["params"][k])


def test_single_process_step_equals_jax_4x2_mesh(inputs, single):
    jmld = inputs.jmld
    state = jsteps.create_train_state(jmld, inputs.params, "diffusion")
    mesh = make_mesh(num_data=4, num_model=2)
    jbatch = dict(inputs.batch)
    with mesh:
        state = state.replace(params=jax_shard_params(state.params, mesh),
                              frozen=replicate_tree(state.frozen, mesh))
        step = jsteps.make_train_step(jmld, "diffusion", donate=False)
        new, logs = step(state, shard_batch(jbatch, mesh), inputs.rng)
    jlogs = {k: float(v) for k, v in logs.items()}
    jparams = torch_named(jax.device_get(new.params))
    slogs, _, sparams = single
    for k in ("total", "grad_norm"):
        assert abs(slogs[k] - jlogs[k]) <= LOSS_RTOL * max(abs(jlogs[k]),
                                                           1e-6), k
    assert set(sparams) == set(jparams)
    for k, p in sparams.items():
        np.testing.assert_allclose(p.numpy(), jparams[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_dropout_keeps_the_residual_stream_replicated(ranks):
    by_place = {r["dropout"]["place"]: r["dropout"] for r in ranks}
    plain = {r["plain"]["place"]: r["plain"] for r in ranks}
    for d in range(DATA):
        a, b = by_place[(d, 0)], by_place[(d, 1)]
        assert len(a["acts"]) == len(b["acts"]) == 3
        for x, y in zip(a["acts"], b["acts"]):
            assert torch.equal(x, y)
        assert a["logs"] == b["logs"]
        # the masks were drawn: dropout moved the loss
        assert a["logs"]["total"] != plain[(d, 0)]["logs"]["total"]
    # the data ranks hold other rows and draw other masks
    assert not torch.equal(by_place[(0, 0)]["acts"][0],
                           by_place[(1, 0)]["acts"][0])
    for k, p in by_place[(0, 0)]["params"].items():
        assert torch.equal(p, by_place[(1, 1)]["params"][k]), k


def test_axis_generators_are_keyed_by_data_and_model_rank():
    gens = {(d, m): partition.axis_generators(
        3, partition.ModelAxis(2, 2, d, m, None, None), "cpu")
        for d in range(2) for m in range(2)}

    def draw(g):
        return torch.rand(8, generator=g)

    for d in range(2):
        assert torch.equal(draw(gens[(d, 0)].replicated),
                           draw(gens[(d, 1)].replicated))
        assert not torch.equal(draw(gens[(d, 0)].sharded),
                               draw(gens[(d, 1)].sharded))
    assert not torch.equal(draw(gens[(0, 0)].replicated),
                           draw(gens[(1, 0)].replicated))
