"""The ranks of tests/test_torch_ddp.py: each runs, in a process group of
two gloo ranks on the CPU, the cases the parent wrote into an inputs file
and saves what it saw to ``rank<r>.pt`` beside it. Imports only the port
(and torch, numpy), never JAX: a rank is what a user's rank runs."""
import os

import numpy as np
import torch

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.eval.pipeline import Evaluator
from mld_tpu_torch.models.clip_text import ClipTokenizer
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.ops import attention, embeddings, transformer
from mld_tpu_torch.parallel import ddp
from mld_tpu_torch.parallel.multihost import make_metric_sync
from mld_tpu_torch.train import steps


def model_of(case, device="cpu"):
    cfg = load_config(preset="mld_humanml3d", overrides=case["over"])
    mld = MLD(cfg, mean=case["mean"], std=case["std"],
              mean_eval=case["mean_eval"], std_eval=case["std_eval"],
              device=device, generator=torch.Generator().manual_seed(0))
    mld.load_state_dict(case["state"])
    return cfg, mld


class NoiseSpy:
    """A noise scheduler that records the (noise, t) of each add_noise."""

    def __init__(self, scheduler, record):
        self.scheduler, self.record = scheduler, record

    def __getattr__(self, name):
        return getattr(self.scheduler, name)

    def add_noise(self, z, noise, t):
        self.record.append((noise.clone(), t.clone()))
        return self.scheduler.add_noise(z, noise, t)


class Spy:
    """Records each dropout's dropped positions and the noise and
    timesteps the diffusion loss adds (``add_noise``)."""

    MODULES = ((transformer, "_dropout"), (embeddings, "_dropout"),
               (attention, "dropout"))

    def __init__(self, mld):
        self.masks, self.noise = [], []
        self.saved = [(m, n, getattr(m, n)) for m, n in self.MODULES]
        for module, name, fn in self.saved:
            setattr(module, name, self._recording(fn))
        mld.noise_scheduler = NoiseSpy(mld.noise_scheduler, self.noise)

    def _recording(self, fn):
        def dropout(x, rate, generator):
            out = fn(x, rate, generator)
            if generator is not None and rate > 0.0:
                self.masks.append((out == 0).clone())
            return out
        return dropout

    def close(self):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def train_case(case, rank, world):
    """One optimizer step on this rank's rows of the case's global batch
    (padded to the ranks), with the global draws replayed or drawn from
    the case's seeded generator."""
    cfg, mld = model_of(case)
    ddp.broadcast_module(mld)
    state = steps.create_train_state(mld, case["stage"])
    batch = ddp.pad_batch_to_ranks(case["batch"], world)
    dropout = (ddp.rank_generator(case["seed"], rank, "cpu")
               if case.get("own_dropout") else None)
    shard = ddp.RowShard.of(batch, rank, world, dropout)
    local = steps.batch_to_device(ddp.shard_rows(batch, rank, world), "cpu")
    generator = (torch.Generator().manual_seed(case["seed"])
                 if "seed" in case else None)
    spy = Spy(mld)
    try:
        logs, grads = steps.compute_grads(state, local, generator,
                                          case.get("draws"), shard)
        grads = {k: g.clone() for k, g in grads.items()}
        steps.apply_grads(state, logs["grad_norm"])
    finally:
        spy.close()
    return {"logs": {k: float(v) for k, v in logs.items()}, "grads": grads,
            "params": {k: p.detach().clone()
                       for k, p in state.params.items()},
            "shard": (shard.start, shard.stop, shard.rows, shard.valid),
            "masks": spy.masks, "noise": spy.noise}


def eval_case(case):
    """run_split sharded over the ranks: the main pass and the
    MultiModality pass, each over the test split from a fresh loader."""
    cfg, mld = model_of(case)
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    ev = Evaluator(cfg, mld, dm, t2m_params=case["t2m"])
    out = {}
    for mm in (False, True):
        if mm:
            dm.mm_mode(True, cfg.eval.mm_num_samples,
                       rng=np.random.RandomState(0))
        out["mm" if mm else "main"] = ev.run_split(
            dm.loader("test", shuffle=False, batch_size=cfg.eval.batch_size),
            mm=mm, generator=torch.Generator().manual_seed(5),
            compute_rng=np.random.RandomState(0), sharded=True)
    return out


def sync_case(rank):
    """make_metric_sync over the ranks: caches of unequal lengths (rank 1
    holds none at first)."""
    sync = make_metric_sync()
    cache = [np.full((1 + r, 3), 10 * rank + r, np.float32)
             for r in range(2)]
    return {"cache": sync(cache), "empty": sync([] if rank else cache[:1])}


def run(inputs_path, device="cpu"):
    rank, world = ddp.rank(), ddp.world_size()
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    out = {"world": world,
           "train": {name: train_case(case, rank, world)
                     for name, case in inputs["train"].items()},
           "eval": eval_case(inputs["eval"]),
           "sync": sync_case(rank)}
    torch.save(out, os.path.join(os.path.dirname(inputs_path),
                                 f"rank{rank}.pt"))
