"""The ranks of tests/test_torch_partition.py: each runs, in a 2 (data) x 2
(model) grid of gloo ranks on the CPU, the diffusion steps the parent
wrote into an inputs file on a tensor-parallel denoiser
(``parallel/partition.py``) and saves what it saw, its gradients and
parameters reassembled whole, to ``rank<r>.pt`` beside it. Imports only
the port (and torch, numpy), never JAX."""
import os

import torch

from mld_tpu_torch.parallel import ddp, partition
from mld_tpu_torch.train import steps

from _torch_ddp_ranks import model_of


def residual_stream(mld, record):
    """Hooks recording each encoder layer's output: the residual stream,
    which every rank of a model group holds whole."""
    enc = mld.denoiser.encoder
    layers = list(enc.input_blocks) + [enc.middle_block] + list(
        enc.output_blocks)
    return [layer.register_forward_hook(
        lambda _m, _i, out: record.append(out.detach().clone()))
        for layer in layers]


def step_case(case, axis, device="cpu"):
    """One optimizer step on this rank's rows and part of the model."""
    _, mld = model_of(case, device)
    partition.shard_params(mld, axis)
    state = steps.create_train_state(mld, "diffusion")
    kinds = {k: getattr(p, "model_shard", None)
             for k, p in state.params.items()}
    batch = ddp.pad_batch_to_ranks(case["batch"], axis.data)
    dropout = (partition.axis_generators(case["seed"], axis, device)
               if case.get("own_dropout") else None)
    shard = ddp.RowShard.of(batch, axis.data_rank, axis.data, dropout)
    local = steps.batch_to_device(
        ddp.shard_rows(batch, axis.data_rank, axis.data), device)
    generator = (torch.Generator(device=device).manual_seed(case["seed"])
                 if "seed" in case else None)
    acts = []
    hooks = residual_stream(mld, acts)
    try:
        logs, grads = steps.compute_grads(state, local, generator,
                                          case.get("draws"), shard)
    finally:
        for h in hooks:
            h.remove()
    grads = partition.whole_state({k: g.clone() for k, g in grads.items()},
                                  kinds, axis)
    steps.apply_grads(state, logs["grad_norm"])
    return {"logs": {k: float(v) for k, v in logs.items()}, "grads": grads,
            "params": partition.whole_state(
                {k: p.detach() for k, p in state.params.items()}, kinds,
                axis),
            "kinds": kinds, "acts": [a.cpu() for a in acts],
            "place": (axis.data_rank, axis.model_rank)}


def run(inputs_path, device="cpu"):
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    axis = partition.make_groups(inputs["data"], inputs["model"])
    out = {name: step_case(case, axis, device)
           for name, case in inputs["cases"].items()}
    torch.save(out, os.path.join(os.path.dirname(inputs_path),
                                 f"rank{ddp.rank()}.pt"))
