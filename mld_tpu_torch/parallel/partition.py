"""Tensor-parallel parameter layout over a model axis (the twin of
``mld_tpu/parallel/partition.py``), on the data parallelism of
``parallel/ddp.py``.

JAX marks each parameter with a ``PartitionSpec`` over a ("data",
"model") mesh and lets XLA insert the collectives; here the layers are
made tensor-parallel by hand. ``param_spec`` is JAX's layout decision on
the port's torch names: the FFN up-projections (``linear1``, ``fc1``) and
the packed QKV (``in_proj_weight``) split on their output (flax
``P(None, "model")``, torch dim 0 of an [out, in] weight), the FFN
down-projections (``linear2``, ``fc2``) and the attention outputs
(``out_proj``) on their input (flax ``P("model", None)``, torch dim 1), and
everything else, every vector included, replicated.

``shard_params`` keeps on each rank its part of those matrices and makes
their layers tensor-parallel (Megatron's layout): a column-parallel product
takes a replicated input, whose gradient it all-reduces over the model
group in the backward, and adds its own columns' bias (the bias is cut
with its matrix: XLA slices the replicated bias itself); a row-parallel
product all-reduces its output in the forward and adds its bias once,
after the sum. The packed QKV is split by heads, each rank keeping the Q,
K and V rows of its own H / model heads, so that attention (K3 on the
card) runs on a rank's heads alone and ``out_proj`` takes their columns.

What the layout changes around it:
  - the data-parallel mean of the gradients (``ddp.all_reduce_grads``) is
    over the data group, the ranks that hold the same part;
  - the gradient norm sums the sharded leaves' squares over the model group
    and counts the replicated leaves once (``train/steps.py:global_norm``),
    so that every rank clips and skips alike;
  - dropout masks on the residual stream, which every rank of a model group
    holds whole, come from a generator keyed by the data rank, and masks on
    the sharded activations (the FFN's hidden, a rank's heads' attention
    probabilities) from one keyed by data and model rank
    (``axis_generators``, ``ops/dropout.py:AxisGenerators``);
  - K1 reads whole weights, so the sharded denoiser takes the module path
    (JAX's auto mode keeps the XLA path on more than one device,
    ``mld_tpu/models/mld.py:418-425``); the VAE, which no sharded stage
    trains, stays whole.

No CLI flag builds a model axis (JAX's trainer has none); the tests and
``chip_smoke.py`` do, as JAX's tests and dry-run entry do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mld_tpu_torch.ops.dropout import AxisGenerators
from mld_tpu_torch.ops.transformer import Linear, MultiheadAttention, _promoted
from mld_tpu_torch.parallel import ddp

COLUMN = "column"   # flax P(None, "model"): torch dim 0 (and its bias)
ROW = "row"         # flax P("model", None): torch dim 1
QKV = "qkv"         # a packed in_proj, split by heads (a column split)
COLUMN_NAMES = ("linear1", "fc1")
ROW_NAMES = ("linear2", "fc2", "out_proj")


def param_spec(name: str, tensor: torch.Tensor) -> Optional[str]:
    """The layout of one parameter by its torch name: COLUMN, ROW or None
    (replicated), JAX's ``param_spec`` decision."""
    parts = name.split(".")
    if tensor.ndim < 2:
        return None
    if parts[-1] == "in_proj_weight":
        return COLUMN
    if parts[-1] == "weight" and any(p in COLUMN_NAMES for p in parts):
        return COLUMN
    if parts[-1] == "weight" and any(p in ROW_NAMES for p in parts):
        return ROW
    return None


@dataclasses.dataclass
class ModelAxis:
    """A rank's place in the data x model grid: rank = data_rank x model +
    model_rank (data-major, ``make_mesh(num_data, num_model)``), its model
    group (the ranks that share its rows and hold the other parts) and its
    data group (the ranks that hold its part)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object


def make_groups(data: int, model: int) -> ModelAxis:
    """The 2D rank grid over the world's process group (every rank calls
    it, in the same order)."""
    world = ddp.world_size()
    if data * model != world:
        raise ValueError(f"a {data} x {model} grid needs {data * model} "
                         f"ranks, the world has {world}")
    rank = ddp.rank()
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    d, m = divmod(rank, model)
    return ModelAxis(data, model, d, m, data_groups[m], model_groups[d])


def axis_generators(seed: int, axis: ModelAxis, device) -> AxisGenerators:
    """A rank's dropout generators: the replicated one keyed by the data
    rank (``ddp.rank_generator``: alike on the model group's ranks), the
    sharded one by (data rank, model rank)."""
    derived = np.random.SeedSequence(
        [seed, axis.data_rank, axis.model_rank]).generate_state(1)[0]
    return AxisGenerators(
        ddp.rank_generator(seed, axis.data_rank, device),
        torch.Generator(device=device).manual_seed(int(derived)))


# ------------------------------------------------------------- collectives
class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each rank's part of the product contributes to it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ddp.all_reduce_sum(grad, ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward; identity backward (the output
    is replicated, and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        ddp.all_reduce_sum(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis.model_group)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis.model_group)


# ------------------------------------------------------------------ layers
class ColumnParallelLinear(Linear):
    """A Linear keeping a rank's output rows (and their bias)."""

    def forward(self, x):
        return super().forward(copy_to_model(x, self.model_axis))


class RowParallelLinear(Linear):
    """A Linear keeping a rank's input columns; its bias is added once,
    after the sum over the model group."""

    def forward(self, x):
        x, w, b = _promoted(x, self.weight, self.bias)
        out = reduce_from_model(F.linear(x, w), self.model_axis)
        return out if b is None else out + b


class ShardedMultiheadAttention(MultiheadAttention):
    """Packed-QKV attention over a rank's heads: its Q, K and V rows (its
    out_proj, a RowParallelLinear, takes the matching columns)."""

    def _inputs(self, query, key, value):
        q = copy_to_model(query, self.model_axis)
        if key is query and value is query:
            return q, q, q
        k = copy_to_model(key, self.model_axis)
        return q, k, k if value is key else copy_to_model(value,
                                                           self.model_axis)


def _keep(module: nn.Module, name: str, part: torch.Tensor, kind: str):
    p = nn.Parameter(part.detach().clone(),
                     requires_grad=getattr(module, name).requires_grad)
    p.model_shard = kind
    setattr(module, name, p)


def _shard_attention(m: MultiheadAttention, axis: ModelAxis):
    d = m.in_proj_weight.shape[1]
    H = m.num_heads
    if H % axis.model:
        raise ValueError(f"{H} heads do not split over a model axis of "
                         f"{axis.model}")
    width = d // axis.model
    cols = torch.arange(axis.model_rank * width, (axis.model_rank + 1)
                        * width, device=m.in_proj_weight.device)
    rows = torch.cat([cols + j * d for j in range(3)])
    _keep(m, "in_proj_weight", m.in_proj_weight[rows], QKV)
    _keep(m, "in_proj_bias", m.in_proj_bias[rows], QKV)
    m.num_heads = H // axis.model
    m.model_axis = axis
    m.__class__ = ShardedMultiheadAttention


def _shard_linear(lin: nn.Linear, kind: str, axis: ModelAxis):
    n = lin.weight.shape[0 if kind == COLUMN else 1]
    if n % axis.model:
        raise ValueError(f"{n} {kind}s do not split over a model axis of "
                         f"{axis.model}")
    part = slice(axis.model_rank * n // axis.model,
                 (axis.model_rank + 1) * n // axis.model)
    if kind == COLUMN:
        _keep(lin, "weight", lin.weight[part], COLUMN)
        if lin.bias is not None:
            _keep(lin, "bias", lin.bias[part], COLUMN)
        lin.__class__ = ColumnParallelLinear
    else:
        _keep(lin, "weight", lin.weight[:, part], ROW)
        lin.__class__ = RowParallelLinear
    lin.model_axis = axis


def shard_params(mld: nn.Module, axis: ModelAxis):
    """Keep this rank's part of every parameter ``param_spec`` splits in the
    denoiser, the diffusion stage's trainable set (JAX shards the train
    state's params and replicates the frozen tree; ``create_train_state``
    refuses a stage that trains more under a model axis), and make its
    layers tensor-parallel; `mld.model_axis` is the axis afterwards. Build
    the optimizer after this: the parts are new parameters."""
    denoiser = mld.denoiser
    for m in denoiser.modules():
        if isinstance(m, MultiheadAttention):
            _shard_attention(m, axis)
    for name, sub in denoiser.named_modules():
        kind = (param_spec(f"{name}.weight", sub.weight)
                if isinstance(sub, nn.Linear) else None)
        if kind is not None:
            _shard_linear(sub, kind, axis)
    # K1 reads whole weights
    denoiser.fusable = False
    denoiser.drop_stack()
    mld.model_axis = axis
    return mld


def unshard(t: torch.Tensor, kind: Optional[str],
            axis: ModelAxis) -> torch.Tensor:
    """The whole tensor of which `t` is this rank's part (a parameter's
    ``model_shard`` kind; None: replicated, returned as it is), gathered
    over the model group, on the CPU."""
    if kind is None:
        return t.detach().cpu()
    parts = [None] * axis.model
    dist.all_gather_object(parts, t.detach().cpu(), group=axis.model_group)
    if kind == QKV:
        return torch.cat([torch.cat([p.chunk(3)[j] for p in parts])
                          for j in range(3)])
    return torch.cat(parts, dim=0 if kind == COLUMN else 1)


def whole_state(named: Dict[str, torch.Tensor], kinds: Dict[str, str],
                axis: ModelAxis) -> Dict[str, torch.Tensor]:
    """`named` tensors (parameters or their gradients) reassembled by their
    kinds (``model_shard`` of each parameter)."""
    return {k: unshard(v, kinds.get(k), axis) for k, v in named.items()}

