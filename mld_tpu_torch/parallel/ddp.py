"""Data parallelism over ``torch.distributed`` (the twin of
``mld_tpu/parallel/mesh.py``).

JAX shards one batch over a mesh's ``data`` axis, replicates the
parameters and lets XLA emit the gradient all-reduce. Here each rank is a
process with the model on its own device (NCCL between cards, gloo on the
CPU): every rank holds the same global batch, keeps its contiguous rows
(``shard_rows``, as ``P("data")`` shards axis 0), and after the backward the
trainable gradients are summed in one flat buffer and divided by the world
size (``all_reduce_grads``), before the norm and the optimizer step, so that
every rank takes the same step. ``train.batch_size`` is the global batch.

The model is not wrapped in ``DistributedDataParallel``: the training step
runs its forwards through ``torch.func.functional_call`` on bf16 copies and
through non-reentrant ``checkpoint`` (``train/steps.py:_segment``), where
DDP's reducer hooks would not see the parameters' gradients.

``RowShard`` is what a step needs to know of its rank's rows: which rows of
the global batch it holds, how many of them are real (``pad_batch_to_ranks``
appends all-zero ghost rows with ``row_valid`` False), and the generator of
the rank's own dropout masks. Every other draw of a step is made for the
global batch from a generator seeded alike on every rank, and each rank
keeps its rows, so the sharded step equals the single-process one.

Processes: ``spawn`` starts one rank a device on a free rendezvous port of
this host; under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` in
the environment) ``init_from_env`` joins the group it set up.
"""
from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def backend_for(device) -> str:
    """NCCL between cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port of this host for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(rank_: int, world: int, device, backend: Optional[str] = None,
         init_method: Optional[str] = None):
    """Join a process group of `world` ranks as `rank_`, with `device` the
    rank's device (a card's ordinal becomes the current device). Without
    `init_method`, a group of one on a free port of this host."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if init_method is None:
        if world != 1:
            raise ValueError("a group of more than one rank needs the "
                             "rendezvous address (init_method)")
        init_method = f"tcp://localhost:{free_port()}"
    dist.init_process_group(backend or backend_for(device),
                            init_method=init_method, world_size=world,
                            rank=rank_)


def torchrun_env() -> bool:
    """Whether this process is one rank of a ``torchrun`` launch."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def init_from_env(device_type: str) -> torch.device:
    """Join the group a ``torchrun`` launch set up; returns the rank's
    device (``cuda:LOCAL_RANK``, or the CPU)."""
    device = (torch.device("cuda", int(os.environ["LOCAL_RANK"]))
              if device_type == "cuda" else torch.device("cpu"))
    init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), device,
         init_method="env://")
    return device


def teardown():
    if is_initialized():
        dist.destroy_process_group()


def barrier():
    if is_initialized():
        dist.barrier()


def _rank_main(rank_: int, fn, devices: Sequence[str], backend: str,
               init_method: str, args: tuple, kwargs: dict):
    if torch.device(devices[rank_]).type == "cpu":
        # the CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    init(rank_, len(devices), devices[rank_], backend, init_method)
    try:
        fn(*args, device=devices[rank_], **kwargs)
    finally:
        teardown()


def spawn(fn, devices: Sequence[str], *args, backend: Optional[str] = None,
          **kwargs):
    """Run ``fn(*args, device=devices[r], **kwargs)`` in one new process a
    rank r, joined in a group over a free port of this host; raises if any
    rank fails. `fn` and its arguments are pickled (`fn` by import
    path)."""
    backend = backend or backend_for(devices[0])
    init_method = f"tcp://localhost:{free_port()}"
    mp.start_processes(_rank_main, nprocs=len(devices), start_method="spawn",
                       args=(fn, list(devices), backend, init_method, args,
                             kwargs))


# ---------------------------------------------------------------- batches
def pad_batch_to_ranks(batch: Mapping, world: int) -> Dict:
    """Append all-zero ghost rows to every array (ndim >= 1) so that the
    batch divides the world size (``pad_batch_to_devices``), and mark the
    real rows in ``row_valid`` (ghost rows False). Other values pass
    unchanged."""
    out = dict(batch)
    n = len(np.asarray(batch["mask"]))
    out.setdefault("row_valid", np.ones(n, bool))
    rem = (-n) % world
    for k, v in out.items():
        if rem and isinstance(v, np.ndarray) and v.ndim > 0:
            out[k] = np.concatenate([v, np.zeros((rem,) + v.shape[1:],
                                                 v.dtype)])
    return out


def shard_bounds(rows: int, rank_: int, world: int) -> slice:
    """Rank `rank_`'s contiguous block of `rows` (``P("data")``): blocks
    of ceil(rows / world), the last ones shorter or empty when `rows` does
    not divide."""
    per = -(-rows // world)
    return slice(min(rank_ * per, rows), min((rank_ + 1) * per, rows))


def shard_rows(batch: Mapping, rank_: int, world: int) -> Dict:
    """Rank `rank_`'s rows of every array (ndim >= 1) and list of the
    batch; other values pass unchanged."""
    rows = len(np.asarray(batch["mask"]))
    sl = shard_bounds(rows, rank_, world)
    return {k: v[sl] if (isinstance(v, np.ndarray) and v.ndim > 0)
            or isinstance(v, list) else v for k, v in batch.items()}


@dataclasses.dataclass
class RowShard:
    """A rank's rows of the global batch: rows [start, stop) of `rows`,
    of which `valid` (over the whole batch) are real; `dropout`, the
    rank's own dropout-mask generator (None: the step's generator, as with
    one rank)."""
    start: int
    stop: int
    rows: int
    valid: int
    world: int
    dropout: Optional[torch.Generator] = None

    @classmethod
    def of(cls, batch: Mapping, rank_: int, world: int,
           dropout: Optional[torch.Generator] = None) -> "RowShard":
        """The shard of a padded global batch (``pad_batch_to_ranks``)."""
        valid = np.asarray(batch["row_valid"])
        sl = shard_bounds(len(valid), rank_, world)
        return cls(sl.start, sl.stop, len(valid), int(valid.sum()), world,
                   dropout)

    @classmethod
    def whole(cls, batch: Mapping) -> "RowShard":
        """The whole batch (numpy or tensors) as one rank's shard: the step
        without data parallelism."""
        rows = len(batch["mask"])
        valid = batch.get("row_valid")
        return cls(0, rows, rows, rows if valid is None else int(valid.sum()),
                   1)

    @property
    def row_count(self) -> float:
        """The rows a rank's loss mean is over: the global valid rows (at
        least one) over the world size, so that the ranks' mean of their
        means is the global mean over the valid rows."""
        return max(self.valid, 1) / self.world

    def take(self, x):
        """This rank's rows of a global draw (a tensor, or a dict of
        them)."""
        if isinstance(x, Mapping):
            return {k: self.take(v) for k, v in x.items()}
        return x[self.start:self.stop]


def rank_generator(seed: int, rank_: int, device) -> torch.Generator:
    """The generator of rank `rank_`'s own draws (its dropout masks), on
    `device`: seeded from (seed, rank), so that no two ranks draw alike,
    nor any rank like the step generator seeded with `seed`."""
    derived = np.random.SeedSequence([seed, rank_]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(derived))


# ------------------------------------------------------------- collectives
def _flat_collective(tensors: List[torch.Tensor], op, group=None):
    """op(flat) on one flat buffer of `tensors` (one dtype), written back.
    gloo (the backend of `group`) takes the buffer through the host."""
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    staged = flat.cpu() if (flat.is_cuda and
                            dist.get_backend(group) == "gloo") else flat
    op(staged)
    if staged is not flat:
        flat.copy_(staged)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def _mean_op(group):
    n = dist.get_world_size(group)

    def op(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    return op


def all_reduce_grads(grads: Iterable[torch.Tensor], group=None):
    """Replace each gradient by its mean over the ranks of `group` (default
    the world; under a model axis the data group,
    ``parallel/partition.py``): one flat buffer, one all_reduce (sum),
    divided by the group's size."""
    if not is_initialized():
        return
    _flat_collective(list(grads), _mean_op(group), group)


def all_reduce_mean(values: Mapping[str, torch.Tensor], group=None
                    ) -> Dict[str, torch.Tensor]:
    """Scalars averaged over the ranks of `group` (one all_reduce)."""
    if not is_initialized() or not values:
        return dict(values)
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    _flat_collective([stacked], _mean_op(group), group)
    return dict(zip(keys, stacked.unbind()))


def all_reduce_sum(t: torch.Tensor, group=None):
    """`t` replaced in place by its sum over the ranks of `group`."""
    if is_initialized():
        _flat_collective([t], lambda flat: dist.all_reduce(flat, group=group),
                         group)


def broadcast_module(module: torch.nn.Module, src: int = 0):
    """Rank `src`'s parameters and buffers to every rank
    (``replicate_tree``): one broadcast a dtype."""
    if not is_initialized():
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's picklable `obj`, in rank order."""
    if not is_initialized():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out
