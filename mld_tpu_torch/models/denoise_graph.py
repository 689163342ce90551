"""The module-path denoiser call of a sampling step as one CUDA graph.

The raw-motion denoiser (``RawMotionDenoiser``, trans_dec) runs as plain
modules: about 430 launches a guided step at the flagship widths, which
the host enqueues more slowly than the card runs them. ``DenoiserGraph``
captures one such call at fixed shapes and replays it each step: the
step's inputs are copied into the graph's own tensors (the sample and the
timestep each step, the condition and the frame mask once a call), and the
output is the graph's own tensor, overwritten by the next replay. The
same kernels run on the same inputs, so the numbers are the eager call's.

The counters (``utils/trace.py``'s ``COUNTS``) are kept as an eager call
keeps them: the first call of a graph runs eagerly and counts, the capture's
own counting is taken back, and each replay adds what the capture counted.

``allowed`` says when a graph may stand in for the eager call: on a CUDA
device, without gradients, and only when nothing watches the launches one
by one (the trace spans are off and no ``torch.profiler`` is running), so
that a traced call sees every span and kernel as before.
"""
from __future__ import annotations

import itertools

import torch

from mld_tpu_torch.utils import precision, trace


def allowed(device: torch.device) -> bool:
    """Whether a step's denoiser call on `device` may be a graph replay."""
    return (device.type == "cuda" and not torch.is_grad_enabled()
            and not trace.enabled() and not torch.autograd._profiler_enabled())


def key(denoiser, sample, cond, mask) -> tuple:
    """What a captured graph depends on beyond its inputs' values: the
    shapes and dtypes, the precision in force and the storage of the
    denoiser's parameters and buffers (replaced storage needs a new
    capture; in-place updates do not)."""
    tensors = itertools.chain(denoiser.parameters(), denoiser.buffers())
    return (tuple(sample.shape), sample.dtype, tuple(cond.shape), cond.dtype,
            None if mask is None else tuple(mask.shape), precision.current(),
            tuple(t.data_ptr() for t in tensors))


class DenoiserGraph:
    """``denoiser(sample, t, cond, mask)`` at one key, captured on its
    first call and replayed after it."""

    def __init__(self, denoiser, key_: tuple, sample, cond, mask):
        self.denoiser, self.key = denoiser, key_
        self.sample = torch.empty_like(sample)
        self.t = torch.zeros((), dtype=torch.long, device=sample.device)
        self.cond = torch.empty_like(cond)
        self.mask = None if mask is None else torch.empty_like(mask)
        self.graph = self.out = None
        self.counts = None

    def condition(self, cond, mask) -> "DenoiserGraph":
        """Set a call's condition and frame mask (constant over its
        steps)."""
        self.cond.copy_(cond)
        if mask is not None:
            self.mask.copy_(mask)
        return self

    def __call__(self, sample, t: int) -> torch.Tensor:
        """The denoiser's output at host timestep `t`: the graph's own
        tensor, valid until the next call."""
        self.sample.copy_(sample)
        self.t.fill_(int(t))
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        trace.COUNTS.update(self.counts)
        return self.out

    def _forward(self):
        return self.denoiser(self.sample, self.t, self.cond, self.mask)

    def _capture(self) -> torch.Tensor:
        """Run the call eagerly on a side stream (its output is this
        step's; it also makes every lazy set-up before the capture), then
        capture it on that stream."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=self.sample.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._forward()
        main.wait_stream(side)
        out.record_stream(main)
        before = trace.COUNTS.copy()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            self.out = self._forward()
        self.counts = trace.COUNTS - before
        trace.COUNTS.clear()
        trace.COUNTS.update(before)
        self.graph = graph
        return out
