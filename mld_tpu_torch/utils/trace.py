"""The port's instrumentation: spans on the profiler's clock and counters.

Spans. ``span(name)`` is a context manager around a piece of the serving
path. With tracing off (the default) it is one shared
``contextlib.nullcontext()``: nothing is allocated and nothing recorded.
With tracing on it is ``torch.profiler.record_function("mld." + name)``, so
the span lands in any ``torch.profiler`` trace on the profiler's clock, the
clock of the CUDA device events; the profiler's event tree gives each span
its parent and ``export_chrome_trace`` writes them out. ``enable(on)`` is
the only switch. Tracing changes no number the program computes.

The spans of a call (``models/mld.py``, ``models/clip_text.py``,
``ops/transformer.py``, ``utils/precision.py``)::

    tokenize                         ClipTokenizer.__call__
    generate                         MLD.generate_joints
      condition                      MLD.condition_embedding
        condition.uncond             the empty prompt through the tower
        condition.tower              the prompts through the tower
      loop                           the sampling loop
        loop.preamble                K1's hoisted time table and condition
        loop.step                    one scheduler timestep
          loop.denoise               the denoiser call
          loop.cfg                   the guidance chunk and combine
          loop.scheduler             the scheduler's update
            loop.noise               ancestral DDPM's noise draw
      decode                         MLD.decode_latent
      joints                         MLD.masked_joints
    attn.self, attn.cross, ffn       a TransformerDecoderLayer's sublayers
                                     with their norms (inside loop.denoise
                                     for the raw-motion trans_dec denoiser,
                                     inside decode for the plain VAE and
                                     ACTOR decoders)
    cast.bf16, cast.tf32             a reduced GEMM's operand rounding
                                     (``precision._mm``); the card's bf16
                                     forward linear rounds inside its
                                     kernel, so on the card cast.bf16
                                     surrounds only the backward's casts

Counters. ``COUNTS`` is always on: one integer add where the work is
launched. Its keys:

    launch.k1.<f32|bf16>       K1 (skip_encoder_stack) by weight dtype
    launch.k2.<f32|bf16>       K2 (fused_encoder_layer) by weight dtype
    launch.k3.<arm>            K3 (sdpa) by arm, ``attention.FLASH_ARMS``
    launch.k4                  K4 (sdpa_flash_causal)
    launch.k5.<f32|bf16>       K5's entry (skip_decoder_stack) by weights
    launch.lin.bf16            the bf16 linear kernel (linear_bf16), the
                               forward of every reduced bf16 linear
    kernels.k5                 the device kernels K5's entries launched
    flops.<wrapper>            the operations each launch wrapper counted
                               (``ops/work.py``)
    cast.act_bytes.<bf16|tf32>     f32 bytes of the activations and
    cast.weight_bytes.<bf16|tf32>  weights a reduced linear rounds for
                                   its GEMM (forward only; CPU too; on the
                                   card's bf16 arm inside linear_bf16's
                                   kernel)
    noise.bytes                    bytes of ancestral DDPM's noise drawn
                                   from the generator (CPU too; replayed
                                   ``step_noise`` is not counted)

The launch and flops counters count on the card only (the CPU runs the
plain versions). A CUDA graph replay of the raw-motion denoiser call
(``models/denoise_graph.py``) adds what its capture counted, so the
counters read as if every step ran eagerly. ``total(prefix)`` sums a family: ``total("launch.k3")``
is every K3 launch.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import torch

COUNTS: Counter = Counter()

_OFF = contextlib.nullcontext()
_on = False


def enable(on: bool) -> None:
    """Turn the spans on or off (off at import)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A context manager: the shared no-op with tracing off, else
    ``record_function("mld." + name)``."""
    if not _on:
        return _OFF
    return torch.profiler.record_function("mld." + name)


def total(prefix: str) -> int:
    """The sum of the counters whose key is `prefix` or starts with
    `prefix` and a dot."""
    dotted = prefix + "."
    return sum(v for k, v in COUNTS.items()
               if k == prefix or k.startswith(dotted))
