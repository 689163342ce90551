"""Matmul precision: the session's and each serving stage's (the twin of
``mld_tpu/__init__.py:18-20`` and ``MLD._stage_precision``,
``mld_tpu/models/mld.py:181-202``).

``MLD_TPU_MATMUL_PRECISION`` sets the session's precision (default
"highest"); ``MLD_TPU_STAGE_PRECISION`` overlays one on a serving stage, as
comma-separated ``stage=precision`` pairs over the stages ``clip``, ``scan``
and ``decode`` (the first pair of a stage counts, as in JAX). Both are read
when a call is made, in JAX's names, and mapped to the card's arithmetic as
a TPU computes them, the platform the JAX package's precision study ran on:

  default / bfloat16 / fastest   bf16 operands, f32 accumulation and result
  high / tensorfloat32           TF32 operands, f32 accumulation
  highest / float32              IEEE f32

"default" as bf16 is the TPU's meaning; JAX on a GPU computes "default"
and "high" alike in TF32 (jax 0.9.0, ``jax/_src/lax/lax.py:2013-2024``).
On a TPU "high" is three bf16 passes; here it is TF32 (ROADMAP.md section
3). An unknown precision or stage raises: nothing falls back to f32.

``matmul_precision(name)`` is the one scope: inside it ``current()`` is
`name`, TF32 is on for cuBLAS and cuDNN exactly under "high", and all of it
is restored on the way out. Outside every scope ``current()`` is the
session's. What reads it: ``linear`` (every f32 GEMM of the models' linear
layers, forward and backward), ``weight_dtype`` (K1's and K5's weight
arm, ``mld.py:305-312``, ``379-391``), the bidirectional attention of f32
tensors (``ops/attention.py:sdpa``: K3's arm on the card, ``matmul`` in its
plain version, as ``sdpa_xla``'s einsums inherit JAX's precision) and the
action presets' forward kinematics (``models/smpl.py``). Pinned whatever
the session says: the attention inside K5 (3xTF32, as JAX pins HIGHEST
there, ``mld_tpu/ops/fused_seq_decoder.py:47-59``), K4's causal attention
(its own arithmetic: the served tower is bf16, where the precision changes
no product), and the evaluator networks, which run under
``matmul_precision("highest")`` (``mld_tpu/eval/pipeline.py:75-87``).

On the CPU the GEMM of each arm is its plain version: the operands rounded
to bf16 or TF32 on the bits, then an f32 product. On the card the bf16
arm's forward linear is one kernel (``ops/linear_bf16.py``): the operands
rounded on chip, the products, the bias added to the f32 sums.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.linear_bf16 import linear_bf16 as _linear_bf16
from . import trace

# JAX's precision names -> the card's arithmetic
ARITHMETIC = {"default": "bf16", "bfloat16": "bf16", "fastest": "bf16",
              "high": "tf32", "tensorfloat32": "tf32",
              "highest": "f32", "float32": "f32"}
STAGES = ("clip", "scan", "decode")
SESSION_VAR = "MLD_TPU_MATMUL_PRECISION"
STAGE_VAR = "MLD_TPU_STAGE_PRECISION"

_active: Optional[str] = None   # the innermost matmul_precision's name


def check(name: str) -> str:
    """`name` if it is one of JAX's precision names the port maps, else
    ValueError."""
    if name not in ARITHMETIC:
        raise ValueError(f"unknown matmul precision {name!r}; the port maps "
                         f"{', '.join(ARITHMETIC)}")
    return name


def session() -> str:
    """MLD_TPU_MATMUL_PRECISION, "highest" when unset or empty."""
    return check(os.environ.get(SESSION_VAR) or "highest")


def stage_spec() -> Dict[str, str]:
    """MLD_TPU_STAGE_PRECISION as {stage: precision}; an entry that is not
    ``stage=precision`` over a known stage and precision raises."""
    out: Dict[str, str] = {}
    for part in os.environ.get(STAGE_VAR, "").split(","):
        part = part.strip()
        if not part:
            continue
        stage, sep, name = (s.strip() for s in part.partition("="))
        if not sep or stage not in STAGES:
            raise ValueError(f"bad {STAGE_VAR} entry {part!r}: want "
                             f"stage=precision over the stages "
                             f"{', '.join(STAGES)}")
        out.setdefault(stage, check(name))
    return out


def current() -> str:
    """The precision in force: the innermost scope's, else the session's."""
    return _active if _active is not None else session()


def arithmetic() -> str:
    """"f32", "tf32" or "bf16": what the GEMMs in force compute in."""
    return ARITHMETIC[current()]


def weight_dtype() -> torch.dtype:
    """K1's and K5's weight arm at the precision in force: the bf16 stack
    under default / bfloat16, the f32 one otherwise ("fastest" too, as
    ``mld.py:308``, ``382`` pick)."""
    return (torch.bfloat16 if current() in ("default", "bfloat16")
            else torch.float32)


@contextlib.contextmanager
def matmul_precision(name: str):
    """Run the body at precision `name`; the caller's precision and cuBLAS
    and cuDNN TF32 settings are restored on the way out."""
    global _active
    tf32 = ARITHMETIC[check(name)] == "tf32"
    saved = (_active, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _active = name
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (_active, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def stage_precision(stage: str):
    """The scope of one serving stage: its MLD_TPU_STAGE_PRECISION entry,
    else the precision in force."""
    if stage not in STAGES:
        raise ValueError(f"unknown serving stage {stage!r}")
    return matmul_precision(stage_spec().get(stage, current()))


# ------------------------------------------------------------------ GEMMs
def round_bits(x: torch.Tensor, mode: str) -> torch.Tensor:
    """f32 x rounded to nearest even, as f32: to bf16 ("bf16") or to TF32's
    10 mantissa bits ("tf32"), the rounding cuBLAS's TF32 GEMM matches on
    the card."""
    if mode == "bf16":
        return x.bfloat16().float()
    i = x.view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & -8192).view(torch.float32)


# the span of a reduced GEMM's operand rounding, and the counters of the
# f32 bytes a reduced linear rounds (``utils/trace.py``), by arithmetic; the
# card's bf16 forward linear rounds inside its kernel, outside any span
_CAST_SPANS = {"bf16": "cast.bf16", "tf32": "cast.tf32"}
_ACT_BYTES = {"bf16": "cast.act_bytes.bf16", "tf32": "cast.act_bytes.tf32"}
_WEIGHT_BYTES = {"bf16": "cast.weight_bytes.bf16",
                 "tf32": "cast.weight_bytes.tf32"}


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a [M, K] @ b [K, N], f32 in and out, in `mode`'s arithmetic: the
    plain version on the CPU, cuBLAS on the card (bf16 operands with an f32
    result through ``mm.dtype``; TF32 operands rounded on the bits, then
    cuBLAS's TF32 GEMM, since cuBLAS may give a shape an f32 kernel where
    TF32 is allowed). A card whose torch cannot give the bf16 GEMM an f32
    result raises. The operands' rounding is the span ``cast.<mode>``; the
    GEMM lies outside it. On the card it serves the backward's bf16 GEMMs
    and the TF32 arm; the bf16 forward linear is ``_linear_bf16``."""
    dev = a.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no {mode} GEMM for device {a.device}")
    with trace.span(_CAST_SPANS[mode]):
        if dev == "cuda" and mode == "bf16":
            a, b = a.bfloat16(), b.bfloat16()
        else:
            a, b = round_bits(a, mode), round_bits(b, mode)
    if dev == "cpu":
        return a @ b
    if mode == "bf16":
        return torch.mm(a, b, out_dtype=torch.float32)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.mm(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def linear_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 mode: str) -> torch.Tensor:
    """x [M, K] @ w [N, K].T + b through ``_mm`` and a separate bias add:
    the forward of a reduced linear everywhere but the card's bf16 arm. On
    the CPU it is the plain version the card's bf16 linear kernel is held
    to (the operands rounded on the bits, an f32 product, the bias added);
    on the card in bf16 it is the path that kernel replaced (two casts,
    cuBLAS with an f32 result, a broadcast add)."""
    y = _mm(x, w.t(), mode)
    return y if b is None else y + b


class _ReducedLinear(torch.autograd.Function):
    """x @ w.T + b with both operands of every product, the backward's too,
    in `mode`'s arithmetic: the VJP dots of JAX inherit the precision. The
    forward of a CUDA tensor in bf16 is the kernel ``_linear_bf16`` (the
    rounding, the GEMM and the bias in one launch); every other forward is
    ``linear_plain`` and the backward goes through ``_mm``."""

    @staticmethod
    def forward(ctx, x, w, b, mode):
        ctx.save_for_backward(x, w)
        ctx.mode, ctx.has_bias = mode, b is not None
        trace.COUNTS[_ACT_BYTES[mode]] += x.numel() * x.element_size()
        trace.COUNTS[_WEIGHT_BYTES[mode]] += w.numel() * w.element_size()
        x2 = x.reshape(-1, x.shape[-1])
        if mode == "bf16" and x.device.type == "cuda":
            y = _linear_bf16(x2.contiguous(), w.contiguous(), b)
        else:
            y = linear_plain(x2, w, b, mode)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.reshape(-1, w.shape[0])
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = _mm(g, w, ctx.mode).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = _mm(g.t(), x.reshape(-1, x.shape[-1]), ctx.mode)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = g.sum(0)
        return gx, gw, gb, None


def _bmm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b (batched, same batch dims), f32 in and out, in `mode`'s
    arithmetic on any device: both operands rounded on the bits, then an
    f32 product. Products of rounded operands are exact in f32, so this is
    the reduced product with f32 sums, the plain version K3's reduced arms
    are held to."""
    return torch.matmul(round_bits(a, mode), round_bits(b, mode))


class _ReducedMatmul(torch.autograd.Function):
    """a @ b with both operands of every product, the backward's too,
    rounded to `mode` (``_bmm``), as JAX's VJP dots inherit the
    precision."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return _bmm(a, b, mode)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _bmm(grad, b.transpose(-1, -2), ctx.mode)
        if ctx.needs_input_grad[1]:
            gb = _bmm(a.transpose(-1, -2), grad, ctx.mode)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b of f32 tensors of the same batch dims in `mode` ("f32",
    "tf32" or "bf16"), forward and backward: ``torch.matmul`` itself under
    "f32"."""
    if mode == "f32":
        return torch.matmul(a, b)
    if mode not in ("tf32", "bf16") or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"reduced matmul takes tf32 or bf16 over equal "
                         f"batch dims, got {mode!r} for {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return _ReducedMatmul.apply(a, b, mode)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear`` at the precision in force for f32 operands (under
    "highest" it is ``F.linear`` itself); other dtypes as ``F.linear``
    computes them, as JAX's precision leaves bf16 dots as they are."""
    mode = arithmetic()
    if mode == "f32" or x.dtype != torch.float32 \
            or w.dtype != torch.float32:
        return F.linear(x, w, b)
    return _ReducedLinear.apply(x, w, b, mode)

