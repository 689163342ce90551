"""Attention: the bidirectional masked attention kernel (port of
``sdpa_pallas``, ``mld_tpu/ops/attention.py:113-161``, K3) and the CLIP
tower's causal attention kernel (port of ``sdpa_flash_causal``,
``attention.py:223-266``, K4).

Layout is batch-first: q [B, H, Sq, Dh], k/v [B, H, Sk, Dh]. Padded keys are
filled with -1e9, not -inf, so that a fully masked row stays finite; scores
and softmax are f32 whatever the input dtype.

``sdpa`` is the wrapper of the CUDA kernel ``csrc/flash_attention.cu`` (K3)
and ``sdpa_flash_causal`` that of ``csrc/flash_causal.cu`` (K4): CPU tensors
take their plain versions ``flash_plain`` and ``flash_causal_plain``; CUDA
tensors launch the kernel or raise. K3 runs at every shape: the JAX
package's Sq*Sk >= 512^2 dispatch threshold (``attention.py:309-323``) is a
TPU measurement. Its fully masked rows average v over the Sk real keys, as
``sdpa_xla`` does; the TPU kernel divides by Sk padded to 128 there
(ROADMAP.md, section 3).

Both wrappers are differentiable. When autograd tracks q, k or v on the
card, the call goes through a ``torch.autograd.Function`` whose forward is
the kernel and whose backward is the VJP of the plain version, recomputed
from the saved q, k and v: the counterpart of the JAX package's
``_sdpa_pallas_bwd`` and ``_flash_causal_bwd`` (``attention.py:164-184``,
``269-301``), which recompute theirs in XLA. Neither TPU kernel has a
backward kernel. The launch counters count forward launches only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, work
from .dropout import dropout

NEG_INF = -1e9
MAX_CAUSAL_S = 128     # the CLIP context is 77
MAX_CAUSAL_DH = 128

MAX_DH = 128

# kernel launches made by sdpa_flash_causal (K4) and by sdpa (K3), CUDA only
LAUNCHES = 0
FLASH_LAUNCHES = 0


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """K3's function in plain PyTorch (``_flash_kernel``,
    ``attention.py:77-105``): q, k, v upcast to f32, f32 scores times
    1/sqrt(Dh), -1e9 at invalid keys, f32 softmax and P.V, output in q's
    dtype. key_valid: [B, Sk] bool (True = attend) or None for all keys.
    With a generator and dropout_rate > 0, the probabilities are dropped
    as ``sdpa_xla`` drops them (``attention.py:48-73``)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate, generator)
    return torch.matmul(probs, v.float()).to(q.dtype)


def _plain_vjp(plain, inputs, grad_out):
    """The gradients of `plain` at `inputs` against grad_out, recomputed:
    the backward of both attention kernels."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in inputs]
        out = plain(*xs)
    return torch.autograd.grad(out, xs, grad_out)


def _tracked(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_flash(q, k, v, key_valid):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, Dh]")
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if (t.shape != (B, H, Sk, Dh) or t.dtype != q.dtype
                or t.device != q.device):
            raise ValueError(f"{name} must be [B, H, Sk, Dh] = "
                             f"{(B, H, Sk, Dh)} of q's dtype and device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must be f32 or bf16, got {q.dtype}")
    if not (Sq >= 1 and Sk >= 1 and 4 <= Dh <= MAX_DH and Dh % 4 == 0
            and B <= 65535 and H <= 65535):
        raise ValueError(f"the attention kernel takes Sq, Sk >= 1 and Dh a "
                         f"multiple of 4 up to {MAX_DH} (Sq={Sq}, Sk={Sk}, "
                         f"Dh={Dh})")
    if key_valid is not None and (key_valid.shape != (B, Sk)
                                  or key_valid.dtype != torch.bool
                                  or key_valid.device != q.device):
        raise ValueError(f"key_valid must be a [B, Sk] = {(B, Sk)} bool "
                         f"tensor on {q.device}, got {key_valid.dtype} "
                         f"{tuple(key_valid.shape)} on {key_valid.device}")


def flash_operands(q, k, v, key_valid):
    """The output K3 writes, the C entry's arguments but the stream, and the
    operands they point into (held by the caller until the launch).

    q, k and v are passed as they lie, through their batch, head and row
    strides; only a tensor without a unit stride along Dh is copied (none
    on the port's paths). The output is [B, Sq, H, Dh] memory seen as
    [B, H, Sq, Dh]."""
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if key_valid is not None:
        key_valid = key_valid.contiguous()
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    out = torch.empty(B, Sq, H, Dh, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_valid is None else key_valid.data_ptr(),
            out.data_ptr(), B, H, Sq, Sk, Dh,
            *(st for t in (q, k, v, out) for st in t.stride()[:3]),
            1.0 / math.sqrt(Dh), int(q.dtype == torch.bfloat16))
    return out, args, (q, k, v, key_valid)


def _flash_launch(q, k, v, key_valid):
    """K3 on the current stream (no synchronisation)."""
    global FLASH_LAUNCHES
    _check_flash(q, k, v, key_valid)
    out, args, _operands = flash_operands(q, k, v, key_valid)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mld_flash_forward(*args, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    FLASH_LAUNCHES += 1
    work.add("flash_attention", work.dense_attention_flops(q, k))
    return out


class _Flash(torch.autograd.Function):
    """K3 forward; backward the VJP of flash_plain (``_sdpa_pallas_bwd``).
    key_valid gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid):
        ctx.save_for_backward(q, k, v, key_valid)
        return _flash_launch(q, k, v, key_valid)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, key_valid = ctx.saved_tensors
        dq, dk, dv = _plain_vjp(
            lambda q_, k_, v_: flash_plain(q_, k_, v_, key_valid),
            (q, k, v), grad_out)
        return dq, dk, dv, None


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         key_valid: Optional[torch.Tensor] = None,
         dropout_rate: float = 0.0,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Bidirectional attention. q [B, H, Sq, Dh], k/v [B, H, Sk, Dh],
    key_valid [B, Sk] bool (True = attend) or None -> [B, H, Sq, Dh] in q's
    dtype.

    dropout_rate > 0 (training, with the generator its masks are drawn
    from) takes the plain version with the probabilities dropped on any
    device: the reference's dispatch, which sends attention-probability
    dropout to ``sdpa_xla`` (``attention.py:319-320``). This branch is
    chosen by the arguments alone, never by a failed build or launch.

    Otherwise CPU tensors take the plain version; CUDA tensors launch K3 on
    the current stream (no synchronisation) or raise. When autograd tracks
    q, k or v, the launch goes through ``_Flash``, whose backward is the
    plain version's VJP. The kernel reads q, k and v through their strides
    (any views with a unit stride along Dh, such as the heads of a packed
    QKV projection, without a copy) and writes the output as [B, Sq, H, Dh]
    memory, returned as a [B, H, Sq, Dh] view, so that merging the heads
    afterwards copies nothing either."""
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs the generator its "
                             "masks are drawn from")
        return flash_plain(q, k, v, key_valid, dropout_rate, generator)
    if q.device.type == "cpu":
        return flash_plain(q, k, v, key_valid)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    if _tracked(q, k, v):
        return _Flash.apply(q, k, v, key_valid)
    return _flash_launch(q, k, v, key_valid)


def flash_causal_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       sm_scale: float = 1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``_xla_causal_ref``,
    ``attention.py:278-287``): f32 scores times sm_scale, -1e9 above the
    diagonal, f32 softmax, probabilities cast to v's dtype, P.V accumulated
    in f32 and returned in v's dtype."""
    S = q.shape[2]
    neg = torch.full((S, S), NEG_INF, device=q.device).triu(1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale + neg
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, Dh], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q ({q.dtype} "
                             f"{tuple(q.shape)} on {q.device}), got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must be f32 or bf16, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    B, H, S, Dh = q.shape
    if not (1 <= S <= MAX_CAUSAL_S and 4 <= Dh <= MAX_CAUSAL_DH
            and Dh % 4 == 0):
        # a warp's tile row of scores stays in registers up to 128 keys
        raise ValueError(f"the causal kernel takes S <= {MAX_CAUSAL_S} and "
                         f"Dh a multiple of 4 up to {MAX_CAUSAL_DH} "
                         f"(S={S}, Dh={Dh})")


def _flash_causal_launch(q, k, v, sm_scale):
    """K4 on the current stream (no synchronisation)."""
    global LAUNCHES
    _check(q, k, v)
    B, H, S, Dh = q.shape
    lib = _build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mld_flash_causal_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, S, Dh, float(sm_scale), int(q.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"causal-attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    work.add("flash_causal", work.dense_attention_flops(q, k))
    return out


class _FlashCausal(torch.autograd.Function):
    """K4 forward; backward the VJP of flash_causal_plain
    (``_flash_causal_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale = sm_scale
        return _flash_causal_launch(q, k, v, sm_scale)

    @staticmethod
    def backward(ctx, grad_out):
        dq, dk, dv = _plain_vjp(
            lambda q_, k_, v_: flash_causal_plain(q_, k_, v_, ctx.sm_scale),
            ctx.saved_tensors, grad_out)
        return dq, dk, dv, None


def sdpa_flash_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float = 1.0) -> torch.Tensor:
    """Causal attention of the CLIP tower. q/k/v [B, H, S, Dh] -> [B, H, S,
    Dh] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise. When autograd tracks
    q, k or v, the launch goes through ``_FlashCausal``, whose backward is
    the plain version's VJP."""
    if q.device.type == "cpu":
        return flash_causal_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no causal-attention kernel for device {q.device}")
    if _tracked(q, k, v):
        return _FlashCausal.apply(q, k, v, sm_scale)
    return _flash_causal_launch(q, k, v, sm_scale)
