"""Attention: plain masked multi-head attention (port of ``sdpa_xla``,
``mld_tpu/ops/attention.py:49-73``) and the CLIP tower's causal attention
kernel (port of ``sdpa_flash_causal``, ``attention.py:223-266``).

Layout is batch-first: q [B, H, Sq, Dh], k/v [B, H, Sk, Dh]. Padded keys are
filled with -1e9, not -inf, so that a fully masked row stays finite; scores
and softmax are f32 whatever the input dtype.

``sdpa_flash_causal`` is the wrapper of the CUDA kernel
``csrc/flash_causal.cu`` (K4): CPU tensors take its plain version
``flash_causal_plain``; CUDA tensors launch the kernel or raise. The
bidirectional Pallas kernel (``sdpa_pallas``, K3) is not ported yet
(ROADMAP.md, queue 2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e9
MAX_CAUSAL_S = 128     # the CLIP context is 77
MAX_CAUSAL_DH = 128
SMEM_LIMIT = 227 * 1024

# kernel launches made by sdpa_flash_causal (CUDA only)
LAUNCHES = 0


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """key_valid: [B, Sk] bool (True = attend). Returns [B, H, Sq, Dh]."""
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


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


def _smem_bytes(S: int, Dh: int) -> int:
    sp = -(-S // 4) * 4
    return 4 * (3 * sp * Dh + sp * sp)


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
            and Dh % 4 == 0) or _smem_bytes(S, Dh) > SMEM_LIMIT:
        raise ValueError(f"the causal kernel takes S <= {MAX_CAUSAL_S} and "
                         f"Dh a multiple of 4 up to {MAX_CAUSAL_DH} within "
                         f"{SMEM_LIMIT} bytes of shared memory "
                         f"(S={S}, Dh={Dh})")


def sdpa_flash_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float = 1.0) -> torch.Tensor:
    """Causal attention of the CLIP tower. q/k/v [B, H, S, Dh] -> [B, H, S,
    Dh] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation) or raise, also when autograd
    tracks an input (the kernel has no backward)."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_causal_plain(q, k, v, sm_scale)
    _build.check_no_grad("causal-attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no causal-attention kernel for device {q.device}")
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
    return out
