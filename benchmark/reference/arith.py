"""Products with their operands rounded to an arithmetic, on any device.

Modes: ``f32`` (no rounding; TF32 must be off, ``strict_f32``), ``tf32``
(10 mantissa bits, nearest even), ``bf16`` and ``fp8`` (e4m3 with one scale
a tensor, its largest magnitude at 448). Sums stay in f32 in every mode.
``BELOW`` names the arithmetic next below each, the control's.
"""
from __future__ import annotations

import contextlib

import torch

BELOW = {"f32": "tf32", "tf32": "bf16", "bf16": "fp8"}
FP8_MAX = 448.0


@contextlib.contextmanager
def strict_f32():
    """TF32 off for cuBLAS and cuDNN in the body, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rounded(x: torch.Tensor, mode: str) -> torch.Tensor:
    """f32 `x` rounded to `mode`, returned as f32."""
    if mode == "f32":
        return x
    if mode == "bf16":
        return x.bfloat16().float()
    if mode == "tf32":
        i = x.contiguous().view(torch.int32)
        return ((i + 0x0FFF + ((i >> 13) & 1)) & -8192).view(torch.float32)
    if mode == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown arithmetic {mode!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b with both operands rounded to `mode`, f32 sums."""
    return torch.matmul(rounded(a, mode), rounded(b, mode))


def linear(x: torch.Tensor, w: torch.Tensor, b=None, mode: str = "f32"):
    """x @ w.T + b (torch's [out, in] weight) in `mode`."""
    y = matmul(x, w.t(), mode)
    return y if b is None else y + b


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def attention(q, k, v, key_valid, mode: str, causal: bool = False):
    """softmax(q k^T / sqrt(Dh)) v over [B, H, S, Dh]; key_valid [B, Sk]
    bool or None; -1e9 at masked keys, f32 softmax."""
    scores = matmul(q, k.transpose(-1, -2), mode) * q.shape[-1] ** -0.5
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid[:, None, None, :], -1e9)
    if causal:
        S = q.shape[2]
        upper = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(upper, -1e9)
    return matmul(torch.softmax(scores, dim=-1), v, mode)
