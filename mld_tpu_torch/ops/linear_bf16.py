"""The serving precision's bf16 linear as one kernel (``csrc/linear_bf16.cu``).

``linear_bf16(x, w, b)`` is ``bf16(x) @ bf16(w).T + b`` for contiguous f32
CUDA tensors x [M, K], w [N, K] and b [N] (or None): both operands rounded
to bf16 to nearest even, products with f32 accumulation, the bias added to
the f32 sums, an f32 [M, N] result. It is the forward of
``utils/precision.py:_ReducedLinear`` on the card under the bf16 arithmetic
("default"), in place of two casts, a cuBLAS GEMM and a broadcast add. It
launches on the current stream, synchronises nothing and allocates only its
output, so a CUDA graph captures it. It ports no Pallas kernel: the JAX
package leaves its dots to XLA.

Its plain version is the CPU's reduced linear,
``utils/precision.py:linear_plain`` in bf16 (the operands rounded on the
bits, an f32 product, the bias added after), to which ``chip_smoke.py``,
the card test and ``scripts/bench_linear_bf16.py`` hold the kernel.

The wrapper raises on anything but contiguous f32 CUDA operands of one
device and matching shapes; the CPU computes this linear through
``precision._mm`` and never calls it. Launches count under
``COUNTS["launch.lin.bf16"]`` and their operations (2 M N K) under
``COUNTS["flops.lin"]`` (``utils/trace.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.trace import COUNTS
from . import _build


def _takes(x, w, b) -> bool:
    """Whether the kernel takes these operands (one expression: the check
    runs on every launch of a host-paced loop)."""
    f32 = torch.float32
    return (x.is_cuda and x.dtype == f32 and w.dtype == f32
            and w.device == x.device and x.dim() == 2 and w.dim() == 2
            and x.shape[1] == w.shape[1] and x.is_contiguous()
            and w.is_contiguous() and max(x.shape[0], w.shape[0],
                                          x.shape[1]) < 2 ** 31
            and (b is None or (b.dtype == f32 and b.device == x.device
                               and b.shape == (w.shape[0],)
                               and b.is_contiguous())))


def _refuse(x, w, b):
    """The ValueError that says which operand the kernel does not take."""
    ops = (("x", x), ("w", w)) + ((("b", b),) if b is not None else ())
    for name, t in ops:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"the bf16 linear kernel takes f32 CUDA tensors;"
                             f" {name} is {t.dtype} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"the bf16 linear kernel takes contiguous "
                             f"operands; {name} has strides {t.stride()}")
    raise ValueError(f"want x [M, K], w [N, K], b [N], dims below 2^31; got "
                     f"x {tuple(x.shape)}, w {tuple(w.shape)}, b "
                     f"{None if b is None else tuple(b.shape)}")


def linear_bf16(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on the current stream: an f32 [M, N] tensor (M = 0 gives
    an empty one and launches nothing). Raises on operands it does not take
    and on a failed launch."""
    if not _takes(x, w, b):
        _refuse(x, w, b)
    (M, K), N = x.shape, w.shape[0]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    lib = _build.library()
    args = (x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), M, N, K)
    if x.device.index == torch.cuda.current_device():
        err = lib.mld_linear_bf16_forward(
            *args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = lib.mld_linear_bf16_forward(
                *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bf16 linear kernel launch failed: cudaError "
                           f"{err}")
    COUNTS["launch.lin.bf16"] += 1
    COUNTS["flops.lin"] += 2 * M * N * K
    return y
