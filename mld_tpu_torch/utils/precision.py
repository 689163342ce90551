"""The measuring stick's precision: f32 matmuls, convolutions and RNNs
without TF32, as the JAX package pins its evaluator networks to "highest"
matmul precision so that serving-precision knobs never touch them."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_f32():
    """f32 matmuls, convolutions and RNNs without TF32 inside; the caller's
    settings are restored on the way out."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
