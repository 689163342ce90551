"""The work of each kernel call: floating-point operations and bytes, from
shapes alone, and the per-kernel operation counters the wrappers add to
where they launch.

The kernels are launched through ctypes (``ops/_build.py``), not as
dispatcher ops, so ``torch.utils.flop_counter.FlopCounterMode`` does not
see them. Each wrapper therefore adds its call's count to ``FLOPS[name]``
beside its launch counter, where it launches and nowhere else; on the CPU
the plain versions run as aten ops and the mode counts them
(``utils/flops.py`` sums the two). A counter counts the products of the
kernel's function as its plain version computes them (a product of m x k
by k x n is 2 m k n), so that a stage counts alike on the card and on the
CPU: attention over every key, masked or not, and the causal attention's
whole S x S score matrix.

``encoder_work``, ``decoder_work`` and ``flash_work`` are the work a
function needs (attention over the keys the output reads), with the bytes
it must move, from which ``chip_smoke.py`` takes each kernel's bound.
"""
from __future__ import annotations

from collections import Counter

import torch

# operations the kernels launched, by wrapper (CUDA only)
FLOPS: Counter = Counter()


def add(name: str, flops: int):
    FLOPS[name] += int(flops)


def encoder_flops(n_seq: int, s: int, d: int, ff: int, n_block: int) -> int:
    """K1 (K2 at n_block = 0) on n_seq sequences of s tokens, width d, FFN
    ff, 2 n_block + 1 layers: per layer the QKV and out projections (4 d^2)
    and the FFN (2 d ff) a row, and s x s attention a sequence; a skip
    linear (2d -> d) a row for each of the n_block output blocks."""
    L, rows = 2 * n_block + 1, n_seq * s
    return (2 * rows * (L * (4 * d * d + 2 * d * ff) + n_block * 2 * d * d)
            + 4 * n_seq * s * s * d * L)


def weight_bytes(st, packed) -> int:
    """Bytes of a stack's weights, each once: the copies of its matrices in
    the kernel's order (`packed`) are not counted again."""
    return sum(t.numel() * t.element_size()
               for f, t in st._asdict().items() if f not in packed)


def encoder_work(n_seq: int, n_block: int, st, s: int, d: int, ff: int):
    """(flops, bytes) of K1: encoder_flops; the stacked weights, x in and
    out (f32)."""
    from .fused_layer import _PACKED
    return (encoder_flops(n_seq, s, d, ff, n_block),
            weight_bytes(st, _PACKED) + 2 * n_seq * s * d * 4)


def decoder_plain_flops(B: int, T: int, M: int, D: int, F: int,
                        n_block: int) -> int:
    """K5's products as its plain version computes them
    (``skip_decoder_stack_plain``), a layer: the self-attention's QKV and
    out projections a row and its T x T attention a sequence; the
    cross-attention's query and out projections a row, the latent tokens'
    key and value projections, the T x M attention; the FFN a row; a skip
    linear (2D -> D) a row for each output block."""
    L, rows = 2 * n_block + 1, B * T
    layer = (2 * rows * (6 * D * D + 2 * D * F) + 4 * B * M * D * D
             + 4 * B * T * T * D + 4 * B * T * M * D)
    return L * layer + n_block * 4 * rows * D * D


def decoder_work(tgt, mem, valid, st):
    """(weight flops, attention flops, bytes) of one K5 call, the work its
    function needs: a row's self-attention QKV and out-projections (4 D^2)
    and FFN (2 D F) a layer; the cross-attention at M = 1 as its value
    projection and out-projection once a sequence (its output is the value
    row), otherwise a row's query and out-projections and the latent
    tokens' key and value projections; a skip linear (2D -> D) a row for
    each output block; the attention products: self-attention over each
    example's valid frames (key 0 always) and, at M > 1, cross-attention to
    M tokens. Bytes: the stacked weights, tgt, mem and the mask in, the
    output."""
    from .fused_seq_decoder import _PACKED
    B, T, D = tgt.shape
    M = mem.shape[1]
    F = st.w1.shape[-1]
    L, n_block = st.w1.shape[0], st.wsx.shape[0]
    rows = B * T
    keys = T * valid.sum(1).clamp(min=1).sum().item()
    cross = (2 * B * 2 * D * D if M == 1
             else 2 * rows * 2 * D * D + 2 * B * M * 2 * D * D)
    weights = (L * (2 * rows * (4 * D * D + 2 * D * F) + cross)
               + n_block * 2 * rows * 2 * D * D)
    attn = L * (4 * D * keys + (4 * rows * M * D if M > 1 else 0))
    nbytes = (weight_bytes(st, _PACKED) + 2 * tgt.numel() * 4
              + mem.numel() * 4 + valid.numel() * valid.element_size())
    return weights, attn, nbytes


def attention_flops(heads: int, sq: int, dh: int, keys: int) -> int:
    """Q.K^T and P.V of `heads` heads of sq queries against `keys` keys
    (summed over the batch)."""
    return 4 * heads * sq * dh * keys


def flash_work(q, k, valid):
    """(flops, bytes) of K3: Q.K^T and P.V over the keys the output needs
    (an example's valid keys; all Sk where none is valid), q, k, v and the
    mask read, the output written."""
    B, H, Sq, Dh = q.shape
    Sk = k.shape[2]
    if valid is None:
        keys = B * Sk
    else:
        n = valid.sum(1)
        keys = n.masked_fill(n == 0, Sk).sum().item()
    nbytes = (q.element_size() * B * H * Dh * (2 * Sq + 2 * Sk)
              + (valid.numel() if valid is not None else 0))
    return attention_flops(H, Sq, Dh, keys), nbytes


def dense_attention_flops(q: torch.Tensor, k: torch.Tensor) -> int:
    """K3's or K4's counted operations: attention_flops over every key."""
    B, H, Sq, Dh = q.shape
    return attention_flops(H, Sq, Dh, B * k.shape[2])
