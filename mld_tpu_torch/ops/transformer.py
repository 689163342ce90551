"""DETR-style transformer stack (port of ``mld_tpu/ops/transformer.py``),
batch-first and mask-driven, post-norm or, with ``normalize_before``,
pre-norm.

Module and parameter names follow the reference torch modules
(mld/models/operator/cross_attention.py:18-382): ``input_blocks.N``,
``middle_block``, ``output_blocks.N``, ``linear_blocks.N``, ``layers.N``,
``norm``, and
``self_attn.in_proj_weight`` / ``out_proj`` inside each layer, so a reference
``state_dict`` loads with a plain ``load_state_dict``.

LayerNorm epsilon mirrors the JAX path each module is held against: the flax
modules use flax's default 1e-6 (``transformer.py:101-102``, ``142-144``,
``199``, ``235``), which is what these modules default to. The fused
denoiser path uses 1e-5 (``ops/fused_layer.py``).

``Linear`` and ``LayerNorm`` compute in the promoted dtype of their input and
parameters, as flax's ``Dense`` and ``LayerNorm`` (``dtype=None``) do, with
LayerNorm's statistics in f32: under bf16 mixed-precision training
(``train/steps.py``) an f32 activation meeting bf16 weights computes in f32,
as in the JAX package (the ACTOR VAE after its f32 sine PE).

Pre-norm layers (``normalize_before``, ``transformer.py:85-160``) normalise
each sublayer's input, ``x + drop(attn(norm1(x)))`` and so on, and end
without a norm; the skip stacks keep their final ``norm`` either way, the
plain stacks theirs where they have one. Parameter names do not change.

Dropout (rate ``dropout``, the config's ``model.dropout``) is applied where
the JAX layers apply it (``transformer.py:72-79``, ``103-117``, ``145-160``):
on the attention probabilities, after each attention, after the FFN's
activation and after the FFN. It is on only in a forward given a
``generator``, the counterpart of flax's ``dropout`` rng: the training
steps pass one, serving and evaluation do not. Without one the forward is
the inference forward, unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.precision import linear

from .attention import sdpa
from .dropout import dropout as _dropout
from .dropout import sharded

FLAX_LN_EPS = 1e-6


def get_activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu  # exact (erf) gelu
    raise ValueError(f"activation {name} not supported")


def _promoted(x: torch.Tensor, *params: Optional[torch.Tensor]):
    """x and params in their promoted dtype (each unchanged when it has
    it)."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return x.to(dt), *(None if p is None else p.to(dt) for p in params)


class Linear(nn.Linear):
    """``nn.Linear`` in the promoted dtype of input and weights (flax's
    ``Dense``), its f32 GEMM at the matmul precision in force
    (``utils/precision.py:linear``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(*_promoted(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with f32 statistics and its output in the promoted
    dtype of input and params (flax's ``LayerNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype == torch.float32:
            return super().forward(x)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(dt)


class MultiheadAttention(nn.Module):
    """Packed-QKV multi-head attention with torch MHA's parameter names.

    Its width is the packed projection's rows / 3, and its heads
    ``num_heads``: a model axis keeps a rank's heads' rows and sets the
    heads it holds (``parallel/partition.py``), whose subclass replaces
    ``_inputs``."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model)

    def _inputs(self, query, key, value):
        return query, key, value

    def forward(self, query, key, value, key_valid=None, generator=None):
        d = self.in_proj_weight.shape[0] // 3
        self_attn = query is key and key is value
        query, key, value = self._inputs(query, key, value)
        query, w, b = _promoted(query, self.in_proj_weight, self.in_proj_bias)
        key, value = key.to(w.dtype), value.to(w.dtype)
        if self_attn:
            q, k, v = linear(query, w, b).split(d, dim=-1)
        else:
            q = linear(query, w[:d], b[:d])
            k = linear(key, w[d:2 * d], b[d:2 * d])
            v = linear(value, w[2 * d:], b[2 * d:])
        B, Sq, _ = query.shape
        H = self.num_heads

        def split(t):
            return t.reshape(B, t.shape[1], H, d // H).transpose(1, 2)

        out = sdpa(split(q), split(k), split(v), key_valid,
                   self.dropout if generator is not None else 0.0,
                   sharded(generator))
        return self.out_proj(out.transpose(1, 2).reshape(B, Sq, d))


class TransformerEncoderLayer(nn.Module):
    """Post- or pre-norm encoder layer (cross_attention.py:236-294)."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int = 2048,
                 activation: str = "gelu", eps: float = FLAX_LN_EPS,
                 dropout: float = 0.0, normalize_before: bool = False):
        super().__init__()
        self.dropout = dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout)
        self.linear1 = Linear(d_model, ff_size)
        self.linear2 = Linear(ff_size, d_model)
        self.norm1 = LayerNorm(d_model, eps=eps)
        self.norm2 = LayerNorm(d_model, eps=eps)
        self.activation = get_activation(activation)

    def forward(self, src, key_valid=None, generator=None):
        def drop(x):
            return _dropout(x, self.dropout, generator)

        def ffn(x):
            # the hidden is what a model axis shards (its own masks)
            h = _dropout(self.activation(self.linear1(x)), self.dropout,
                         sharded(generator))
            return drop(self.linear2(h))

        if self.normalize_before:
            x = self.norm1(src)
            src = src + drop(self.self_attn(x, x, x, key_valid, generator))
            return src + ffn(self.norm2(src))
        src = self.norm1(src + drop(self.self_attn(src, src, src, key_valid,
                                                   generator)))
        return self.norm2(src + ffn(src))


class TransformerDecoderLayer(nn.Module):
    """Post- or pre-norm decoder layer: self-attn over tgt, cross-attn to
    memory, FFN (cross_attention.py:297-382), each sublayer with its norm
    in a span of its own (``attn.self``, ``attn.cross``, ``ffn``;
    ``utils/trace.py``)."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int = 2048,
                 activation: str = "gelu", eps: float = FLAX_LN_EPS,
                 dropout: float = 0.0, normalize_before: bool = False):
        super().__init__()
        self.dropout = dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiheadAttention(d_model, num_heads, dropout)
        self.multihead_attn = MultiheadAttention(d_model, num_heads, dropout)
        self.linear1 = Linear(d_model, ff_size)
        self.linear2 = Linear(ff_size, d_model)
        self.norm1 = LayerNorm(d_model, eps=eps)
        self.norm2 = LayerNorm(d_model, eps=eps)
        self.norm3 = LayerNorm(d_model, eps=eps)
        self.activation = get_activation(activation)

    def forward(self, tgt, memory, tgt_valid=None, memory_valid=None,
                generator=None):
        def drop(x):
            return _dropout(x, self.dropout, generator)

        def ffn(x):
            # the hidden is what a model axis shards (its own masks)
            h = _dropout(self.activation(self.linear1(x)), self.dropout,
                         sharded(generator))
            return drop(self.linear2(h))

        if self.normalize_before:
            with trace.span("attn.self"):
                x = self.norm1(tgt)
                tgt = tgt + drop(self.self_attn(x, x, x, tgt_valid,
                                                generator))
            with trace.span("attn.cross"):
                x = self.norm2(tgt)
                tgt = tgt + drop(self.multihead_attn(x, memory, memory,
                                                     memory_valid, generator))
            with trace.span("ffn"):
                return tgt + ffn(self.norm3(tgt))
        with trace.span("attn.self"):
            tgt = self.norm1(tgt + drop(self.self_attn(tgt, tgt, tgt,
                                                       tgt_valid, generator)))
        with trace.span("attn.cross"):
            tgt = self.norm2(tgt + drop(self.multihead_attn(
                tgt, memory, memory, memory_valid, generator)))
        with trace.span("ffn"):
            return self.norm3(tgt + ffn(tgt))


class TransformerEncoder(nn.Module):
    """Plain stack of encoder layers (cross_attention.py:171-192;
    ``transformer.py:238-261``): modules ``layers.N`` and, with
    ``final_norm``, ``norm``. The default is no final norm, as the JAX
    package's, torch's ``nn.TransformerEncoder(norm=None)`` (the ACTOR
    VAE's encoder)."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_size: int = 1024, activation: str = "gelu",
                 eps: float = FLAX_LN_EPS, final_norm: bool = False,
                 dropout: float = 0.0, normalize_before: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, ff_size, activation,
                                    eps, dropout, normalize_before)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, eps=eps) if final_norm else None

    def forward(self, src, key_valid=None, generator=None):
        x = src
        for layer in self.layers:
            x = layer(x, key_valid, generator)
        return self.norm(x) if self.norm is not None else x


class TransformerDecoder(nn.Module):
    """Plain stack of decoder layers with a final norm
    (cross_attention.py:195-233; ``transformer.py:263-289``): modules
    ``layers.N`` and ``norm``. ``final_norm=False`` is torch's
    ``nn.TransformerDecoder(norm=None)``."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_size: int = 1024, activation: str = "gelu",
                 eps: float = FLAX_LN_EPS, final_norm: bool = True,
                 dropout: float = 0.0, normalize_before: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, num_heads, ff_size, activation,
                                    eps, dropout, normalize_before)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, eps=eps) if final_norm else None

    def forward(self, tgt, memory, tgt_valid=None, memory_valid=None,
                generator=None):
        x = tgt
        for layer in self.layers:
            x = layer(x, memory, tgt_valid, memory_valid, generator)
        return self.norm(x) if self.norm is not None else x


class _SkipStack(nn.Module):
    """(n-1)/2 down blocks, a middle block and (n-1)/2 up blocks whose input
    is concat([x, stack.pop()]) @ linear_blocks[i] (LIFO)."""

    def __init__(self, make_layer, d_model: int, num_layers: int,
                 eps: float):
        super().__init__()
        if num_layers % 2 != 1:
            raise ValueError("skip stack needs an odd num_layers")
        n_block = (num_layers - 1) // 2
        self.input_blocks = nn.ModuleList(make_layer() for _ in range(n_block))
        self.middle_block = make_layer()
        self.output_blocks = nn.ModuleList(make_layer() for _ in range(n_block))
        self.linear_blocks = nn.ModuleList(
            Linear(2 * d_model, d_model) for _ in range(n_block))
        self.norm = LayerNorm(d_model, eps=eps)

    def _run(self, x, layer_fn):
        stack = []
        for layer in self.input_blocks:
            x = layer_fn(layer, x)
            stack.append(x)
        x = layer_fn(self.middle_block, x)
        for linear, layer in zip(self.linear_blocks, self.output_blocks):
            x = linear(torch.cat([x, stack.pop()], dim=-1))
            x = layer_fn(layer, x)
        return self.norm(x)


class SkipTransformerEncoder(_SkipStack):
    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_size: int = 1024, activation: str = "gelu",
                 eps: float = FLAX_LN_EPS, dropout: float = 0.0,
                 normalize_before: bool = False):
        super().__init__(
            lambda: TransformerEncoderLayer(d_model, num_heads, ff_size,
                                            activation, eps, dropout,
                                            normalize_before),
            d_model, num_layers, eps)
        self.num_heads = num_heads

    def forward(self, src, key_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self._run(src, lambda layer, x: layer(x, key_valid,
                                                     generator))


class SkipTransformerDecoder(_SkipStack):
    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 ff_size: int = 1024, activation: str = "gelu",
                 eps: float = FLAX_LN_EPS, dropout: float = 0.0,
                 normalize_before: bool = False):
        super().__init__(
            lambda: TransformerDecoderLayer(d_model, num_heads, ff_size,
                                            activation, eps, dropout,
                                            normalize_before),
            d_model, num_layers, eps)
        self.num_heads = num_heads

    def forward(self, tgt, memory, tgt_valid=None, memory_valid=None,
                generator: Optional[torch.Generator] = None):
        return self._run(
            tgt, lambda layer, x: layer(x, memory, tgt_valid, memory_valid,
                                        generator))
