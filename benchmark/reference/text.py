"""The text condition: the crc32 fallback tokenizer with its EOT buckets,
and the CLIP ViT-L/14 text tower (HuggingFace ``CLIPTextModelWithProjection``
semantics: pre-norm causal layers, quick-gelu, EOT pooling, projection).

Weights are read by their reference torch names under ``clip.``.
"""
from __future__ import annotations

import re
import zlib

import numpy as np
import torch

from .arith import attention, layer_norm, linear

BOS, EOS, CONTEXT = 49406, 49407, 77
_WORD = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


def tokenize(texts, buckets) -> np.ndarray:
    """texts -> int64 [B, L]: BOS, one id a word (crc32 mod BOS - 1, plus
    1), EOS, EOS padding to 77; cut to the smallest bucket that holds
    every row's EOS (all 77 when none does or `buckets` is empty)."""
    out = np.full((len(texts), CONTEXT), EOS, np.int64)
    for i, text in enumerate(texts):
        words = _WORD.findall(text.lower())[: CONTEXT - 2]
        ids = ([BOS] + [zlib.crc32(w.encode()) % (BOS - 1) + 1
                        for w in words] + [EOS])
        out[i, : len(ids)] = ids
    if buckets:
        eot = int(out.argmax(axis=1).max())
        out = out[:, : next((b for b in sorted(buckets) if b > eot),
                            CONTEXT)]
    return out


def features(w: dict, ids: torch.Tensor, layers: int, heads: int,
             eps: float, mode: str) -> torch.Tensor:
    """ids [B, L] -> projected EOT features [B, width]."""
    p = "clip.text_model."
    B, L = ids.shape
    x = (w[p + "embeddings.token_embedding.weight"][ids]
         + w[p + "embeddings.position_embedding.weight"][:L])
    D = x.shape[-1]
    for i in range(layers):
        q_ = f"{p}encoder.layers.{i}."

        def lin(h, name):
            return linear(h, w[q_ + name + ".weight"],
                          w[q_ + name + ".bias"], mode)

        h = layer_norm(x, w[q_ + "layer_norm1.weight"],
                       w[q_ + "layer_norm1.bias"], eps)

        def split(t):
            return t.reshape(B, L, heads, D // heads).transpose(1, 2)

        o = attention(split(lin(h, "self_attn.q_proj")),
                      split(lin(h, "self_attn.k_proj")),
                      split(lin(h, "self_attn.v_proj")), None, mode,
                      causal=True)
        x = x + lin(o.transpose(1, 2).reshape(B, L, D), "self_attn.out_proj")
        h = layer_norm(x, w[q_ + "layer_norm2.weight"],
                       w[q_ + "layer_norm2.bias"], eps)
        h = lin(h, "mlp.fc1")
        x = x + lin(h * torch.sigmoid(1.702 * h), "mlp.fc2")
    x = layer_norm(x, w[p + "final_layer_norm.weight"],
                   w[p + "final_layer_norm.bias"], eps)
    pooled = x[torch.arange(B, device=x.device), ids.argmax(dim=1)]
    return linear(pooled, w["clip.text_projection.weight"], None, mode)


def condition(w: dict, ids: torch.Tensor, uncond_ids: torch.Tensor,
              layers: int, heads: int, eps: float, mode: str,
              block: int = 128) -> torch.Tensor:
    """The CFG condition [2B, 1, width]: the empty prompt's row for the
    first half, the prompts' rows for the second, in blocks of rows."""
    rows = [features(w, ids[i:i + block], layers, heads, eps, mode)
            for i in range(0, ids.shape[0], block)]
    uncond = features(w, uncond_ids, layers, heads, eps, mode)
    cond = torch.cat(rows)
    return torch.cat([uncond.expand_as(cond), cond])[:, None, :]
