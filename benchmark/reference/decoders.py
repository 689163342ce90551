"""The two motion decoders, latent [B, 1, d] + frame mask [B, T] ->
features [B, T, nfeats], zero outside the mask.

MLD VAE (``vae.``): zero frame queries plus the learned decoder PE through
the U-Net-skip decoder stack (post-norm layers: self-attention under the
key mask, cross-attention to the latent, exact-gelu FFN) and its final
LayerNorm, then ``final_layer``.
ACTOR (``vae.decoder.``): zero queries plus the fixed interleaved sinusoid
through a plain post-norm decoder stack without a final norm, then
``final_layer``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .arith import attention, layer_norm, linear
from .latent import skip_stack


def _mha(w, name, q_in, kv_in, key_valid, heads, mode):
    B, Sq, D = q_in.shape
    W, b = w[name + "in_proj_weight"], w[name + "in_proj_bias"]
    q = linear(q_in, W[:D], b[:D], mode)
    k = linear(kv_in, W[D:2 * D], b[D:2 * D], mode)
    v = linear(kv_in, W[2 * D:], b[2 * D:], mode)

    def split(t):
        return t.reshape(B, t.shape[1], heads, D // heads).transpose(1, 2)

    o = attention(split(q), split(k), split(v), key_valid, mode)
    return linear(o.transpose(1, 2).reshape(B, Sq, D),
                  w[name + "out_proj.weight"], w[name + "out_proj.bias"],
                  mode)


def decoder_layer(w, name, x, memory, mask, heads, eps, mode):
    def norm(h, i):
        return layer_norm(h, w[f"{name}norm{i}.weight"],
                          w[f"{name}norm{i}.bias"], eps)

    x = norm(x + _mha(w, name + "self_attn.", x, x, mask, heads, mode), 1)
    x = norm(x + _mha(w, name + "multihead_attn.", x, memory, None, heads,
                      mode), 2)
    h = F.gelu(linear(x, w[name + "linear1.weight"], w[name + "linear1.bias"],
                      mode))
    return norm(x + linear(h, w[name + "linear2.weight"],
                           w[name + "linear2.bias"], mode), 3)


def sine_table(T: int, d: int) -> np.ndarray:
    """The interleaved sin / cos PE [T, d], in numpy f32."""
    pe = np.zeros((T, d), np.float32)
    pos = np.arange(T, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def mld_decode(w, z, mask, c, mode, block: int = 128):
    out = []
    for i in range(0, z.shape[0], block):
        zb, mb = z[i:i + block], mask[i:i + block]
        B, T = mb.shape
        x = w["vae.query_pos_decoder.pe"][:T, 0].expand(B, T, -1)

        def layer(name, h):
            return decoder_layer(w, name, h, zb, mb, c["heads"],
                                 c["decoder_ln_eps"], mode)

        x = skip_stack(w, "vae.decoder.", x, c["vae_layers"], c["heads"],
                       c["decoder_ln_eps"], mode, layer)
        out.append(linear(x, w["vae.final_layer.weight"],
                          w["vae.final_layer.bias"], mode) * mb[..., None])
    return torch.cat(out)


def actor_decode(w, z, mask, c, mode, block: int = 128):
    out = []
    p = "vae.decoder."
    for i in range(0, z.shape[0], block):
        zb, mb = z[i:i + block], mask[i:i + block]
        B, T = mb.shape
        d = zb.shape[-1]
        x = torch.as_tensor(sine_table(T, d), device=zb.device).expand(B, T, d)
        for j in range(c["vae_layers"]):
            x = decoder_layer(w, f"{p}seqTransDecoder.layers.{j}.", x, zb, mb,
                              c["heads"], c["decoder_ln_eps"], mode)
        out.append(linear(x, w[p + "final_layer.weight"],
                          w[p + "final_layer.bias"], mode) * mb[..., None])
    return torch.cat(out)
