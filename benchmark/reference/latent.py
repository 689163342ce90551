"""The latent sampler: the U-Net-skip encoder denoiser over [z; t; cond]
(post-norm layers, exact gelu, learned PE, a final LayerNorm), classifier-
free guidance over the doubled batch (uncond half first) and DDIM (eta 0,
diffusers' ``scaled_linear`` schedule, ``set_alpha_to_one`` off, steps
offset 1).

Weights are read by their reference torch names under ``denoiser.``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .arith import attention, layer_norm, linear

P = "denoiser."


def schedule(n_train: int, beta_start: float, beta_end: float) -> np.ndarray:
    """alphas_cumprod of the scaled-linear betas, computed in float64 and
    kept in f32."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_train,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def timesteps(n_train: int, n_steps: int, offset: int) -> np.ndarray:
    ratio = n_train // n_steps
    return (np.arange(n_steps) * ratio).round()[::-1].astype(np.int64) \
        + offset


def ddim_step(eps: torch.Tensor, t: int, x: torch.Tensor, ac: np.ndarray,
              ratio: int) -> torch.Tensor:
    """x_t -> x_{t - ratio}, eta 0, epsilon prediction; the scalar
    coefficients in numpy f32."""
    f = np.float32
    a_t = ac[t]
    a_prev = ac[t - ratio] if t - ratio >= 0 else ac[0]
    x0 = (x - float(np.sqrt(f(1) - a_t)) * eps) / float(np.sqrt(a_t))
    return float(np.sqrt(a_prev)) * x0 + float(np.sqrt(f(1) - a_prev)) * eps


def time_token(w: dict, t: int, width: int, device, mode: str):
    """The time token [1, 1, d]: the cos-first sinusoid of t (no frequency
    shift), then Linear, SiLU, Linear."""
    half = width // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=device) / half)
    arg = float(t) * freqs
    sin = torch.cat([torch.cos(arg), torch.sin(arg)])[None]
    h = F.silu(linear(sin, w[P + "time_embedding.linear_1.weight"],
                      w[P + "time_embedding.linear_1.bias"], mode))
    return linear(h, w[P + "time_embedding.linear_2.weight"],
                  w[P + "time_embedding.linear_2.bias"], mode)[:, None]


def cond_tokens(w: dict, cond: torch.Tensor, guided: bool, mode: str):
    """Text: relu then the projection of [N, 1, 768] features. Action: the
    table rows of the ids [N], the first half zeroed under guidance."""
    if cond.dtype == torch.long:
        rows = w[P + "emb_proj.action_embedding"][cond]
        if guided:
            rows = torch.cat([torch.zeros_like(rows[: len(rows) // 2]),
                              rows[len(rows) // 2:]])
        return rows[:, None]
    return linear(torch.relu(cond), w[P + "emb_proj.1.weight"],
                  w[P + "emb_proj.1.bias"], mode)


def _layer(w: dict, name: str, x: torch.Tensor, heads: int, eps: float,
           mode: str) -> torch.Tensor:
    N, S, D = x.shape
    qkv = linear(x, w[name + "self_attn.in_proj_weight"],
                 w[name + "self_attn.in_proj_bias"], mode)
    q, k, v = (t.reshape(N, S, heads, D // heads).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    o = attention(q, k, v, None, mode).transpose(1, 2).reshape(N, S, D)
    x = layer_norm(x + linear(o, w[name + "self_attn.out_proj.weight"],
                              w[name + "self_attn.out_proj.bias"], mode),
                   w[name + "norm1.weight"], w[name + "norm1.bias"], eps)
    h = F.gelu(linear(x, w[name + "linear1.weight"], w[name + "linear1.bias"],
                      mode))
    return layer_norm(x + linear(h, w[name + "linear2.weight"],
                                 w[name + "linear2.bias"], mode),
                      w[name + "norm2.weight"], w[name + "norm2.bias"], eps)


def skip_stack(w: dict, p: str, x: torch.Tensor, n_layers: int, heads: int,
               eps: float, mode: str, layer=None) -> torch.Tensor:
    """The U-Net-skip stack under prefix `p`: (n-1)/2 input blocks, the
    middle block, (n-1)/2 output blocks, each fed concat([x, popped]) @
    linear_blocks[i]; then the final LayerNorm. `layer(name, x)` runs one
    layer (default: the encoder layer)."""
    layer = layer or (lambda name, h: _layer(w, name, h, heads, eps, mode))
    n = (n_layers - 1) // 2
    stack = []
    for i in range(n):
        x = layer(f"{p}input_blocks.{i}.", x)
        stack.append(x)
    x = layer(f"{p}middle_block.", x)
    for i in range(n):
        x = linear(torch.cat([x, stack.pop()], dim=-1),
                   w[f"{p}linear_blocks.{i}.weight"],
                   w[f"{p}linear_blocks.{i}.bias"], mode)
        x = layer(f"{p}output_blocks.{i}.", x)
    return layer_norm(x, w[p + "norm.weight"], w[p + "norm.bias"], eps)


def denoise(w: dict, x: torch.Tensor, t: int, cond_tok: torch.Tensor,
            c: dict, mode: str) -> torch.Tensor:
    """The denoiser's output for samples x [N, latent_size, d] at step t."""
    N, ls, D = x.shape
    tt = time_token(w, t, c["time_proj_dim"], x.device, mode)
    seq = torch.cat([x, tt.expand(N, 1, D), cond_tok], dim=1)
    seq = seq + w[P + "query_pos.pe"][: seq.shape[1], 0]
    out = skip_stack(w, P + "encoder.", seq, c["denoiser_layers"],
                     c["heads"], c["denoiser_ln_eps"], mode)
    return out[:, :ls]


def sample(w: dict, cond: torch.Tensor, init: torch.Tensor, c: dict,
           mode: str) -> torch.Tensor:
    """The 50-step guided DDIM loop from init [B, latent_size, d] under the
    condition [2B, ...] (uncond half first) -> the final latents."""
    ac = schedule(c["train_steps"], c["beta_start"], c["beta_end"])
    ts = timesteps(c["train_steps"], c["steps"], c["steps_offset"])
    ratio = c["train_steps"] // c["steps"]
    g = c["guidance_scale"]
    tok = cond_tokens(w, cond, g > 1.0, mode)
    x = init.float()
    for t in ts:
        out = denoise(w, torch.cat([x, x]), int(t), tok, c, mode)
        u, tc = out.chunk(2)
        x = ddim_step(u + g * (tc - u), int(t), x, ac, ratio)
    return x
