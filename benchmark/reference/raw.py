"""The raw-motion sampler (MLD without a VAE, ``novae_humanml3d``): the
trans_dec denoiser over the motion frames themselves, classifier-free
guidance over the doubled batch (uncond half first) and ancestral DDPM over
every train timestep.

The denoiser, for frames x [N, T, nfeats] at timestep t under the condition
features c [N, 1, 768]:
  tgt    = x @ pose_embd + query_pos[:T]
  memory = [time token; relu(c) @ emb_proj.1] + mem_pos[:2]
  the time token: the cos-first sinusoid of t (no frequency shift), then
           Linear, SiLU, Linear
  layers post-norm decoder layers: self-attention over all T frames (no key
           mask), cross-attention to the two memory tokens, an exact-gelu
           FFN; LayerNorm eps ``denoiser_ln_eps``
  out    = LayerNorm(decoder.norm) @ pose_proj, zero outside the frame mask.
DDPM (diffusers' ``DDPMScheduler``, epsilon prediction, ``fixed_small``
variance, ``scaled_linear`` betas): x0 = (x - sqrt(1 - a_t) eps) / sqrt(a_t),
the posterior mean sqrt(a_prev) b_t / (1 - a_t) x0 + sqrt(1 - b_t) (1 -
a_prev) / (1 - a_t) x, plus sqrt(b_t (1 - a_prev) / (1 - a_t)) times a
standard normal draw (none at t = 0), one draw a step.

Departures from the published description, each the program's as well:
``num_train_timesteps`` is the configuration's (100 where the published
1000 would take too long to profile; the schedule keeps its beta range);
the padded frames are neither masked as keys nor reset between steps (the
denoiser's output is zeroed there and the update carries them as noise),
as the reference implementation does; every step's draw is taken from one
seeded ``torch.Generator`` on the program's device, in step order, so that
the program's noise is replayed exactly. Weights are read by their
reference torch names under ``denoiser.``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .arith import attention, layer_norm, linear

P = "denoiser."


def schedule(n_train: int, beta_start: float, beta_end: float) -> tuple:
    """(betas, alphas, alphas_cumprod) of the scaled-linear betas, computed
    in float64 and kept in f32."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_train,
                        dtype=np.float64) ** 2
    return (betas.astype(np.float32), (1.0 - betas).astype(np.float32),
            np.cumprod(1.0 - betas).astype(np.float32))


def ddpm_step(eps: torch.Tensor, t: int, x: torch.Tensor, sched: tuple,
              noise: torch.Tensor) -> torch.Tensor:
    """x_t -> x_{t-1} with the fixed_small variance; the scalar
    coefficients in numpy f32."""
    f = np.float32
    betas, alphas, ac = sched
    a_t = ac[t]
    a_prev = ac[t - 1] if t > 0 else f(1.0)
    x0 = (x - float(np.sqrt(f(1.0) - a_t)) * eps) / float(np.sqrt(a_t))
    mean = (float(np.sqrt(a_prev) * betas[t] / (f(1.0) - a_t)) * x0
            + float(np.sqrt(alphas[t]) * (f(1.0) - a_prev) / (f(1.0) - a_t))
            * x)
    if t == 0:
        return mean
    var = max(betas[t] * (f(1.0) - a_prev) / (f(1.0) - a_t), f(1e-20))
    return mean + float(np.sqrt(var)) * noise


def time_token(w: dict, t: int, width: int, device, mode: str):
    """The time token [1, 1, d]."""
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


def _mha(w, name, q_in, kv_in, heads, mode):
    N, Sq, D = q_in.shape
    W, b = w[name + "in_proj_weight"], w[name + "in_proj_bias"]
    q = linear(q_in, W[:D], b[:D], mode)
    k = linear(kv_in, W[D:2 * D], b[D:2 * D], mode)
    v = linear(kv_in, W[2 * D:], b[2 * D:], mode)

    def split(a):
        return a.reshape(N, a.shape[1], heads, D // heads).transpose(1, 2)

    o = attention(split(q), split(k), split(v), None, mode)
    return linear(o.transpose(1, 2).reshape(N, Sq, D),
                  w[name + "out_proj.weight"], w[name + "out_proj.bias"],
                  mode)


def decoder_layer(w, name, x, memory, heads, eps, mode):
    def norm(h, i):
        return layer_norm(h, w[f"{name}norm{i}.weight"],
                          w[f"{name}norm{i}.bias"], eps)

    x = norm(x + _mha(w, name + "self_attn.", x, x, heads, mode), 1)
    x = norm(x + _mha(w, name + "multihead_attn.", x, memory, heads, mode), 2)
    h = F.gelu(linear(x, w[name + "linear1.weight"], w[name + "linear1.bias"],
                      mode))
    return norm(x + linear(h, w[name + "linear2.weight"],
                           w[name + "linear2.bias"], mode), 3)


def cond_tokens(w: dict, cond: torch.Tensor, mode: str) -> torch.Tensor:
    """relu then the projection of the [N, 1, 768] condition features."""
    return linear(torch.relu(cond), w[P + "emb_proj.1.weight"],
                  w[P + "emb_proj.1.bias"], mode)


def denoise(w: dict, x: torch.Tensor, t: int, cond_tok: torch.Tensor,
            mask: torch.Tensor, c: dict, mode: str) -> torch.Tensor:
    """The denoiser's output for frames x [N, T, nfeats] at step t, zero
    outside mask [N, T]."""
    N, T, _ = x.shape
    D = cond_tok.shape[-1]
    tt = time_token(w, t, c["time_proj_dim"], x.device, mode)
    memory = (torch.cat([tt.expand(N, 1, D), cond_tok], dim=1)
              + w[P + "mem_pos.pe"][:2, 0])
    h = (linear(x, w[P + "pose_embd.weight"], w[P + "pose_embd.bias"], mode)
         + w[P + "query_pos.pe"][:T, 0])
    for i in range(c["denoiser_layers"]):
        h = decoder_layer(w, f"{P}decoder.layers.{i}.", h, memory,
                          c["heads"], c["denoiser_ln_eps"], mode)
    h = layer_norm(h, w[P + "decoder.norm.weight"], w[P + "decoder.norm.bias"],
                   c["denoiser_ln_eps"])
    out = linear(h, w[P + "pose_proj.weight"], w[P + "pose_proj.bias"], mode)
    return out * mask[..., None]


def sample(w: dict, cond: torch.Tensor, init: torch.Tensor,
           mask: torch.Tensor, noise_seed: int, c: dict, mode: str,
           block: int = 64) -> torch.Tensor:
    """The guided ancestral DDPM loop from init [B, T, nfeats] under the
    condition [2B, 1, 768] (uncond half first) -> the final frames, every
    step's noise [B, T, nfeats] drawn in turn from a generator seeded with
    `noise_seed` on init's device. The denoiser runs over blocks of `block`
    motions (with their uncond rows)."""
    sched = schedule(c["train_steps"], c["beta_start"], c["beta_end"])
    g = torch.Generator(device=init.device)
    g.manual_seed(int(noise_seed))
    B = init.shape[0]
    tok = cond_tokens(w, cond, mode)
    x = init.float()
    for t in range(c["train_steps"] - 1, -1, -1):
        eps = []
        for i in range(0, B, block):
            j = min(i + block, B)
            rows = torch.cat([x[i:j], x[i:j]])
            out = denoise(w, rows, t, torch.cat([tok[i:j], tok[B + i:B + j]]),
                          torch.cat([mask[i:j], mask[i:j]]), c, mode)
            u, tc = out.chunk(2)
            eps.append(u + c["guidance_scale"] * (tc - u))
        noise = torch.randn(x.shape, generator=g, device=x.device)
        x = ddpm_step(torch.cat(eps), t, x, sched, noise)
    return x
