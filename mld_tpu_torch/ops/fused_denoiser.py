"""Inference forward of the latent denoiser over the fused encoder stack
(port of ``mld_tpu/ops/fused_denoiser.py``, the text conditions and an
action).

Everything around the stack (timestep sinusoid + MLP, the text projection
or the action table, learned PE, the final norm) is plain PyTorch; the
stack itself is ``ops.fused_layer.skip_encoder_stack`` (the CUDA kernel on
the card). ``can_fuse`` says which denoisers it serves; ``text_uncond``
is served as ``text``, as in JAX (``fused_denoiser.py:55``, ``64``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .embeddings import (DENOISER_FLIP_SIN_TO_COS, DENOISER_FREQ_SHIFT,
                         LEARNED_PE, get_timestep_embedding)
from .fused_layer import LN_EPS, MAX_S, skip_encoder_stack


def fusable(diffusion_only: bool, arch: str, skip_connect: bool,
            normalize_before: bool, position_embedding: str,
            activation: str, n_tokens: int) -> bool:
    """Whether K1 can serve a denoiser of this structure over `n_tokens`
    tokens: latent mode, trans_enc with skip connections, post-norm,
    learned PE and at most MAX_S tokens (``fused_denoiser.py:25-35``). K1
    computes gelu only (as the Pallas kernel does, which JAX's check does
    not ask), so a relu denoiser takes the module path."""
    return (not diffusion_only and arch == "trans_enc" and skip_connect
            and not normalize_before and position_embedding in LEARNED_PE
            and activation == "gelu" and n_tokens <= MAX_S)


def can_fuse(model_cfg, cond_tokens: int) -> bool:
    """``can_fuse`` of the JAX package read from the config's model section:
    `cond_tokens` is 77 when the denoiser conditions on every CLIP hidden
    state (``clip_last_hidden``), else 1."""
    m = model_cfg
    return fusable(not m.vae or m.vae_type == "no", m.denoiser_arch,
                   m.skip_connect, m.normalize_before, m.position_embedding,
                   m.activation, m.latent_size + 1 + cond_tokens)


def time_embedding(denoiser, timesteps: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    # the sinusoid is text_encoded_dim wide for text, latent_dim for an
    # action (denoiser.py:101, 107), cast to the sample's dtype (l.156)
    t_sin = get_timestep_embedding(timesteps, denoiser.time_proj_dim,
                                   DENOISER_FLIP_SIN_TO_COS,
                                   DENOISER_FREQ_SHIFT)
    return denoiser.time_embedding(t_sin.to(dtype))


def cond_tokens(denoiser, cond: torch.Tensor, training: bool = False,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The condition tokens [B, S_cond, d]: for an action the table rows of
    the ids [B], CFG-zeroed in the first half when serving, and in training
    zeroed where `keep` [B] bool is False (EmbedAction's drop); for text the
    projected CLIP features."""
    if denoiser.condition == "action":
        return denoiser.emb_proj(cond, training, keep=keep)
    # emb_proj is Sequential(ReLU, Linear): the reference applies ReLU
    # before the projection (denoiser.py:161-163)
    if denoiser.emb_proj is None:
        return cond
    return denoiser.emb_proj(cond)


@torch.no_grad()
def precompute_cond(denoiser, timesteps: torch.Tensor,
                    encoder_hidden_states: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step-invariant preamble, computed once per generate call: the
    time-embedding table [n_steps, d] and the projected condition tokens
    [B, S_cond, d] (an action's: [B, 1, d], the uncond half zeroed under
    guidance)."""
    return (time_embedding(denoiser, timesteps),
            cond_tokens(denoiser, encoder_hidden_states))


@torch.no_grad()
def fused_denoiser_forward(denoiser, sample: torch.Tensor,
                           timestep, encoder_hidden_states: torch.Tensor,
                           time_emb: Optional[torch.Tensor] = None,
                           cond_lat: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """sample [B, L, d]; encoder_hidden_states [B, S_text, text_dim], or
    [B] action ids. time_emb [d] and cond_lat [B, S_cond, d] come from
    precompute_cond (both or neither). Returns [B, L, d] in the sample's
    dtype.

    The preamble computes in the sample's dtype, as JAX's does. The stack
    takes f32 activations: a bf16 sample (a mixed-precision step's
    validation, on bf16 copies of the parameters) enters it in f32 with
    the matrices of those copies in bf16, K1's bf16-weight arm."""
    B, L, D = sample.shape
    if time_emb is None:
        timesteps = torch.as_tensor(timestep, device=sample.device)
        time_emb = time_embedding(denoiser, timesteps.expand(B),
                                  sample.dtype)[:, None]
        cond_lat = cond_tokens(denoiser, encoder_hidden_states)
    else:
        time_emb = time_emb.to(sample.dtype).reshape(1, 1, D).expand(B, 1, D)
    xseq = torch.cat([sample, time_emb, cond_lat], dim=1)
    xseq = xseq + denoiser.query_pos.pe[: xseq.shape[1], 0][None]

    enc = denoiser.encoder
    x = skip_encoder_stack(xseq.float().contiguous(),
                           denoiser.stacked_encoder(), len(enc.input_blocks),
                           enc.num_heads)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) / torch.sqrt(var + LN_EPS) * enc.norm.weight + enc.norm.bias
    return x[:, :L].to(sample.dtype)
