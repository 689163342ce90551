"""The denoisers (port of ``mld_tpu/models/denoiser.py``): ``MldDenoiser``,
the latent-space ``trans_enc`` with skip connections, conditioned on text
or on an action class (``EmbedAction``), and ``RawMotionDenoiser``, the
``trans_dec`` denoiser of raw motion (``diffusion_only``, the no-VAE
presets, text only).

Token sequence: [sample tokens ; time token ; condition token(s)], sample
first (mld_denoiser.py:187). The module holds the parameters under the
reference torch names (``time_embedding.linear_1``, ``emb_proj.1`` for text,
``emb_proj.action_embedding`` for an action, ``query_pos.pe``,
``encoder.*``). The timestep sinusoid is ``text_encoded_dim`` wide for text
and ``latent_dim`` wide for an action (``denoiser.py:101``, ``107``):
``time_proj_dim``. It has two forwards, as the JAX package's denoiser has
(``mld_tpu/models/mld.py:372-396``): ``forward``, the module path (the
plain ``SkipTransformerEncoder``, flax's LayerNorm eps 1e-6, dropout,
differentiable), which training always takes; and ``fused_forward``, the
serving forward over K1 (``ops.fused_denoiser``, eps 1e-5, no grad).
``MLD.denoise`` chooses between them.

The encoder's per-layer weights are stacked for the kernel whenever
parameters are loaded or moved (``restack``), never per call. An optimizer
step changes the parameters in place and leaves the stack stale: the
training step drops it (``drop_stack``) and the next K1 call rebuilds it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mld_tpu_torch.ops.embeddings import (PositionEmbeddingLearned1D,
                                          TimestepEmbedding)
from mld_tpu_torch.ops.fused_denoiser import (cond_tokens,
                                              fused_denoiser_forward,
                                              time_embedding)
from mld_tpu_torch.ops.fused_layer import (MAX_S, StackedSkipEncoder,
                                           stack_skip_encoder)
from mld_tpu_torch.ops.transformer import (SkipTransformerEncoder,
                                           TransformerDecoder)


class EmbedAction(nn.Module):
    """The action-class embedding with classifier-free-guidance masking
    (reference mld_denoiser.py:231-279; ``denoiser.py:31-65``): ids [B] ->
    [B, 1, latent_dim].

    Serving with guidance (scale > 1) zeroes the first half of the batch,
    the uncond half of the doubled CFG batch; without guidance every row is
    real. In training the rows are kept with probability 1 -
    ``guidance_uncondp`` and zeroed otherwise, drawn from `generator` (no
    draw, no drop, without one), or as `keep` [B] bool gives them."""

    def __init__(self, num_actions: int, latent_dim: int,
                 guidance_scale: float = 7.5, guidance_uncondp: float = 0.1):
        super().__init__()
        self.guidance_scale = guidance_scale
        self.guidance_uncondp = guidance_uncondp
        self.action_embedding = nn.Parameter(torch.empty(num_actions,
                                                         latent_dim))

    def forward(self, action_ids: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        ids = action_ids.reshape(-1).to(self.action_embedding.device,
                                        torch.long)
        out = self.action_embedding[ids]
        B = out.shape[0]
        if training:
            if keep is None and self.guidance_uncondp > 0.0 \
                    and generator is not None:
                keep = torch.rand((B,), generator=generator,
                                  device=generator.device) \
                    < 1.0 - self.guidance_uncondp
            if keep is not None:
                out = out * keep.to(out.device, out.dtype)[:, None]
        elif self.guidance_scale > 1.0:
            out = torch.cat([torch.zeros_like(out[: B // 2]),
                             out[B // 2:]])
        return out[:, None, :]


def _time_token(module, timestep, sample: torch.Tensor) -> torch.Tensor:
    """The time token [B, 1, d] of a host integer or a [B] / scalar tensor
    timestep, in the sample's dtype."""
    B = sample.shape[0]
    if isinstance(timestep, torch.Tensor):
        timesteps = timestep.to(sample.device).expand(B)
    else:   # a host integer: filled on the device, no copy to wait for
        timesteps = torch.full((B,), int(timestep), device=sample.device)
    return time_embedding(module, timesteps, sample.dtype)[:, None]


class MldDenoiser(nn.Module):
    def __init__(self, latent_size: int = 1, latent_dim: int = 256,
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, text_encoded_dim: int = 768,
                 pe_max_len: int = 500, activation: str = "gelu",
                 weight_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, condition: str = "text",
                 nclasses: int = 10, guidance_scale: float = 7.5,
                 guidance_uncondp: float = 0.1):
        super().__init__()
        if condition not in ("text", "action"):
            raise ValueError(f"condition {condition} not supported")
        if activation != "gelu":
            raise ValueError("the fused denoiser stack computes gelu only")
        if latent_size + 2 > MAX_S:
            raise ValueError(f"latent_size {latent_size} exceeds the fused "
                             f"stack's {MAX_S} tokens")
        self.latent_dim = latent_dim
        self.text_encoded_dim = text_encoded_dim
        self.condition = condition
        self.weight_dtype = weight_dtype
        if condition == "action":
            self.time_proj_dim = latent_dim
            self.emb_proj = EmbedAction(nclasses, latent_dim, guidance_scale,
                                        guidance_uncondp)
        else:
            self.time_proj_dim = text_encoded_dim
            self.emb_proj = (nn.Sequential(
                nn.ReLU(), nn.Linear(text_encoded_dim, latent_dim))
                if text_encoded_dim != latent_dim else None)
        self.time_embedding = TimestepEmbedding(self.time_proj_dim,
                                                latent_dim)
        self.query_pos = PositionEmbeddingLearned1D(latent_dim, pe_max_len)
        self.encoder = SkipTransformerEncoder(latent_dim, num_heads,
                                              num_layers, ff_size, activation,
                                              dropout=dropout)
        self._stacked: Optional[StackedSkipEncoder] = None
        self.register_load_state_dict_post_hook(
            lambda module, incompatible: module.restack())

    def restack(self):
        """Rebuild the kernel's stacked weights from the current params."""
        self._stacked = stack_skip_encoder(self.encoder, self.weight_dtype)

    def drop_stack(self):
        """Forget the stacked weights (the params changed in place); the
        next K1 call restacks."""
        self._stacked = None

    def stacked_encoder(self) -> StackedSkipEncoder:
        """K1's stacked weights: the cached stack of the parameters or,
        while a forward runs on their bf16 copies (a mixed-precision step's
        validation, ``train/steps.py:_segment``), a stack of those copies
        built for the call, matrices in bf16."""
        dtype = self.encoder.norm.weight.dtype
        if dtype != torch.float32:
            return stack_skip_encoder(self.encoder, dtype)
        if self._stacked is None:
            self.restack()
        return self._stacked

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .float() replace the params: restack after them
        out = super()._apply(fn, *args, **kwargs)
        if self._stacked is not None:
            self.restack()
        return out

    def forward(self, sample: torch.Tensor, timestep,
                encoder_hidden_states: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                training: bool = False,
                cond_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The module path (``denoiser.py:139-186``, trans_enc, latent
        mode): sample [B, latent_size, d]; timestep scalar or [B];
        encoder_hidden_states [B, S_text, text_dim], or [B] action ids ->
        [B, latent_size, d]. Dropout is on when a generator is given; with
        `training` an action's embedding is not CFG-masked, and its rows are
        zeroed where `cond_keep` [B] bool is False (EmbedAction's drop)."""
        emb = torch.cat([_time_token(self, timestep, sample),
                         cond_tokens(self, encoder_hidden_states, training,
                                     cond_keep)], dim=1)
        xseq = self.query_pos(torch.cat([sample, emb], dim=1))
        return self.encoder(xseq, generator=generator)[:, : sample.shape[1]]

    def fused_forward(self, sample: torch.Tensor, timestep,
                      encoder_hidden_states: torch.Tensor,
                      time_emb: Optional[torch.Tensor] = None,
                      cond_lat: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """The serving forward over K1 (no grad), same shapes; time_emb and
        cond_lat from ``ops.fused_denoiser.precompute_cond``."""
        return fused_denoiser_forward(self, sample, timestep,
                                      encoder_hidden_states, time_emb,
                                      cond_lat)


class RawMotionDenoiser(nn.Module):
    """The ``trans_dec`` denoiser in ``diffusion_only`` mode
    (``denoiser.py:94-197``, text branch): embedded raw motion frames
    [B, T, d] cross-attend the memory [time token; text tokens] through a
    plain post-norm decoder stack, whose attention is ``ops.attention.sdpa``
    (the K3 kernel on the card). The decoder takes no masks: padded frames
    are attended, as in the reference (``denoiser.py:150-151``); the output
    is zeroed outside the mask.

    Parameters carry the reference names: ``pose_embd``, ``pose_proj``,
    ``time_embedding.linear_1/2``, ``emb_proj.1``, ``query_pos.pe``,
    ``mem_pos.pe``, ``decoder.layers.N.*``, ``decoder.norm``."""

    def __init__(self, nfeats: int = 263, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, text_encoded_dim: int = 768,
                 pe_max_len: int = 500, activation: str = "gelu",
                 dropout: float = 0.0):
        super().__init__()
        d = latent_dim
        self.latent_dim = latent_dim
        self.text_encoded_dim = text_encoded_dim
        self.time_proj_dim = text_encoded_dim
        self.condition = "text"
        self.pose_embd = nn.Linear(nfeats, d)
        self.pose_proj = nn.Linear(d, nfeats)
        self.time_embedding = TimestepEmbedding(text_encoded_dim, d)
        self.emb_proj = (nn.Sequential(nn.ReLU(), nn.Linear(text_encoded_dim, d))
                         if text_encoded_dim != d else None)
        self.query_pos = PositionEmbeddingLearned1D(d, pe_max_len)
        self.mem_pos = PositionEmbeddingLearned1D(d, pe_max_len)
        self.decoder = TransformerDecoder(d, num_heads, num_layers, ff_size,
                                          activation, dropout=dropout)

    def forward(self, sample: torch.Tensor, timestep,
                encoder_hidden_states: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """sample [B, T, nfeats]; timestep scalar or [B];
        encoder_hidden_states [B, S_text, text_dim]; mask [B, T] bool or
        None -> [B, T, nfeats]. Dropout is on when a generator is given."""
        memory = self.mem_pos(torch.cat(
            [_time_token(self, timestep, sample),
             cond_tokens(self, encoder_hidden_states)], dim=1))
        tgt = self.query_pos(self.pose_embd(sample))
        out = self.pose_proj(self.decoder(tgt, memory, generator=generator))
        return out * mask[..., None] if mask is not None else out
