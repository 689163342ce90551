"""The denoiser (port of ``mld_tpu/models/denoiser.py``): one
``MldDenoiser`` with the JAX module's structure, conditioned on text
(``text``, ``text_uncond``: CLIP features or all 77 hidden states) or on an
action class (``EmbedAction``), in latent mode or on raw motion
(``diffusion_only``, the no-VAE presets), with the ``trans_enc`` arch (a
U-Net-skip encoder, or with ``skip_connect`` off a plain encoder with no
final norm) or ``trans_dec`` (a plain decoder stack with a final norm).
``RawMotionDenoiser`` is its ``diffusion_only`` case.

Token order is JAX's (``denoiser.py:139-197``), with emb = [time token;
condition tokens]:
  latent trans_enc   [sample; emb] -> the sample's rows
  raw trans_enc      [emb; pose_embd(x)] -> pose_proj of the frames' rows
  trans_dec          tgt = query_pos(sample or pose_embd(x)), memory =
                     mem_pos(emb) -> the tgt rows (raw: pose_proj)
and raw motion's output is zeroed outside the frame mask. The module holds
the parameters under the reference torch names (``time_embedding.linear_1``,
``emb_proj.1`` for text, ``emb_proj.action_embedding`` for an action,
``query_pos.pe`` / ``mem_pos.pe`` for a learned PE, ``pose_embd``,
``pose_proj``, ``encoder.*``, ``decoder.layers.N``, ``decoder.norm``). The
timestep sinusoid is ``text_encoded_dim`` wide for text and ``latent_dim``
wide for an action (``denoiser.py:101``, ``107``): ``time_proj_dim``.

It has two forwards, as the JAX package's denoiser has
(``mld_tpu/models/mld.py:372-396``): ``forward``, the module path (flax's
LayerNorm eps 1e-6, dropout, differentiable), which training always takes;
and ``fused_forward``, the serving forward over K1 (``ops.fused_denoiser``,
eps 1e-5, no grad), which exists only where ``fusable`` holds (latent mode,
the skip trans_enc, post-norm, learned PE, at most 8 tokens with the
`cond_tokens` condition tokens). ``MLD.denoise`` chooses between them.

The encoder's per-layer weights are stacked for the kernel whenever
parameters are loaded or moved (``restack``), never per call, and only for
a fusable denoiser. An optimizer step changes the parameters in place and
leaves the stack stale: the training step drops it (``drop_stack``) and the
next K1 call rebuilds it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mld_tpu_torch.ops.embeddings import (TimestepEmbedding,
                                          build_position_encoding)
from mld_tpu_torch.ops.fused_denoiser import (cond_tokens, fusable,
                                              fused_denoiser_forward,
                                              time_embedding)
from mld_tpu_torch.ops.fused_layer import StackedSkipEncoder, stack_skip_encoder
from mld_tpu_torch.ops.transformer import (Linear, SkipTransformerEncoder,
                                           TransformerDecoder,
                                           TransformerEncoder)
from mld_tpu_torch.utils import precision


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
                 guidance_uncondp: float = 0.1, *, nfeats: int = 263,
                 arch: str = "trans_enc", skip_connect: bool = True,
                 diffusion_only: bool = False,
                 position_embedding: str = "learned",
                 normalize_before: bool = False, cond_tokens: int = 1):
        super().__init__()
        if condition not in ("text", "text_uncond", "action"):
            raise ValueError(f"condition {condition} not supported")
        if arch not in ("trans_enc", "trans_dec"):
            raise ValueError(f"arch {arch} not supported")
        d = latent_dim
        self.latent_dim = latent_dim
        self.text_encoded_dim = text_encoded_dim
        self.condition = condition
        self.arch = arch
        self.diffusion_only = diffusion_only
        self.weight_dtype = weight_dtype
        # K1 serves [sample; time; condition tokens] in latent mode
        self.fusable = fusable(diffusion_only, arch, skip_connect,
                               normalize_before, position_embedding,
                               activation, latent_size + 1 + cond_tokens)
        text = condition != "action"
        self.time_proj_dim = text_encoded_dim if text else d
        # modules are made in the order the two earlier denoisers made them,
        # so that a seeded init draws the same weights for them
        if diffusion_only:
            self.pose_embd = Linear(nfeats, d)
            self.pose_proj = Linear(d, nfeats)
            self.time_embedding = TimestepEmbedding(self.time_proj_dim, d)
        if not text:
            self.emb_proj = EmbedAction(nclasses, d, guidance_scale,
                                        guidance_uncondp)
        else:
            # ReLU before the projection (denoiser.py:161-163)
            self.emb_proj = (nn.Sequential(nn.ReLU(),
                                           Linear(text_encoded_dim, d))
                             if text_encoded_dim != d else None)
        if not diffusion_only:
            self.time_embedding = TimestepEmbedding(self.time_proj_dim, d)
        self.query_pos = build_position_encoding(d, position_embedding,
                                                 pe_max_len)
        layer_kw = dict(ff_size=ff_size, activation=activation,
                        dropout=dropout, normalize_before=normalize_before)
        if arch == "trans_dec":
            self.mem_pos = build_position_encoding(d, position_embedding,
                                                   pe_max_len)
            self.decoder = TransformerDecoder(d, num_heads, num_layers,
                                              **layer_kw)
        elif skip_connect:
            self.encoder = SkipTransformerEncoder(d, num_heads, num_layers,
                                                  **layer_kw)
        else:
            self.encoder = TransformerEncoder(d, num_heads, num_layers,
                                              **layer_kw)
        # K1's stacks: in weight_dtype, and the bf16 arm the matmul
        # precision picks when weight_dtype is f32 (built at first use)
        self._stacked: Optional[StackedSkipEncoder] = None
        self._stacked_bf16: Optional[StackedSkipEncoder] = None
        self.register_load_state_dict_post_hook(
            lambda module, incompatible: module.restack())

    def restack(self):
        """Rebuild the kernel's stacked weights from the current params, the
        bf16 arm too once it was built (a denoiser K1 cannot serve has
        none)."""
        if self.fusable:
            self._stacked = stack_skip_encoder(self.encoder,
                                               self.weight_dtype)
            if self._stacked_bf16 is not None:
                self._stacked_bf16 = stack_skip_encoder(self.encoder,
                                                        torch.bfloat16)

    def drop_stack(self):
        """Forget the stacked weights (the params changed in place); the
        next K1 call restacks."""
        self._stacked = self._stacked_bf16 = None

    def stacked_encoder(self) -> StackedSkipEncoder:
        """K1's stacked weights: the cached stack of the parameters, in
        weight_dtype or, where that is f32, in the arm the matmul precision
        in force picks (bf16 under "default", ``mld.py:379-391``); or,
        while a forward runs on their bf16 copies (a mixed-precision step's
        validation, ``train/steps.py:_segment``), a stack of those copies
        built for the call, matrices in bf16."""
        self._check_fusable()
        dtype = self.encoder.norm.weight.dtype
        if dtype != torch.float32:
            return stack_skip_encoder(self.encoder, dtype)
        if self.weight_dtype == torch.float32 \
                and precision.weight_dtype() == torch.bfloat16:
            if self._stacked_bf16 is None:
                self._stacked_bf16 = stack_skip_encoder(self.encoder,
                                                        torch.bfloat16)
            return self._stacked_bf16
        if self._stacked is None:
            self.restack()
        return self._stacked

    def _check_fusable(self):
        if not self.fusable:
            raise ValueError("K1 cannot serve this denoiser (it needs latent "
                             "mode, the skip trans_enc, post-norm, learned "
                             "PE, gelu and at most 8 tokens)")

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() / .float() replace the params: restack after them
        out = super()._apply(fn, *args, **kwargs)
        if self._stacked is not None or self._stacked_bf16 is not None:
            self.restack()
        return out

    def forward(self, sample: torch.Tensor, timestep,
                encoder_hidden_states: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                training: bool = False,
                cond_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The module path (``denoiser.py:139-197``): sample [B,
        latent_size, d] or, on raw motion, [B, T, nfeats]; timestep scalar
        or [B]; encoder_hidden_states [B, S_text, text_dim], or [B] action
        ids; mask [B, T] bool zeroes raw motion's output outside the frames
        (the layers attend to every frame, as the reference's) -> the
        sample's shape. Dropout is on when a generator is given; with
        `training` an action's embedding is not CFG-masked, and its rows
        are zeroed where `cond_keep` [B] bool is False (EmbedAction's
        drop)."""
        emb = torch.cat([_time_token(self, timestep, sample),
                         cond_tokens(self, encoder_hidden_states, training,
                                     cond_keep)], dim=1)
        if self.arch == "trans_enc":
            if self.diffusion_only:
                xseq = torch.cat([emb, self.pose_embd(sample)], dim=1)
            else:
                xseq = torch.cat([sample, emb], dim=1)
            tokens = self.encoder(self.query_pos(xseq), generator=generator)
            if not self.diffusion_only:
                return tokens[:, : sample.shape[1]]
            out = self.pose_proj(tokens[:, emb.shape[1]:])
        else:
            tgt = self.query_pos(self.pose_embd(sample) if self.diffusion_only
                                 else sample)
            out = self.decoder(tgt, self.mem_pos(emb), generator=generator)
            if not self.diffusion_only:
                return out
            out = self.pose_proj(out)
        return out * mask[..., None] if mask is not None else out

    def fused_forward(self, sample: torch.Tensor, timestep,
                      encoder_hidden_states: torch.Tensor,
                      time_emb: Optional[torch.Tensor] = None,
                      cond_lat: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """The serving forward over K1 (no grad), same shapes; time_emb and
        cond_lat from ``ops.fused_denoiser.precompute_cond``."""
        self._check_fusable()
        return fused_denoiser_forward(self, sample, timestep,
                                      encoder_hidden_states, time_emb,
                                      cond_lat)


class RawMotionDenoiser(MldDenoiser):
    """The denoiser of raw motion (``diffusion_only``, the no-VAE presets):
    `arch` trans_dec by default (the presets': embedded frames [B, T, d]
    cross-attend the memory [time token; text tokens] through a plain
    decoder stack) or trans_enc (``[t; cond; pose_embd(x)]`` through the
    encoder). Every attention is ``ops.attention.sdpa`` (K3 on the card)."""

    def __init__(self, nfeats: int = 263, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 9,
                 num_heads: int = 4, text_encoded_dim: int = 768,
                 pe_max_len: int = 500, activation: str = "gelu",
                 dropout: float = 0.0, **kw):
        kw.setdefault("arch", "trans_dec")
        super().__init__(1, latent_dim, ff_size, num_layers, num_heads,
                         text_encoded_dim, pe_max_len, activation,
                         dropout=dropout, nfeats=nfeats, diffusion_only=True,
                         **kw)
