"""MLD motion generation (port of ``mld_tpu/models/mld.py``), in three
families, as the presets configure them:

  latent (mld_humanml3d): texts -> tokens (host, EOT buckets) -> CLIP -> 50
      DDIM steps of the trans_enc denoiser with classifier-free guidance over
      a doubled batch (uncond half first) -> VAE decode -> de-norm ->
      recover_from_ric -> joints
  raw motion (novae_humanml3d, novae_stress_s512): the same text path -> 1000
      ancestral DDPM steps of the trans_dec denoiser over [B, T, nfeats]
      frames under CFG -> zero outside the mask -> de-norm -> joints
  action (mld_humanact12, mld_uestc): class ids, with zero ids as the uncond
      half of the CFG batch (no text tower, no tokenizer) -> 50 DDIM steps
      of the trans_enc denoiser over [z; t; action] -> ACTOR VAE decode ->
      SMPL-topology joints of the rot6d features (no de-normalisation)

The model is built from the config as the JAX package builds it, with
every option ``mld_tpu.models.mld.MLD`` takes: ``condition`` text,
text_uncond (under CFG both halves are the empty prompt's row, and the
prompt is not encoded) or action; ``clip_last_hidden`` (the denoiser
conditions on all 77 CLIP hidden states: full-context ids, a full-context
uncond row, no EOT buckets); ``vae_type`` mld (``vae_arch``, ``mlp_dist``),
actor, vposert or no; the denoiser's ``denoiser_arch`` trans_enc or
trans_dec, ``skip_connect``, ``normalize_before``, ``position_embedding``
and ``latent_size``; and the sampler ``scheduler.kind`` (DDIM, or ancestral
DDPM, whose step noise is drawn, or replayed through ``step_noise``) with
or without a VAE. ``_check_supported`` rejects what the JAX package cannot
build either: an action without a VAE, and a ``dtype`` other than float32
and bfloat16.

The latent denoiser's encoder stack runs as one CUDA kernel per step on the
card (ops/fused_layer.py) when ``fused_denoiser`` is on and K1 can serve it
(``ops.fused_denoiser.can_fuse``), the text tower's
causal attention as another (ops/attention.py:sdpa_flash_causal), and every
bidirectional attention (every module-path denoiser's, the plain VAE's, the
ACTOR VAE's) as a third (ops/attention.py:sdpa). ``fused_decode``, the JAX
package's switch of the same name, runs the VAE decoder stack through
ops/fused_seq_decoder.py; it changes the result (LayerNorm eps 1e-5 against
the plain modules' 1e-6), as ``fused_denoiser`` does. Everything else is
plain PyTorch on the same device.

The training pieces (``noise_scheduler``, ``encode_motion``, ``denoise``
with ``training=``, ``decode_latent`` with ``training=``) are differentiable
and never take K1 or K5, as in the JAX package (``mld.py:284-319``,
``372-396``); the steps that use them are ``train/steps.py``, which read
``dtype``, the training steps' compute dtype (``model.dtype``: f32, or bf16
mixed precision). Serving ignores it, as the JAX package's does. The evaluation
protocol (``eval/pipeline.py``) reads ``renorm4t2m`` (the evaluators'
normalisation, ``mean_eval`` / ``std_eval``), ``generate_feats`` and, for the
VAE stage, ``reconstruct``. Conventions:
batch-first; latents [B, latent_size, latent_dim] or [B, T, nfeats]; masks
[B, T] bool, True = valid.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mld_tpu_torch.config import Config
from mld_tpu_torch.data.humanml.motion_process import recover_from_ric
from mld_tpu_torch.diffusion.schedulers import (DDIMScheduler, DDPMScheduler,
                                                DiffusionSchedule)
from mld_tpu_torch.models.actor_vae import ActorVae
from mld_tpu_torch.models import denoise_graph
from mld_tpu_torch.models.clip_text import (CLIP_CONTEXT, ClipTextModel,
                                            ClipTokenizer)
from mld_tpu_torch.models.denoiser import MldDenoiser, RawMotionDenoiser
from mld_tpu_torch.models.smpl import Rotation2Joints
from mld_tpu_torch.models.vae import MldVae
from mld_tpu_torch.models.vposert_vae import VPosert
from mld_tpu_torch.ops.fused_denoiser import can_fuse, precompute_cond
from mld_tpu_torch.ops.fused_layer import MAX_S
from mld_tpu_torch.ops.fused_seq_decoder import (can_fuse_decode,
                                                 fused_vae_decode)
from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.convert import (flax_clip_to_state_dict,
                                         flax_to_state_dict,
                                         state_dict_to_flax)
from mld_tpu_torch.utils.precision import stage_precision

TEXT_BUCKETS = (16, 24, 32, 48, 64)


def _fused_denoiser_from_env(device: torch.device) -> bool:
    """MLD_TPU_FUSED_DENOISER as the JAX package reads it (mld.py:398-429),
    for a denoiser K1 can serve: "0" off, "1" on, anything else ("auto") on
    where the JAX package has its single TPU, which for the port is a CUDA
    device, and off elsewhere (the JAX package's default off a TPU)."""
    flag = os.environ.get("MLD_TPU_FUSED_DENOISER", "auto")
    if flag in ("0", "1"):
        return flag == "1"
    return device.type == "cuda"


def _text_buckets():
    """MLD_TPU_TEXT_BUCKETS as the JAX package reads it (mld.py:272-278):
    "auto" the default ladder, "0" or "off" none (full context), else a
    comma list of lengths."""
    flag = os.environ.get("MLD_TPU_TEXT_BUCKETS", "auto")
    if flag in ("0", "off"):
        return None
    if flag == "auto":
        return TEXT_BUCKETS
    return tuple(int(b) for b in flag.split(",") if int(b) > 0)


def _fused_decode_from_env(model_cfg) -> bool:
    """MLD_TPU_FUSED_DECODE as the JAX package reads it (mld.py:367-370):
    only "1" turns it on, and only where can_fuse_decode holds."""
    return (os.environ.get("MLD_TPU_FUSED_DECODE", "auto") == "1"
            and can_fuse_decode(model_cfg))


def _scope(stage: str, serving: bool):
    """A serving stage's matmul-precision scope; none for a training call
    site, where MLD_TPU_STAGE_PRECISION must not reach (``mld.py:220-224``,
    ``296-298``)."""
    return stage_precision(stage) if serving else contextlib.nullcontext()


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the card unless the caller asks
    for another. Raises when the card is asked for and none is visible,
    rather than build on the CPU behind the caller's back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port runs on the card by default and no CUDA "
                           "device is visible; pass device=\"cpu\" to run on "
                           "the CPU")
    return device


def crop_to_bucket(token_ids: torch.Tensor) -> torch.Tensor:
    """Full-context ids [B, 77] (the collator's) cropped to the smallest
    MLD_TPU_TEXT_BUCKETS bucket that holds every row's EOT, the rule of
    ``ClipTokenizer(buckets=)``: exact under causal attention and EOT
    pooling."""
    buckets = _text_buckets()
    if not buckets:
        return token_ids
    # EOS is the largest vocab id and pad == EOS: argmax finds the EOT
    eot_max = int(token_ids.argmax(dim=-1).max())
    n = next((b for b in sorted(buckets) if b > eot_max), token_ids.shape[1])
    return token_ids[:, :n]


def lengths_to_mask(lengths, max_len: int, device=None) -> torch.Tensor:
    """[B] -> [B, max_len] bool, on `device`; None means the lengths' device
    when they are a tensor, else the card."""
    if device is None and not torch.is_tensor(lengths):
        device = "cuda"
    if device is not None:
        device = resolve_device(device)
    lengths = torch.as_tensor(lengths, device=device)
    return torch.arange(max_len, device=lengths.device)[None] < lengths[:, None]


def is_raw_motion(model_cfg) -> bool:
    """No VAE: the denoiser works on the motion features themselves (the JAX
    package's ``not is_vae``, ``mld.py:63``)."""
    return not model_cfg.vae or model_cfg.vae_type == "no"


def _check_supported(cfg: Config):
    """Reject what the JAX package cannot build or run either: an action
    without a VAE (its raw-motion features have no joints transform, and
    ``init_params`` conditions the raw denoiser on text), and a compute
    dtype other than f32 and bf16. Every other option the JAX MLD takes is
    built as it builds it; an unknown option value raises where the module
    reads it, as in JAX."""
    m = cfg.model
    unsupported = [
        (m.condition == "action" and is_raw_motion(m),
         "condition=action without a VAE"),
        (m.dtype not in ("float32", "bfloat16"), f"dtype={m.dtype}"),
    ]
    bad = [msg for cond, msg in unsupported if cond]
    if bad:
        raise NotImplementedError(
            f"the PyTorch port builds what the JAX package builds; "
            f"unsupported: {', '.join(bad)}")


def cond_token_count(model_cfg) -> int:
    """Condition tokens of the denoiser's sequence: the 77 CLIP hidden states
    in hidden mode (``clip_last_hidden``), else one (the pooled features or
    the action's embedding)."""
    return CLIP_CONTEXT if model_cfg.clip_last_hidden else 1


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator):
    """Random weights with the JAX package's initialiser families:
    lecun-normal Linear weights, xavier-uniform packed QKV, motion tokens and
    action table, zero biases, unit LayerNorm scales, uniform [0, 1) learned
    PE, normal(0.02 / 0.01) CLIP embeddings and projection, normal(1) ACTOR
    mu / logvar tokens. CPU parameters."""
    g = generator
    for name, b in module.named_buffers():
        if name.endswith("running_mean"):     # VPosert's BatchNorm
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pe":
            p.uniform_(0.0, 1.0, generator=g)
        elif "token_embedding" in name or "text_projection" in name:
            p.normal_(0.0, 0.02, generator=g)
        elif "position_embedding" in name:
            p.normal_(0.0, 0.01, generator=g)
        elif leaf in ("mu_token", "logvar_token"):
            p.normal_(0.0, 1.0, generator=g)
        elif leaf in ("in_proj_weight", "global_motion_token",
                      "action_embedding"):
            bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
            p.uniform_(-bound, bound, generator=g)
        elif leaf == "weight" and p.dim() == 2:
            p.normal_(0.0, p.shape[1] ** -0.5, generator=g)
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()


class MLD(nn.Module):
    """Module set built from a Config, on the card unless `device` names
    another (device="cpu" for the CPU); without a visible CUDA device the
    default raises.

    Parameters are initialised from `generator` (a CPU torch.Generator;
    default: seeded with cfg.seed) and can be replaced with
    `load_flax_params` or `load_state_dict` (reference torch names).

    `fused_decode` chooses the serving decode path; None reads the JAX
    package's switch MLD_TPU_FUSED_DECODE, whose default is off.

    `fused_denoiser` chooses the serving denoiser where K1 can serve it
    (``can_fuse``: latent mode, the skip trans_enc, post-norm, learned PE,
    at most 8 tokens): True is K1's forward (``MldDenoiser.fused_forward``,
    LayerNorm eps 1e-5), and raises for a denoiser K1 cannot serve; False
    the module path (eps 1e-6). None reads the JAX package's switch
    MLD_TPU_FUSED_DENOISER when a call is made, as JAX reads it when it
    traces: "1" K1, "0" the module path, and "auto" (the default) K1 on a
    CUDA device, where the JAX package has its single TPU, and the module
    path on the CPU, JAX's default off a TPU; for a denoiser K1 cannot
    serve, every value takes the module path, as in JAX. Training and any
    dropout always take the module path (``mld.py:375-376``).

    `weight_dtype` bf16 forces K1's and K5's bf16-weight stacks; with its
    default, f32, the matmul precision of the serving stage picks them
    (bf16 under "default"). Serving runs each stage (text tower, sampling
    loop, decode) in its MLD_TPU_STAGE_PRECISION setting, else the
    session's MLD_TPU_MATMUL_PRECISION (``utils/precision.py``).

    Serving replays the raw-motion denoiser's guided call as one CUDA
    graph a step (``models/denoise_graph.py``: the same kernels and
    numbers, the host freed of its ~430 launches), on the card and only
    while no trace span or profiler watches; otherwise every step is
    eager.

    Neither switch is a fallback: with it on, the kernel launches on the
    card or the call raises. The raw-motion family has no VAE (``vae`` is
    None) and its denoiser works on the frames, so neither switch applies
    to it. The action family has no text tower (``clip`` and ``tokenizer``
    are None); K1 serves its denoiser as the text family's."""

    def __init__(self, cfg: Config, mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None,
                 mean_eval: Optional[np.ndarray] = None,
                 std_eval: Optional[np.ndarray] = None, *, device="cuda",
                 weight_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 fused_decode: Optional[bool] = None,
                 fused_denoiser: Optional[bool] = None):
        super().__init__()
        device = resolve_device(device)
        _check_supported(cfg)
        self.cfg = cfg
        m = cfg.model
        self.nfeats = cfg.dataset.nfeats
        self.njoints = cfg.dataset.njoints
        self.max_frames = cfg.dataset.max_motion_len
        self.latent_size = m.latent_size
        self.latent_dim = m.latent_dim
        self.guidance_scale = m.guidance_scale
        self.do_cfg = m.guidance_scale > 1.0
        self.clip_mode = "hidden" if m.clip_last_hidden else "features"
        self.raw_motion = is_raw_motion(m)
        self.condition = m.condition
        # the training forwards' compute dtype (mld.py:65)
        self.dtype = torch.bfloat16 if m.dtype == "bfloat16" else torch.float32
        if fused_decode is None:
            fused_decode = _fused_decode_from_env(m)
        elif fused_decode and not can_fuse_decode(m):
            raise ValueError("fused_decode needs the MLD VAE's "
                             "encoder_decoder arch, post-norm, learned PE "
                             "and latent_size <= 8")
        self.fused_decode = bool(fused_decode)
        n_tokens = m.latent_size + 1 + cond_token_count(m)
        if fused_denoiser and not can_fuse(m, cond_token_count(m)):
            raise ValueError(
                "fused_denoiser needs latent mode, the trans_enc denoiser "
                "with skip connections, post-norm, learned PE, gelu and at "
                f"most {MAX_S} tokens"
                + (f" ({n_tokens} tokens exceeds the fused stack's {MAX_S})"
                   if n_tokens > MAX_S else ""))
        self.fused_denoiser = fused_denoiser
        self._graph = None

        pe_max_len = max(500, self.max_frames + 8)
        den_kw = dict(
            pe_max_len=pe_max_len, activation=m.activation, dropout=m.dropout,
            condition=m.condition, arch=m.denoiser_arch,
            skip_connect=m.skip_connect,
            position_embedding=m.position_embedding,
            normalize_before=m.normalize_before)
        with torch.device("meta"):
            if self.raw_motion:
                self.vae = None
                self.denoiser = RawMotionDenoiser(
                    self.nfeats, m.latent_dim, m.ff_size,
                    m.denoiser_num_layers, m.num_heads, m.text_encoded_dim,
                    **den_kw)
            else:
                if m.vae_type == "actor":
                    self.vae = ActorVae(self.nfeats, m.latent_size,
                                        m.latent_dim, m.ff_size, m.num_layers,
                                        m.num_heads, m.activation,
                                        dropout=m.dropout)
                elif m.vae_type == "vposert":
                    self.vae = VPosert(self.nfeats, self.max_frames,
                                       m.latent_size, m.latent_dim)
                else:
                    self.vae = MldVae(self.nfeats, m.latent_size,
                                      m.latent_dim, m.ff_size, m.num_layers,
                                      m.num_heads, m.activation,
                                      weight_dtype=weight_dtype,
                                      dropout=m.dropout, arch=m.vae_arch,
                                      normalize_before=m.normalize_before,
                                      position_embedding=m.position_embedding,
                                      mlp_dist=m.mlp_dist)
                self.denoiser = MldDenoiser(
                    m.latent_size, m.latent_dim, m.ff_size,
                    m.denoiser_num_layers, m.num_heads, m.text_encoded_dim,
                    weight_dtype=weight_dtype, nclasses=m.nclasses,
                    guidance_scale=m.guidance_scale,
                    guidance_uncondp=m.guidance_uncondp,
                    cond_tokens=cond_token_count(m), **den_kw)
            # the text tower serves the text conditions only (mld.py:134)
            self.clip = (ClipTextModel(width=m.text_encoded_dim,
                                       layers=m.clip_layers,
                                       heads=m.clip_heads,
                                       projection_dim=m.text_encoded_dim,
                                       compute_dtype=m.clip_compute_dtype)
                         if self.condition != "action" else None)
        self.to_empty(device="cpu")
        init_params(self, generator if generator is not None
                    else torch.Generator().manual_seed(cfg.seed))
        # normalisation stats: constants of the run, not checkpoint params
        # (and the t2m evaluators' twin, mld.py:66-75)
        for name, val, default in (("mean", mean, 0.0), ("std", std, 1.0),
                                   ("mean_eval", mean_eval, 0.0),
                                   ("std_eval", std_eval, 1.0)):
            arr = np.full(self.nfeats, default) if val is None else val
            self.register_buffer(name, torch.as_tensor(arr, dtype=torch.float32),
                                 persistent=False)
        self.to(device)
        self.device = device

        sc = m.scheduler
        schedule = DiffusionSchedule.create(
            sc.num_train_timesteps, sc.beta_start, sc.beta_end,
            sc.beta_schedule,
            "epsilon" if cfg.train.predict_epsilon else "sample",
            sc.clip_sample)
        # the sampler scheduler.kind names, with or without a VAE
        # (mld.py:124-131)
        self.scheduler = (
            DDIMScheduler(schedule, sc.num_inference_timesteps, sc.eta,
                          sc.steps_offset, sc.set_alpha_to_one)
            if sc.kind == "ddim" else DDPMScheduler(schedule,
                                                    sc.variance_type))
        # the forward process of the training steps (mld.py:132-133)
        self.noise_scheduler = DDPMScheduler(schedule, sc.variance_type)

        if self.condition == "action":
            # rot6d features -> SMPL-topology joints (mld.py:77-84)
            self.tokenizer = self.uncond_ids = None
            self.rot2joints = Rotation2Joints(cfg.dataset.smpl_path, device)
        else:
            self.tokenizer = ClipTokenizer(m.clip_path)
            # features mode: the empty prompt is [BOS, EOS, pad...]; under
            # causal attention + EOT pooling only the first 2 positions
            # matter, so the uncond row is encoded at context 8 (exact);
            # hidden mode conditions on every position: full context
            # (mld.py:142-150)
            full = self.tokenizer([""])
            self.uncond_ids = (full[:, :8] if self.clip_mode == "features"
                               else full)
        self.denoiser.restack()
        if self.fused_decode:
            self.vae.restack()

    def use_fused_denoiser(self) -> bool:
        """Whether serving denoises through K1 (see the class docstring)."""
        if not self.denoiser.fusable:
            return False
        if self.fused_denoiser is not None:
            return bool(self.fused_denoiser)
        return _fused_denoiser_from_env(self.device)

    def drop_stacks(self):
        """After the parameters changed in place (an optimizer step): drop
        the kernels' stacked copies so that K1 and K5 restack at their next
        use instead of running the old weights (modules with no stack have
        nothing to drop)."""
        self.denoiser.drop_stack()
        if isinstance(self.vae, MldVae):
            self.vae.drop_stack()

    def load_flax_params(self, tree: Mapping):
        """Load a JAX-package param tree {vae, denoiser, clip} of numpy (or
        jax) arrays; the raw-motion family's tree has no vae, the action
        family's no clip. A VPosert's running statistics are flax's initial
        ones, mean 0 and var 1: JAX's ``init_params`` keeps no batch_stats
        (``mld.py:162``). The kernels' stacked weights are rebuilt on
        load."""
        sd = {}
        for top in ("vae", "denoiser"):
            if top in tree:
                sd.update({f"{top}.{k}": v for k, v in
                           flax_to_state_dict(tree[top]).items()})
        for name, b in self.named_buffers():
            if name.endswith(("running_mean", "running_var")) \
                    and name not in sd:
                sd[name] = (torch.zeros_like(b) if name.endswith("mean")
                            else torch.ones_like(b))
        if self.clip is not None:
            sd.update({f"clip.{k}": v for k, v in
                       flax_clip_to_state_dict(tree["clip"]).items()})
        self.load_state_dict(sd, strict=True)

    def params_tree(self) -> Dict:
        """The model's JAX-package param tree {vae, denoiser, clip} (the
        modules it has) as numpy arrays, as ``MLD.init_params`` lays it out
        (``utils/convert.py:state_dict_to_flax``): the inverse of
        ``load_flax_params``. Running statistics are left out, as JAX's
        tree holds none."""
        return state_dict_to_flax(self.state_dict())

    # --------------------------------------------------------------- text
    def tokenize(self, texts: Sequence[str]) -> torch.Tensor:
        """Serving-path ids [B, L] on the device. In features mode cropped
        to the smallest EOT bucket (exact under causal attention + EOT
        pooling; the buckets follow MLD_TPU_TEXT_BUCKETS, as the JAX
        package's do); in hidden mode full context, L = 77, since the
        denoiser conditions on every position (``mld.py:272-274``)."""
        buckets = _text_buckets() if self.clip_mode == "features" else None
        ids = self.tokenizer(list(texts), buckets=buckets)
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    @torch.no_grad()
    def encode_text_tokens(self, token_ids: torch.Tensor,
                           serving: bool = True) -> torch.Tensor:
        """[B, L] ids -> the denoiser's text condition (f32): [B, 1,
        text_dim] CLIP features, or in hidden mode the [B, L, text_dim]
        hidden states after the final LayerNorm. Serving runs in the clip
        stage's matmul precision; training call sites (`serving=False`)
        keep the precision in force (``mld.py:220-224``)."""
        with _scope("clip", serving):
            out = self.clip(token_ids.to(self.device, torch.long),
                            mode=self.clip_mode)
        return out[:, None, :] if self.clip_mode == "features" else out

    # ----------------------------------------------------------- sampling
    @torch.no_grad()
    def diffusion_reverse(self, cond_emb: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          init_latents: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None,
                          step_noise=None) -> torch.Tensor:
        """cond_emb [2B, S, D] under CFG (uncond half first) else [B, S, D]
        -> latents [B, latent_size, latent_dim], or for raw motion [B, T,
        nfeats] with T from `mask` [B, T] (required there; the denoiser
        gets the doubled mask under CFG, ``mld.py:455-457``).

        `init_latents` replaces the drawn initial noise (already scaled by
        init_noise_sigma). Ancestral DDPM draws one noise tensor a step, of
        the latents' shape, from `generator`; `step_noise` replaces those
        draws (step_noise[i] is step i's). DDIM draws none. The loop
        and its hoisted preamble run in the scan stage's matmul precision
        (``mld.py:490-500``)."""
        with stage_precision("scan"), trace.span("loop"):
            return self._diffusion_reverse(cond_emb, generator, init_latents,
                                           mask, step_noise)

    def _diffusion_reverse(self, cond_emb, generator, init_latents, mask,
                           step_noise):
        B = cond_emb.shape[0] // 2 if self.do_cfg else cond_emb.shape[0]
        dev = generator.device if generator is not None else self.device
        mask2 = None
        if self.raw_motion:
            if mask is None:
                raise ValueError("raw-motion sampling needs the frame mask")
            mask = mask.to(self.device)
            mask2 = torch.cat([mask, mask]) if self.do_cfg else mask
            shape = (B, mask.shape[1], self.nfeats)
        else:
            shape = (B, self.latent_size, self.latent_dim)
        if init_latents is None:
            init_latents = (torch.randn(shape, generator=generator, device=dev)
                            * self.scheduler.init_noise_sigma)
        latents = init_latents.to(self.device, torch.float32)
        timesteps = self.scheduler.timesteps()
        ancestral = isinstance(self.scheduler, DDPMScheduler)
        fused = self.use_fused_denoiser()
        graph = None
        if self.raw_motion and denoise_graph.allowed(self.device):
            graph = self._denoiser_graph(shape, cond_emb, mask2)
        if fused:
            # K1's step-invariant preamble hoisted out of the loop: the
            # time-embedding table and the projected condition tokens
            with trace.span("loop.preamble"):
                time_tab, cond_lat = precompute_cond(
                    self.denoiser,
                    torch.as_tensor(timesteps, device=self.device), cond_emb)
        for i, t in enumerate(timesteps):
            with trace.span("loop.step"):
                model_in = (torch.cat([latents, latents]) if self.do_cfg
                            else latents)
                with trace.span("loop.denoise"):
                    if fused:
                        out = self.denoiser.fused_forward(
                            model_in, int(t), cond_emb, time_emb=time_tab[i],
                            cond_lat=cond_lat)
                    elif graph is not None:
                        out = graph(model_in, t)
                    else:
                        out = self.denoiser(model_in, int(t), cond_emb, mask2)
                if self.do_cfg:
                    with trace.span("loop.cfg"):
                        out_uncond, out_text = out.chunk(2)
                        out = out_uncond + self.guidance_scale * (
                            out_text - out_uncond)
                with trace.span("loop.scheduler"):
                    noise = None
                    if ancestral:
                        with trace.span("loop.noise"):
                            noise = self._step_noise(latents.shape, generator,
                                                     dev, step_noise, i)
                    latents = self.scheduler.step(out, int(t), latents, noise)
        return latents

    def _denoiser_graph(self, shape, cond_emb, mask2):
        """The graph of the guided module-path denoiser call at this
        call's shapes, precision and parameters (captured again when one
        of them changed), holding the call's condition and mask."""
        sample = torch.empty((cond_emb.shape[0],) + tuple(shape[1:]),
                             device=self.device)
        k = denoise_graph.key(self.denoiser, sample, cond_emb, mask2)
        if self._graph is None or self._graph.key != k:
            self._graph = None
            self._graph = denoise_graph.DenoiserGraph(self.denoiser, k,
                                                      sample, cond_emb, mask2)
        return self._graph.condition(cond_emb, mask2)

    def _step_noise(self, shape, generator, dev, step_noise, i):
        """Step i's ancestral noise on the model's device: drawn from
        `generator` on `dev` (its bytes counted under ``noise.bytes``), or
        step_noise[i]."""
        if step_noise is not None:
            noise = torch.as_tensor(step_noise[i])
        else:
            noise = torch.randn(shape, generator=generator, device=dev)
            trace.COUNTS["noise.bytes"] += noise.numel() * noise.element_size()
        return noise.to(self.device, torch.float32)

    # ----------------------------------------------------------- training
    def encode_motion(self, feats: torch.Tensor, mask: torch.Tensor, *,
                      eps: Optional[torch.Tensor] = None,
                      dropout_generator: Optional[torch.Generator] = None):
        """VAE encode -> (z, (mu, logvar)) (``mld.py:284-292``), with the
        gradient: z = mu + eps * std, or mu without eps; dropout on with
        dropout_generator."""
        return self.vae.encode(feats, mask, eps=eps,
                               dropout_generator=dropout_generator)

    def denoise(self, sample: torch.Tensor, t, cond_emb: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                training: bool = False,
                dropout_generator: Optional[torch.Generator] = None,
                cond_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One denoiser call (``mld.py:372-396``): K1 when serving with the
        fused denoiser on, else the module path, which training and any
        dropout always take. A mixed-precision step's validation calls K1
        on its bf16 copies of the parameters, as JAX's fused path reads
        the cast params (``ops.fused_denoiser.fused_denoiser_forward``).
        `mask` [B, T] zeroes the raw-motion output outside the frames; in
        training `cond_keep` [B] bool is EmbedAction's drop of an action's
        rows (``denoiser.py:57-60``)."""
        if (not training and dropout_generator is None
                and self.use_fused_denoiser()):
            with torch.no_grad():
                return self.denoiser.fused_forward(sample, t, cond_emb)
        # training: an action's CFG zeroing is off (EmbedAction)
        return self.denoiser(sample, t, cond_emb, mask,
                             generator=dropout_generator, training=training,
                             cond_keep=cond_keep)

    def decode_latent(self, z: torch.Tensor, mask: torch.Tensor, *,
                      training: bool = False,
                      dropout_generator: Optional[torch.Generator] = None,
                      serving: bool = True) -> torch.Tensor:
        """z [B, latent_size, latent_dim], mask [B, T] -> feats [B, T,
        nfeats].

        Serving (the default) runs without grad: the fused decoder stack
        (LayerNorm eps 1e-5, as JAX's fused path) or the plain modules (eps
        1e-6, as JAX's XLA path). With training or a dropout generator it is
        the plain modules with the gradient, never fused, as the JAX package
        fuses only without a dropout rng (``mld.py:303-319``). A
        mixed-precision step's validation fuses on its bf16 copies of the
        parameters (``ops.fused_seq_decoder.fused_vae_decode``). It runs
        in the decode stage's matmul precision, which also picks K5's
        weight arm; training call sites (`serving=False`) keep the
        precision in force (``mld.py:294-312``)."""
        with trace.span("decode"), _scope("decode", serving):
            if training or dropout_generator is not None:
                return self.vae.decode(z, mask, dropout_generator)
            with torch.no_grad():
                if self.fused_decode:
                    return fused_vae_decode(self.vae, z, mask)
                return self.vae.decode(z, mask)

    def feats2joints(self, feats: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """text: de-normalise + RIC decode (HumanML3D.py:41-45); action: the
        rot6d features to SMPL-topology joints with the root translation,
        zero outside `mask` when given, and no de-normalisation
        (``mld.py:557-564``)."""
        if self.condition == "action":
            return self.rot2joints(feats, mask)
        return recover_from_ric(feats * self.std + self.mean, self.njoints)

    def masked_joints(self, feats: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
        """feats2joints, zero outside the mask. (An action's padded frames
        hold zero rot6d, whose Gram-Schmidt joints are NaN: the JAX package
        multiplies them by the mask and keeps the NaN; the port zeroes
        them.)"""
        with trace.span("joints"):
            return self.feats2joints(feats).masked_fill(
                ~mask[..., None, None], 0.0)

    def renorm4t2m(self, feats: torch.Tensor) -> torch.Tensor:
        """model-normalised features -> the t2m evaluators' normalisation
        (HumanML3D.py:54-62)."""
        return (feats * self.std + self.mean - self.mean_eval) / self.std_eval

    @torch.no_grad()
    def gen_from_latent(self, z: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
        """latent [B, latent_size, latent_dim] -> joints, zero outside the
        mask (``mld.py:571-575``)."""
        mask = mask.to(self.device)
        return self.masked_joints(self.decode_latent(z, mask), mask)

    @torch.no_grad()
    def reconstruct(self, feats_ref: torch.Tensor, mask: torch.Tensor, *,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """motion features -> VAE encode (z = mu + eps * std, eps given or
        drawn from `generator`; mu without either) -> serving decode."""
        mask = mask.to(self.device)
        z, _ = self.vae.encode(feats_ref.to(self.device), mask, generator,
                               eps=eps)
        return self.decode_latent(z, mask)

    @torch.no_grad()
    def recon_from_motion(self, feats_ref: torch.Tensor, mask: torch.Tensor,
                          *, eps: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
        """motion -> encode -> decode -> (joints, joints of the input), each
        zero outside the mask (``mld.py:577-585``)."""
        mask = mask.to(self.device)
        feats_ref = feats_ref.to(self.device)
        feats = self.reconstruct(feats_ref, mask, eps=eps,
                                 generator=generator)
        return (self.masked_joints(feats, mask),
                self.masked_joints(feats_ref, mask))

    def encode_uncond(self, serving: bool = True) -> torch.Tensor:
        """The empty prompt's embedding, one row: [1, 1, text_dim], or in
        hidden mode [1, 77, text_dim]."""
        ids = torch.as_tensor(self.uncond_ids, device=self.device)
        if serving:
            # the serving call stays encode_text_tokens(ids), the call a
            # caller's wrapper of it sees
            return self.encode_text_tokens(ids)
        return self.encode_text_tokens(ids, serving=False)

    def condition_embedding(self, cond: torch.Tensor) -> torch.Tensor:
        """The denoiser's condition over the CFG batch (uncond half first):
        text ids [B, L] -> the text tower's condition, the uncond row
        encoded once and broadcast; under ``text_uncond`` both halves are
        that row and the prompts are not encoded (without CFG they are);
        action ids [B] -> [zeros; ids], the ids themselves, which the
        denoiser embeds (``mld.py:511-535``)."""
        with trace.span("condition"):
            if self.condition == "action":
                actions = torch.as_tensor(cond).to(self.device,
                                                   torch.long).reshape(-1)
                return (torch.cat([torch.zeros_like(actions), actions])
                        if self.do_cfg else actions)
            if not self.do_cfg:
                with trace.span("condition.tower"):
                    return self.encode_text_tokens(cond)
            with trace.span("condition.uncond"):
                uncond = self.encode_uncond()
            uncond = uncond.expand(cond.shape[0], *uncond.shape[1:])
            if self.condition == "text_uncond":
                return torch.cat([uncond, uncond])
            with trace.span("condition.tower"):
                cond_half = self.encode_text_tokens(cond)
            return torch.cat([uncond, cond_half])

    @torch.no_grad()
    def generate_feats(self, cond: torch.Tensor, mask: torch.Tensor, *,
                       generator: Optional[torch.Generator] = None,
                       init_latents: Optional[torch.Tensor] = None,
                       step_noise=None) -> torch.Tensor:
        """prompt ids [B, L] (or action ids [B]) + mask [B, T] -> normalised
        features [B, T, nfeats], zero outside the mask
        (``mld.py:511-542``). `init_latents` and `step_noise` as in
        diffusion_reverse."""
        mask = mask.to(self.device)
        cond_emb = self.condition_embedding(cond)
        z = self.diffusion_reverse(cond_emb, generator, init_latents, mask,
                                   step_noise)
        if self.raw_motion:
            return z * mask[..., None]
        return self.decode_latent(z, mask)

    @torch.no_grad()
    def generate_joints(self, cond: torch.Tensor, mask: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None,
                        init_latents: Optional[torch.Tensor] = None,
                        step_noise=None) -> torch.Tensor:
        """prompt ids [B, L] (or action ids [B]) + mask [B, T] -> [B, T,
        njoints, 3] joints, zero outside the mask. `init_latents` and
        `step_noise` as in diffusion_reverse."""
        with trace.span("generate"):
            mask = mask.to(self.device)
            feats = self.generate_feats(cond, mask, generator=generator,
                                        init_latents=init_latents,
                                        step_noise=step_noise)
            return self.masked_joints(feats, mask)

    def generate(self, texts: Sequence[str], lengths: Sequence[int],
                 generator: Optional[torch.Generator] = None
                 ) -> List[np.ndarray]:
        """list[str] + list[int] -> list of [len, njoints, 3] numpy arrays."""
        mask = lengths_to_mask(list(lengths), self.max_frames, self.device)
        joints = self.generate_joints(self.tokenize(texts), mask,
                                      generator=generator).cpu().numpy()
        return [joints[i, : int(n)] for i, n in enumerate(lengths)]

    def generate_action(self, actions: Sequence[int],
                        lengths: Optional[Sequence[int]] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> List[np.ndarray]:
        """Action-to-motion: class ids -> list of [len, 24, 3] numpy arrays
        (``mld.py:597-610``). The clip length is ``dataset.num_frames``, and
        each length is cut to it (default: all of it)."""
        actions = np.asarray(actions, np.int64).reshape(-1)
        T = self.cfg.dataset.num_frames
        if lengths is None:
            lengths = [T] * len(actions)
        lengths = [min(int(n), T) for n in lengths]
        mask = lengths_to_mask(lengths, T, self.device)
        joints = self.generate_joints(
            torch.as_tensor(actions, device=self.device), mask,
            generator=generator).cpu().numpy()
        return [joints[i, : n] for i, n in enumerate(lengths)]
