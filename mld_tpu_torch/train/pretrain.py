"""CLIP text-tower pretraining for the synthetic end-to-end protocol (the
twin of ``mld_tpu/train/pretrain.py``).

The reference conditions its denoiser on a frozen pretrained CLIP text
encoder (OpenAI's weights), which cannot be fetched here. A random-init
tower's pooled features separate captions only by accident, so a denoiser
trained on them stays at chance R-precision however long it trains. The
synthetic corpus's caption -> style map is deterministic
(``data/synthetic.py:style_vector_from_caption``), so regressing the tower's
"features" output onto the caption's 11-dim style vector through a
throwaway linear probe makes that feature carry the caption's motion
semantics. The tower is then frozen for both training stages, as in the
reference protocol.

The optimizer is optax's ``clip_by_global_norm(1.0)`` + Adam over the tower
and the probe, on a warmup + cosine schedule from 0.05 lr up to lr over
max(20, steps // 10) steps and down to 0.05 lr at `steps`
(``eval/t2m_train.py:ClippedAdam``, optax's f32 arithmetic). The loss is an
f32 MSE; the tower computes in its ``clip_compute_dtype`` (bf16 in every
text preset) on its f32 weights, and each layer's causal attention is K4
through its autograd.Function on the card (kernel forward, the plain
version's VJP). The ids are cropped to their EOT bucket
(``models/mld.py:crop_to_bucket``), exact under causal attention and EOT
pooling: the loss and every gradient are those of the full 77 positions.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from mld_tpu_torch.data.synthetic import style_vector_from_caption
from mld_tpu_torch.eval.t2m_train import ClippedAdam
from mld_tpu_torch.models.mld import crop_to_bucket
from mld_tpu_torch.utils.precision import linear, matmul_precision, session

K_STYLE = 11


def make_probe(text_dim: int, seed: int, device):
    """The linear probe's start (JAX's): w = randn(text_dim, 11) /
    sqrt(text_dim) from ``RandomState(seed)``, b = 0, f32, tracked."""
    w = torch.tensor(np.random.RandomState(seed).randn(text_dim, K_STYLE)
                     * (1.0 / np.sqrt(text_dim)), dtype=torch.float32,
                     device=device, requires_grad=True)
    return w, torch.zeros(K_STYLE, device=device, requires_grad=True)


def style_loss(clip, probe_w, probe_b, ids: torch.Tensor,
               style: torch.Tensor) -> torch.Tensor:
    """The f32 MSE of the probe over the tower's features to the style
    vectors (``pretrain.py:62-65``), the probe's GEMM at the matmul
    precision in force."""
    feat = clip(ids, mode="features")
    return ((linear(feat, probe_w.t()) + probe_b - style) ** 2).mean()


def batch_ids_style(batch, device):
    """A collated batch -> (its ids cropped to their EOT bucket, the style
    vectors of its captions), on `device`."""
    ids = crop_to_bucket(torch.as_tensor(np.asarray(batch["text_ids"]),
                                         dtype=torch.long))
    style = np.stack([style_vector_from_caption(c) for c in batch["text"]])
    return ids.to(device), torch.as_tensor(style, device=device)


def pretrain_clip_text(cfg, dm, mld, steps: int = 800, lr: float = 1e-3,
                       seed: int = 0, log_every: int = 100,
                       on_step: Optional[Callable] = None) -> Dict:
    """Train ``mld.clip`` in place so that its features encode the caption's
    style; returns the report (``steps``, ``style_mse_first`` and
    ``style_mse_last``, the means of the first and last 10 steps' losses).

    Only meaningful on the synthetic corpus (its captions parse with
    ``style_vector_from_caption``). The tower's ``requires_grad`` is on for
    the run and restored afterwards. `on_step(count, loss)` is called after
    each optimizer step with the step's loss tensor. The run is at the
    session's matmul precision (MLD_TPU_MATMUL_PRECISION)."""
    loader = dm.loader("train", seed=seed, drop_last=True)
    if len(loader) == 0:
        raise ValueError("the train split holds fewer clips than a batch")
    clip, device = mld.clip, mld.device
    probe_w, probe_b = make_probe(cfg.model.text_encoded_dim, seed, device)
    tower = list(clip.parameters())
    was = [p.requires_grad for p in tower]
    for p in tower:
        p.requires_grad_(True)
    params = tower + [probe_w, probe_b]
    opt = ClippedAdam(params, steps, lr, warmup=max(20, steps // 10),
                      end=0.05)

    losses = []
    with matmul_precision(session()):
        try:
            while len(losses) < steps:
                for b in loader:
                    ids, style = batch_ids_style(b, device)
                    loss = style_loss(clip, probe_w, probe_b, ids, style)
                    for p in params:
                        p.grad = None
                    loss.backward()
                    opt.step()
                    losses.append(loss.detach())
                    if on_step is not None:
                        on_step(len(losses), losses[-1])
                    if log_every and len(losses) % log_every == 0:
                        mse = float(torch.stack(losses[-20:]).mean())
                        print(f"clip-pretrain step {len(losses)}: "
                              f"style-mse {mse:.5f}", flush=True)
                    if len(losses) >= steps:
                        break
        finally:
            for p, flag in zip(tower, was):
                p.grad = None
                p.requires_grad_(flag)
    curve = torch.stack(losses).tolist()
    return {"steps": len(curve),
            "style_mse_first": float(np.mean(curve[:10])),
            "style_mse_last": float(np.mean(curve[-10:]))}
