"""Contrastive training of the t2m evaluator bundle (the twin of
``mld_tpu/eval/t2m_train.py``).

The reference evaluates with frozen text/motion matching networks shipped
as ``t2m/.../text_mot_match/model/finest.tar``, which cannot be fetched
here; random-init evaluators put R-precision at chance. This trains the same
three networks on the caption-conditioned synthetic corpus with the JAX
package's objective, in evaluator normalisation space (what the protocol
feeds them):
  - logits: negative squared euclidean distances between the text and
    motion embeddings (the quantity R-precision ranks by) over their
    stop-gradient batch mean, at temperature 0.1;
  - the symmetric cross-entropy over those logits (InfoNCE);
  - plus the MSE of both towers' first 11 dims to the caption's style
    vector (``data/synthetic.py:style_vector_from_caption``).
The optimizer is optax's ``clip_by_global_norm(1.0)`` + Adam over a warmup
+ cosine schedule (peak lr, warmup max(20, steps // 10) from 0.05 lr, down
to 0.1 lr at `steps`), written out here in optax's f32 arithmetic
(``warmup_cosine``, whose warmup and end the CLIP pretraining and the
end-to-end protocol set to their own). ``save_t2m_params`` writes the
weights as the JAX bundle's npz, which ``cfg.eval.t2m_params_path`` reads in
either package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mld_tpu_torch.data.synthetic import style_vector_from_caption
from mld_tpu_torch.eval.pipeline import T2MEvaluatorBundle
from mld_tpu_torch.utils.precision import matmul_precision
from mld_tpu_torch.models.mld import resolve_device
from mld_tpu_torch.utils.checkpoint import save_params_npz

BATCH_KEYS = ("motion", "mask", "length", "word_embs", "pos_ohot",
              "text_len")


def warmup_cosine(step: int, steps: int, lr: float,
                  warmup: Optional[int] = None, end: float = 0.1) -> float:
    """optax.warmup_cosine_decay_schedule(0.05 lr, lr, warmup, steps,
    end x lr) at `step`, in its f32 arithmetic: a linear warmup over
    `warmup` steps (default max(20, steps // 10), the evaluator's), then a
    cosine from lr down to `end` x lr at `steps`. The three users: the
    evaluator (end 0.1), the CLIP pretraining (warmup max(20, steps // 10),
    end 0.05, ``mld_tpu/train/pretrain.py:56-59``) and the end-to-end
    protocol's AdamW (warmup max(50, steps // 20), end 0.02,
    ``scripts/train_synthetic_e2e.py:209-213``). optax refuses a run no
    longer than its warmup; here such a run stays in the warmup."""
    f32 = np.float32
    if warmup is None:
        warmup = max(20, steps // 10)
    init, peak, end = lr * 0.05, lr, lr * end
    if step < warmup:
        frac = f32(1) - f32(step) / f32(warmup)
        return float(f32(init - peak) * frac + f32(peak))
    decay = f32(steps - warmup)
    count = min(f32(step - warmup), decay)
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count / decay))
    alpha = end / peak
    return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))


class ClippedAdam:
    """optax.chain(clip_by_global_norm(1.0), adam(schedule)), in optax's f32
    arithmetic: the gradients scaled by 1 / their global norm when it is
    above 1, then Adam (b1 0.9, b2 0.999, eps 1e-8) whose bias corrections
    1 - b**t are f32 (1 - 0.999 is 1.00005e-3 there, against torch.optim's
    float64 1e-3: 2.3e-5 of the first update), at the lr that
    ``warmup_cosine(count, steps, lr, warmup, end)`` gives for the step
    count before this step."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.Tensor], steps: int, lr: float,
                 warmup: Optional[int] = None, end: float = 0.1):
        self.params = params
        self.steps, self.lr = steps, lr
        self.warmup, self.end = warmup, end
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params]
        # accumulated in f64: torch's f32 norm of a 3M-element leaf on the
        # CPU drifts by up to 8e-5 (optax's sum holds 1e-6)
        norm = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(g, dtype=torch.float64)
            for g in grads])).float()
        lr = warmup_cosine(self.count, self.steps, self.lr,
                           self.warmup, self.end)
        self.count += 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(norm < 1.0, g, g / norm)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1.to(p.device)) / (
                torch.sqrt(nu / bc2.to(p.device)) + self.eps)
            p.add_(-lr * u)


def contrastive_loss(bundle: T2MEvaluatorBundle, batch: Dict, style,
                     stats: Tuple, unit_len: int, temperature: float = 0.1,
                     style_weight: float = 1.0):
    """The objective on one batch (tensors on the bundle's device) ->
    (loss, batch top-1, nce, style mse). `stats` = (mean, std, mean_eval,
    std_eval)."""
    mean, std, mean_e, std_e = stats
    # model-space z-norm -> evaluator norm (datamodule renorm4t2m)
    feats_e = ((batch["motion"] * std + mean - mean_e) / std_e
               * batch["mask"][..., None])
    m_emb = bundle.motionencoder(
        bundle.moveencoder(feats_e[..., :-4]),
        torch.clamp(batch["length"] // unit_len, min=1))
    t_emb = bundle.textencoder(batch["word_embs"], batch["pos_ohot"],
                               batch["text_len"])
    d2 = ((t_emb ** 2).sum(-1)[:, None] - 2.0 * t_emb @ m_emb.T
          + (m_emb ** 2).sum(-1)[None])
    scale = d2.mean().detach() + 1e-6
    logits = -(d2 / scale) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    nce = 0.5 * (F.cross_entropy(logits, labels)
                 + F.cross_entropy(logits.T, labels))
    k = style.shape[-1]
    style_mse = (((t_emb[:, :k] - style) ** 2).mean()
                 + ((m_emb[:, :k] - style) ** 2).mean())
    acc = (logits.argmax(-1) == labels).float().mean()
    return nce + style_weight * style_mse, acc, nce, style_mse


def batch_to(batch: Dict, device) -> Tuple[Dict, torch.Tensor]:
    """A collated batch -> (its tensors on `device`, the style targets).
    Raises for captions that are not the synthetic corpus's."""
    out = {k: torch.as_tensor(np.asarray(batch[k]), device=device)
           for k in BATCH_KEYS}
    # the GRUs pack their lengths on the host
    out["text_len"] = torch.as_tensor(np.asarray(batch["text_len"]))
    try:
        style = np.stack([style_vector_from_caption(c)
                          for c in batch["text"]])
    except StopIteration:
        raise ValueError(
            "train_t2m_evaluator targets the synthetic corpus (captions "
            "must parse to style vectors); for real datasets use the "
            "released finest.tar evaluators") from None
    return out, torch.as_tensor(style, device=device)


def train_t2m_evaluator(cfg, dm, steps: int = 600, lr: float = 5e-4,
                        temperature: float = 0.1, seed: int = 0,
                        batch_size: Optional[int] = None,
                        style_weight: float = 1.0, log_every: int = 100,
                        device="cuda") -> Tuple[T2MEvaluatorBundle, Dict]:
    """Train the bundle contrastively on `dm`'s train split, on the card
    unless `device` names another. The bundle starts from
    ``cfg.eval.t2m_params_path`` when set, else from random weights of
    `seed`. Returns (the bundle, frozen again; a report: the loss curve's
    ends and the final in-batch top-1)."""
    device = resolve_device(device)
    bundle = T2MEvaluatorBundle(cfg, device=device, seed=seed)
    bundle.train()   # cuDNN's RNN backward runs only in training mode
    bundle.requires_grad_(True)
    params = [p for p in bundle.parameters()]
    opt = ClippedAdam(params, steps, lr)
    stats = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in (dm.mean, dm.std, dm.mean_eval, dm.std_eval))
    loader = dm.eval_embedding_loader("train", batch_size=batch_size,
                                      seed=seed)
    if len(loader) == 0:
        raise ValueError("the train split holds fewer clips than a batch")

    losses, accs, mses = [], [], []
    while len(losses) < steps:
        for b in loader:
            batch, style = batch_to(b, device)
            with matmul_precision("highest"):
                loss, acc, nce, mse = contrastive_loss(
                    bundle, batch, style, stats, cfg.dataset.unit_len,
                    temperature, style_weight)
                for p in params:
                    p.grad = None
                loss.backward()
                opt.step()
            # one host read a step
            nce, acc, mse = torch.stack([nce, acc, mse]).detach().tolist()
            losses.append(nce)
            accs.append(acc)
            mses.append(mse)
            if log_every and len(losses) % log_every == 0:
                print(f"t2m-eval step {len(losses)}: nce {losses[-1]:.4f} "
                      f"style-mse {mses[-1]:.4f} "
                      f"batch-top1 {np.mean(accs[-20:]):.3f}", flush=True)
            if len(losses) >= steps:
                break
    bundle.eval()
    bundle.requires_grad_(False)
    report = {
        "steps": len(losses),
        "loss_first": float(np.mean(losses[:10])),
        "loss_last": float(np.mean(losses[-10:])),
        "style_mse_last": float(np.mean(mses[-10:])),
        "batch_top1_last": float(np.mean(accs[-20:])),
    }
    return bundle, report


def save_t2m_params(path: str, bundle: T2MEvaluatorBundle):
    """The bundle's weights as the JAX bundle's npz ({"text", "move",
    "motion"} trees, keys joined by "/")."""
    save_params_npz(path, bundle.params_tree())
