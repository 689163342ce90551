"""Supervised training of the HumanAct12 GRU action classifier (the twin of
``mld_tpu/eval/a2m_train.py``).

The reference evaluates a2m with a frozen action-recognition GRU shipped as
``actionrecognition/humanact12_gru.tar``, which cannot be fetched here; a
random classifier puts accuracy at chance and makes the FID order
meaningless. This trains the same network (``models/humanact12_gru.py``)
with cross-entropy on the class-conditioned synthetic corpus
(``data/a2m.py:synth_humanact12_pkl``), on what the metric reads: the
SMPL-topology joints of ``mld.feats2joints`` flattened to [B, T, 72]. The
optimizer is the JAX package's ``clip_by_global_norm(1.0)`` + Adam over a
warmup + cosine schedule (``eval/t2m_train.py:ClippedAdam``, optax's f32
arithmetic). ``save_a2m_params`` writes the weights as the JAX package's
npz, ``humanact12_gru_params.npz``, which ``Evaluator`` loads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mld_tpu_torch.eval.t2m_train import ClippedAdam
from mld_tpu_torch.models.humanact12_gru import build_classifier
from mld_tpu_torch.utils.checkpoint import save_params_npz
from mld_tpu_torch.utils.convert import state_dict_to_flax_humanact12
from mld_tpu_torch.utils.precision import matmul_precision


def train_a2m_classifier(cfg, dm, mld, steps: int = 600, lr: float = 1e-3,
                         seed: int = 0, log_every: int = 100,
                         params: Optional[Dict] = None
                         ) -> Tuple[Dict, Dict]:
    """Train the classifier on ground-truth joints of `dm`'s train split,
    on `mld`'s device, from `params` (the JAX package's tree) or random
    weights of `seed`. Returns (the trained weights as the JAX package's
    tree of numpy arrays, a report: the loss curve's ends and the last
    batch accuracies)."""
    device = mld.device
    model = build_classifier(params, cfg.model.nclasses, device, seed)
    model.train()   # cuDNN's RNN backward runs only in training mode
    model.requires_grad_(True)
    weights = list(model.parameters())
    opt = ClippedAdam(weights, steps, lr)
    loader = dm.loader("train", seed=seed)

    losses, accs = [], []
    while len(losses) < steps:
        for b in loader:
            mask = torch.as_tensor(b["mask"], device=device)
            with torch.no_grad():
                joints = mld.feats2joints(
                    torch.as_tensor(b["motion"], device=device), mask)
            joints = joints.reshape(joints.shape[0], joints.shape[1], -1)
            labels = torch.as_tensor(np.asarray(b["action"]),
                                     dtype=torch.long, device=device)
            with matmul_precision("highest"):
                _, logits = model(joints, np.asarray(b["length"]))
                loss = F.cross_entropy(logits, labels)
                for p in weights:
                    p.grad = None
                loss.backward()
                opt.step()
            acc = (logits.argmax(-1) == labels).float().mean()
            # one host read a step
            loss_v, acc_v = torch.stack([loss, acc]).detach().tolist()
            losses.append(loss_v)
            accs.append(acc_v)
            if log_every and len(losses) % log_every == 0:
                print(f"a2m-cls step {len(losses)}: ce {losses[-1]:.4f} "
                      f"acc {np.mean(accs[-20:]):.3f}", flush=True)
            if len(losses) >= steps:
                break
    report = {
        "steps": len(losses),
        "loss_first": float(np.mean(losses[:10])),
        "loss_last": float(np.mean(losses[-10:])),
        "train_acc_last": float(np.mean(accs[-20:])),
    }
    return state_dict_to_flax_humanact12(model.state_dict()), report


def save_a2m_params(path: str, params: Dict):
    """The classifier's tree as the JAX package's npz (keys joined by "/":
    ``recurrent/weight_ih_l0``, ``linear1/kernel``, ...)."""
    save_params_npz(path, params)
