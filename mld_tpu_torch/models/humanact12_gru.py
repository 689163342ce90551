"""The HumanAct12 GRU action classifier, the a2m accuracy / FID evaluator
(port of ``mld_tpu/models/humanact12_gru.py``).

Parity target: mld/models/architectures/humanact12_gru.py:6-92: a two-layer
unidirectional GRU over the flattened joints [B, T, 72], the output at
``clip(length - 1)``, ``tanh(linear1)`` features (30, the FID variant), then
``linear2`` logits. The GRU is ``nn.GRU(num_layers=2)`` over packed
sequences (cuDNN's on the card), as the t2m evaluators' ``ops/gru.py:BiGRU``;
the JAX package's masked scan gives the same output at each length. The
parameter names are the reference's (``recurrent.weight_ih_l{k}``,
``linear1``, ``linear2``), so ``humanact12_gru.tar`` loads as it is.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

FEATURE_DIM = 30


class MotionDiscriminator(nn.Module):
    def __init__(self, input_size: int = 72, hidden_size: int = 128,
                 hidden_layers: int = 2, output_size: int = 12):
        super().__init__()
        self.hidden_size = hidden_size
        self.recurrent = nn.GRU(input_size, hidden_size, hidden_layers,
                                batch_first=True)
        self.linear1 = nn.Linear(hidden_size, FEATURE_DIM)
        self.linear2 = nn.Linear(FEATURE_DIM, output_size)

    def forward(self, motion: torch.Tensor, lengths
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """motion [B, T, input_size], lengths [B] (each >= 1) -> (the
        tanh(linear1) features [B, 30], logits [B, output_size])."""
        B, T, _ = motion.shape
        lengths = torch.as_tensor(lengths).to("cpu", torch.int64)
        if (lengths < 1).any():
            raise ValueError("every sequence needs a frame")
        packed = pack_padded_sequence(motion, lengths, batch_first=True,
                                      enforce_sorted=False)
        out, _ = self.recurrent(packed)
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=T)
        # the output after each sequence's last frame
        idx = (lengths.clamp(max=T) - 1).to(motion.device)
        last = out[torch.arange(B, device=motion.device), idx]
        feats = torch.tanh(self.linear1(last))
        return feats, self.linear2(feats)


@torch.no_grad()
def init_classifier(model: MotionDiscriminator, generator: torch.Generator):
    """Random weights of the JAX package's families: the GRU torch's
    U(+-1/sqrt(H)), the Dense layers lecun-normal with zero biases."""
    bound = model.hidden_size ** -0.5
    for name, p in model.named_parameters():
        if name.startswith("recurrent."):
            p.uniform_(-bound, bound, generator=generator)
        elif name.endswith("weight"):
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        else:
            p.zero_()


def convert_humanact12_checkpoint(tar_path: str) -> Dict:
    """humanact12_gru.tar -> the JAX package's param tree of numpy arrays
    (flat ``recurrent/<name>`` leaves, Dense ``kernel`` [in, out] and
    ``bias``)."""
    ckpt = torch.load(tar_path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt)
    params: Dict = {}
    for k, v in state.items():
        arr = v.detach().cpu().numpy().astype(np.float32)
        if k.startswith("recurrent."):
            params[f"recurrent/{k.split('.', 1)[1]}"] = arr
        elif k.startswith(("linear1.", "linear2.")):
            mod, leaf = k.split(".")
            params.setdefault(mod, {})[
                "kernel" if leaf == "weight" else "bias"] = (
                arr.T if leaf == "weight" else arr)
    return params


def build_classifier(params: Optional[Dict], num_labels: int, device,
                     seed: int = 0) -> MotionDiscriminator:
    """The classifier, frozen, on `device`: `params` (the JAX package's
    tree) through the bridge, or random weights from `seed`."""
    from mld_tpu_torch.utils.convert import flax_humanact12_to_state_dict
    model = MotionDiscriminator(output_size=num_labels)
    if params is not None:
        model.load_state_dict(flax_humanact12_to_state_dict(params),
                              strict=True)
    else:
        init_classifier(model, torch.Generator().manual_seed(seed))
    model.to(device).eval().requires_grad_(False)
    return model
