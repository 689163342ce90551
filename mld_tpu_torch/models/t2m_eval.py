"""The frozen t2m evaluator networks (the counterpart of
``mld_tpu/models/t2m_eval.py``): the text and motion towers whose embeddings
give FID, R-precision, Matching score, Diversity and MultiModality.

  TextEncoderBiGRUCo    reference t2m_textenc.py:6-48
  MovementConvEncoder   reference t2m_motionenc.py:6-26
  MotionEncoderBiGRUCo  reference t2m_motionenc.py:29-64

Submodules carry the reference's torch names (``pos_emb``, ``input_emb``,
``gru``, ``hidden``, ``main.{0,3}``, ``output_net.{0,1,3}``, ``out_net``),
so the reference's ``text_mot_match/model/finest.tar`` loads with
``load_state_dict(strict=True)``; the JAX package's trees load through
``utils/convert.py:flax_t2m_to_state_dict``. The movement encoder's
dropouts (``main.1``, ``main.4``) are identities: the networks only ever run
frozen, and the JAX package's evaluator trainer has no dropout either.

The LayerNorm of ``output_net`` uses the JAX package's eps, flax's 1e-6; the
reference's torch modules use 1e-5 (ROADMAP.md section 3).
"""
from __future__ import annotations

import torch
from torch import nn

from mld_tpu_torch.ops.gru import BiGRU

OUTPUT_NET_LN_EPS = 1e-6


def _output_net(hidden_size: int, output_size: int) -> nn.Sequential:
    """Linear (the two final states, 2H -> H) -> LayerNorm ->
    LeakyReLU(0.2) -> Linear (indices 0/1/3)."""
    return nn.Sequential(nn.Linear(2 * hidden_size, hidden_size),
                         nn.LayerNorm(hidden_size, eps=OUTPUT_NET_LN_EPS),
                         nn.LeakyReLU(0.2),
                         nn.Linear(hidden_size, output_size))


def _final_states(module, x, lengths):
    """The BiGRU's two final states, concatenated: [B, 2H]."""
    h0 = module.hidden.expand(2, x.shape[0], module.hidden.shape[-1])
    _, final = module.gru(x, lengths, h0)
    return torch.cat([final[0], final[1]], dim=-1)


class TextEncoderBiGRUCo(nn.Module):
    def __init__(self, word_size: int = 300, pos_size: int = 15,
                 hidden_size: int = 512, output_size: int = 512):
        super().__init__()
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)
        self.gru = BiGRU(hidden_size, hidden_size)
        self.output_net = _output_net(hidden_size, output_size)
        self.hidden = nn.Parameter(torch.empty(2, 1, hidden_size))

    def forward(self, word_embs, pos_onehot, cap_lens):
        """[B, S, 300], [B, S, 15], [B] -> [B, output_size]."""
        x = self.input_emb(word_embs + self.pos_emb(pos_onehot))
        return self.output_net(_final_states(self, x, cap_lens))


class MovementConvEncoder(nn.Module):
    """Two stride-2 Conv1d (kernel 4, padding 1): T -> T/2 -> T/4."""

    def __init__(self, input_size: int = 259, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Identity(),
            nn.LeakyReLU(0.2),
            nn.Conv1d(hidden_size, output_size, 4, 2, 1), nn.Identity(),
            nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, inputs):
        """[B, T, input_size] -> [B, T // 4, output_size]."""
        return self.out_net(self.main(inputs.transpose(1, 2)).transpose(1, 2))


class MotionEncoderBiGRUCo(nn.Module):
    def __init__(self, input_size: int = 512, hidden_size: int = 1024,
                 output_size: int = 512):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = BiGRU(hidden_size, hidden_size)
        self.output_net = _output_net(hidden_size, output_size)
        self.hidden = nn.Parameter(torch.empty(2, 1, hidden_size))

    def forward(self, inputs, m_lens):
        """[B, T, input_size], [B] -> [B, output_size]."""
        return self.output_net(_final_states(self, self.input_emb(inputs),
                                             m_lens))


@torch.no_grad()
def init_evaluator(module: nn.Module, generator: torch.Generator):
    """Random weights with the JAX package's initialiser families at their
    scales (``eval/pipeline.py:58-72``): lecun-normal Linear and Conv
    weights (fan-in = in x kernel), zero biases, unit LayerNorm scales,
    normal(1.0) initial states, and torch's GRU init U(-1/sqrt(H),
    1/sqrt(H)) for every GRU leaf (``mld_tpu/ops/gru.py:21``)."""
    g = generator
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if ".gru." in f".{name}":
            bound = (p.shape[0] // 3) ** -0.5
            p.uniform_(-bound, bound, generator=g)
        elif leaf == "hidden":
            p.normal_(0.0, 1.0, generator=g)
        elif leaf == "weight" and p.dim() >= 2:
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=g)
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()
