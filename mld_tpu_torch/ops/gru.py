"""The bidirectional GRU of the t2m evaluator networks (the counterpart of
``mld_tpu/ops/gru.py``).

``BiGRU`` is a single-layer bidirectional ``nn.GRU`` (torch's gate order
r|z|n and parameter names ``weight_ih_l0``, ``..._reverse``), run over
``pack_padded_sequence`` as the reference's evaluators run it
(``t2m_textenc.py:42``, ``t2m_motionenc.py:59``): the forward final state is
the state after step ``len-1``, the backward final state the state after
consuming ``len-1 .. 0``. The JAX package gets the same semantics from a
masked scan; ``bigru_plain`` is that scan as a loop, the plain version the
tests hold ``BiGRU`` against. No Pallas kernel is behind either: on the card
``nn.GRU`` runs cuDNN's.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class BiGRU(nn.GRU):
    """Single-layer bidirectional GRU over [B, T, I] with per-row lengths."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=True, device=device)

    def forward(self, x: torch.Tensor, lengths, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, I], lengths [B] (each >= 1), h0 [2, B, H] ->
        (outputs [B, T, 2H], zero past each length; final [2, B, H])."""
        lengths = torch.as_tensor(lengths).to("cpu", torch.int64)
        packed = pack_padded_sequence(x, lengths, batch_first=True,
                                      enforce_sorted=False)
        out, final = super().forward(packed, h0.contiguous())
        out, _ = pad_packed_sequence(out, batch_first=True,
                                     total_length=x.shape[1])
        return out, final


def _cell(x_t, h, w_ih, w_hh, b_ih, b_hh):
    """One torch-semantics GRU step (``mld_tpu/ops/gru.py:_gru_step``)."""
    i_r, i_z, i_n = (x_t @ w_ih.T + b_ih).chunk(3, dim=-1)
    h_r, h_z, h_n = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_scan_plain(x, lengths, h0, w_ih, w_hh, b_ih, b_hh, reverse=False):
    """The masked GRU of ``mld_tpu/ops/gru.py:gru_scan``: the state
    advances only where t < length. Returns (outputs [B, T, H], the state
    after each step in time order; final [B, H])."""
    T = x.shape[1]
    lengths = torch.as_tensor(lengths, device=x.device)
    h, outs = h0, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new = _cell(x[:, t], h, w_ih, w_hh, b_ih, b_hh)
        h = torch.where((t < lengths)[:, None], h_new, h)
        outs[t] = h
    return torch.stack(outs, dim=1), h


def bigru_plain(gru: BiGRU, x, lengths, h0):
    """``BiGRU``'s function as the JAX package computes it, a masked loop
    each way: (outputs [B, T, 2H], final [2, B, H]). Unlike ``BiGRU``'s,
    the outputs past a row's length hold the carried state, not zeros."""
    out_f, fin_f = gru_scan_plain(x, lengths, h0[0], gru.weight_ih_l0,
                                  gru.weight_hh_l0, gru.bias_ih_l0,
                                  gru.bias_hh_l0)
    out_b, fin_b = gru_scan_plain(x, lengths, h0[1], gru.weight_ih_l0_reverse,
                                  gru.weight_hh_l0_reverse,
                                  gru.bias_ih_l0_reverse,
                                  gru.bias_hh_l0_reverse, reverse=True)
    return torch.cat([out_f, out_b], -1), torch.stack([fin_f, fin_b])
