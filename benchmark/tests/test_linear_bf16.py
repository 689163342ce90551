"""On the card (marked ``card``; skipped without one): the bf16 linear kernel
(``mld_tpu_torch/ops/linear_bf16.py``, ``csrc/linear_bf16.cu``), the
forward of every reduced linear under "default", against its plain version
on the CPU (``precision.linear_plain``: ``bf16(x) @ bf16(w).T + b`` in
f32) within ``chip_smoke.PREC_GEMM_RTOL`` of each result's scale, at the
shapes of ``scripts/bench_linear_bf16.py:SHAPES``: the raw-motion
denoiser's (12,544 frame rows, the 263-feature pose embedding and
projection, 64-128 memory rows), the t2m plain decode's at B=128 and 512
(d 256, FF 1,024, 263 features) and the ACTOR decode's (150 features); a
bias-less call, M = 1 and 64, and a K too deep for one block's shared
memory. Repeated launches are bitwise equal, and the wrapper
raises on operands it does not take.

    python3 -m pytest benchmark/tests/test_linear_bf16.py -m card
"""
import pytest
import torch

import chip_smoke
from mld_tpu_torch.ops.linear_bf16 import linear_bf16
from mld_tpu_torch.scripts.bench_linear_bf16 import SHAPES, operands
from mld_tpu_torch.utils.precision import linear_plain


def _operands(M, K, N, bias, device, seed=0):
    cpu = operands(torch, M, K, N, bias, seed)
    return cpu, tuple(None if t is None else t.to(device) for t in cpu)


@pytest.mark.card
@pytest.mark.parametrize("M,K,N,bias", [s[1:] for s in SHAPES])
def test_kernel_is_its_plain_version(card, M, K, N, bias):
    (x, w, b), (cx, cw, cb) = _operands(M, K, N, bias, card)
    got = linear_bf16(cx, cw, cb)
    torch.cuda.synchronize()
    want = linear_plain(x, w, b, "bf16")
    err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    assert got.shape == (M, N) and err <= chip_smoke.PREC_GEMM_RTOL, err


@pytest.mark.card
def test_launches_are_bitwise_equal(card):
    _, (x, w, b) = _operands(12544, 512, 1536, True, card, seed=1)
    first = linear_bf16(x, w, b)
    for _ in range(19):
        assert torch.equal(linear_bf16(x, w, b), first)


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take(card):
    _, (x, w, b) = _operands(64, 256, 128, True, card)
    for args in ((x.double(), w, b), (x, w.bfloat16(), b),
                 (x.t().contiguous().t(), w, b), (x, w[:, ::2], b),
                 (x.cpu(), w, b), (x, w, b.cpu()), (x, w[:64], b),
                 (x[:, :128], w, b)):
        with pytest.raises(ValueError):
            linear_bf16(*args)
