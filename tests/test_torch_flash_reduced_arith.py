"""The arithmetic of K3's reduced arms on f32 tensors, emulated on the CPU
(``csrc/flash_attention.cu:flash_reduced_kernel``, one sweep over the keys).

The kernel computes ``sdpa_xla``'s function at a reduced precision: q, k,
the normalised probabilities and v rounded (to TF32 under "high", to bf16
under "default"), f32 scores, softmax and sums. It does not take the plain
version's operations to get there: each score is scaled by
f32(sm_scale * log2(e)) and takes one 2^x on the multi-function unit
(``ex2.approx``, relative error within 2^-22) less the row's max; a row's
sum is taken by its four threads, each over its own keys in order, then
across the four; p is e times one reciprocal of the sum, then rounded to the
arm's type; and each 32-key tile's P.V goes into a fresh f32 sum that a
rounded add folds into the output, but for TF32 at Dh 128, whose warpgroup
MMAs sum every key tile in one accumulator.

The emulation does that step by step, each exponential perturbed by a random
relative error of up to 2^-22, and is held against ``flash_plain`` at the
same arithmetic within the bars ``chip_smoke.py`` holds the kernel to on the
card (``REDUCED_RMS_RATIO`` times the f32 result's RMS gap to the plain
version, and ``REDUCED_MAX_BAR`` of scale). Two planted faults must miss the
same bars, which shows that each comparison can fail: the unnormalised
exponentials rounded (the bf16-tensor arm's rounding points), and 3xTF32
left in place (the emulation with no operand rounded).
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from mld_tpu_torch.ops.attention import NEG_INF, flash_plain
from mld_tpu_torch.utils import precision

EX2_REL_ERR = 2.0 ** -22
TILE = 32           # keys a tile of the kernel's P.V
LOG2E = 1.4426950408889634

# (B, H, Sq, Sk, Dh, mask): hidden mode's 79 tokens, the plain VAE decode's
# 196 frames against [latent; frames] under [1; mask], rows off every tile
# with a fully masked example, the module denoiser's 3 tokens, and raw
# motion's 198 tokens at its Dh of 128
CASES = {
    "hidden": (2, 4, 79, 79, 64, None),
    "decode": (2, 4, 196, 197, 64, [197, 121]),
    "ragged": (2, 3, 131, 70, 32, [70, 0]),
    "three": (3, 2, 3, 3, 64, None),
    "raw": (1, 2, 198, 198, 128, None),
}
ARITHS = ("tf32", "bf16")


def _inputs(case):
    B, H, Sq, Sk, Dh, lengths = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = torch.from_numpy(rng.standard_normal((B, H, Sq, Dh), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, H, Sk, Dh), np.float32))
    v = torch.from_numpy(0.5 * rng.standard_normal((B, H, Sk, Dh),
                                                   np.float32))
    valid = None
    if lengths is not None:
        valid = torch.arange(Sk)[None, :] < torch.tensor(lengths)[:, None]
    return q, k, v, valid


def _round(x, arith):
    return x if arith == "f32" else precision.round_bits(x, arith)


def emulate(q, k, v, valid, arith, seed, fault=None):
    """The kernel's arithmetic in `arith` ("f32" leaves every operand as it
    is); fault "unnormalised" rounds e instead of p and divides P.V by the
    row's sum after."""
    Dh, Sk = q.shape[-1], k.shape[-2]
    scale2 = np.float32(np.float32(1.0 / math.sqrt(Dh)) * np.float32(LOG2E))
    s = _round(q, arith) @ _round(k, arith).transpose(-1, -2)
    x = s * torch.tensor(scale2)
    if valid is not None:
        x = x.masked_fill(~valid[:, None, None, :], NEG_INF)
    e = torch.exp2(x - x.amax(-1, keepdim=True))
    g = torch.Generator().manual_seed(seed)
    e = e * (1 + EX2_REL_ERR * (2 * torch.rand(e.shape, generator=g) - 1))
    # the row's sum: thread t of the row's four holds keys 8c + 2t and
    # 8c + 2t + 1 of every column c and adds their pair in order of c; then
    # the four partial sums, pairwise
    n8 = -(-Sk // 8)
    pairs = torch.nn.functional.pad(e, (0, 8 * n8 - Sk))
    pairs = pairs.reshape(*e.shape[:-1], n8, 4, 2).sum(-1)
    part = torch.zeros_like(pairs[..., 0, :])
    for c in range(n8):
        part = part + pairs[..., c, :]
    l = ((part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3]))
    inv = torch.reciprocal(l)[..., None]
    p = e if fault == "unnormalised" else e * inv
    pr, vr = _round(p, arith), _round(v, arith)
    tile = Sk if arith == "tf32" and Dh == 128 else TILE
    o = torch.zeros(*q.shape[:-1], v.shape[-1])
    for t0 in range(0, Sk, tile):
        o = o + pr[..., t0:t0 + tile] @ vr[..., t0:t0 + tile, :]
    return o * inv if fault == "unnormalised" else o


def _over(case, arith, **kw):
    """How far the emulation is along phase 3's bars (1 is at a bar)."""
    q, k, v, valid = _inputs(case)
    ref = flash_plain(q, k, v, valid, arithmetic=arith)
    f32 = flash_plain(q, k, v, valid)
    fault = kw.pop("fault", None)
    out = emulate(q, k, v, valid, "f32" if fault == "3xtf32" else arith,
                  seed=7, fault=fault)
    assert torch.isfinite(out).all()
    rms, mx = chip_smoke._reduced_errs(torch, out, ref)
    f32_rms, _ = chip_smoke._reduced_errs(torch, f32, ref)
    return chip_smoke._reduced_over(arith, rms, mx, f32_rms)


def test_rounding_and_scale_constants():
    # TF32 ties to even on the bits, as the kernel's tf32_rne rounds
    x = torch.tensor([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11], dtype=torch.float32)
    assert precision.round_bits(x, "tf32").tolist() == [1.0, 1 + 2.0 ** -9]
    # 2^(x log2 e) is e^x up to the f32 rounding of the folded scale
    x = torch.linspace(-30, 0, 301)
    rel = (torch.exp2(x * LOG2E) / torch.exp(x) - 1).abs().max().item()
    assert rel < 2e-6


@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_within_bars(case, arith):
    over = _over(case, arith)
    assert over <= 1.0, f"{case} {arith}: {over:.3f} of the bars"


@pytest.mark.parametrize("fault", ("unnormalised", "3xtf32"))
@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_planted_fault_misses_bars(case, arith, fault):
    over = _over(case, arith, fault=fault)
    assert over > 1.0, f"{case} {arith} {fault}: {over:.3f} of the bars"
