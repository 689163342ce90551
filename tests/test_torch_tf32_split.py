"""The three-pass TF32 split that the port's f32 kernels run on the tensor
cores (csrc/flash_attention.cu, csrc/skip_encoder.cu, csrc/skip_decoder.cu,
csrc/flash_causal.cu), emulated on the CPU.

TF32 keeps 10 of f32's 23 stored mantissa bits. The kernels split each f32
operand x into big = tf32(x) and small = x - big, and form a.b as big.big +
small.big + big.small with f32 sums (small.small dropped); the products of
two TF32 values are exact in f32. Here the rounding is done on the bits, the
products by f32 matrix products of the rounded operands, so the emulation
sums in f32 as the tensor cores do (in another order).

Two roundings of big are held: round to nearest even (the rounding the
arithmetic is specified with) and to nearest, ties away, with small
truncated, which is what the kernels do (an integer add and mask for big;
the tensor core truncates the small operand as it reads it). Both must stay
within the bar the kernel is held to on the card: 1e-5 for attention (K3's
and K4's), 1e-4 for the encoder and decoder stacks; and a single TF32 pass
must not, which shows that each comparison can fail.
"""
import numpy as np
import pytest
import torch

from mld_tpu_torch.models.mld import init_params
from mld_tpu_torch.ops import fused_layer, fused_seq_decoder
from mld_tpu_torch.ops.attention import NEG_INF, flash_causal_plain, flash_plain
from mld_tpu_torch.ops.fused_layer import (skip_encoder_stack_plain,
                                           stack_encoder_layer)
from mld_tpu_torch.ops.fused_seq_decoder import (skip_decoder_stack_plain,
                                                 stack_skip_decoder)
from mld_tpu_torch.ops.transformer import (SkipTransformerDecoder,
                                           TransformerEncoderLayer)

MASK = -8192  # 0xFFFFE000 as int32: sign, exponent and 10 mantissa bits


def tf32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """f32 -> the nearest TF32 value, as f32: "even" rounds to nearest,
    ties to even; "away" to nearest, ties away from zero; "trunc" drops the
    low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    if mode == "even":
        bits = bits + 0x0FFF + ((bits >> 13) & 1)
    elif mode == "away":
        bits = bits + 0x1000
    return (bits & MASK).view(torch.float32)


def split(x: torch.Tensor, mode: str):
    big = tf32(x, "even" if mode == "even" else "away")
    small = x - big
    return big, (tf32(small, "trunc") if mode == "away" else small)


def mm_3xtf32(mode):
    """a @ b with both operands split, three TF32 products, f32 sums; with
    mode "single", one product of the operands rounded to TF32."""
    def mm(a, b):
        if mode == "single":
            return tf32(a, "even") @ tf32(b, "even")
        (ab, as_), (bb, bs) = split(a, mode), split(b, mode)
        return ab @ bb + as_ @ bb + ab @ bs
    return mm


def test_rounding_on_the_bits():
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
                      1 + 2.0 ** -11 + 2.0 ** -20], dtype=torch.float32)
    ulp = 2.0 ** -10
    assert tf32(x, "even").tolist() == [1.0, 1.0, 1 + 2 * ulp, -1.0, 1 + ulp]
    assert tf32(x, "away").tolist() == [1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp),
                                        1 + ulp]
    assert tf32(x, "trunc").tolist() == [1.0, 1.0, 1 + ulp, -1.0, 1.0]
    big, small = split(x, "even")
    assert torch.equal(big + small, x)    # the split is exact in f32


def _attention(q, k, v, mm):
    scale = q.shape[-1] ** -0.5
    s = mm(q, k.transpose(-1, -2)) * scale
    return mm(torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("mode,within", [("even", True), ("away", True),
                                         ("single", False)])
def test_attention_bar(mode, within):
    # the s512 self-attention of novae_stress_s512 at one example: q and k
    # ~ N(0, 1), v at half that scale, 4 heads of 128 over 512 frames
    rng = np.random.RandomState(0)
    q, k = (torch.from_numpy(rng.randn(1, 4, 512, 128).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(0.5 * rng.randn(1, 4, 512, 128).astype(np.float32))
    ref = flash_plain(q, k, v, None)
    assert torch.isfinite(ref).all()
    err = (_attention(q, k, v, mm_3xtf32(mode)) - ref).abs().max().item()
    assert (err <= 1e-5) == within, err
    if within:
        assert err > 0      # the emulation did round


@pytest.mark.parametrize("mode,within", [("even", True), ("away", True),
                                         ("single", False)])
def test_encoder_layer_bar(monkeypatch, mode, within):
    # one layer of the denoiser stack at its full width (D=256, H=4, F=1024,
    # S=3) with the main path's random initialisation, through the plain
    # stack at n_block = 0 with every matrix product replaced by the
    # emulation, against the f32 plain stack; K1's bar 1e-4
    layer = TransformerEncoderLayer(256, 4, 1024)
    x = torch.from_numpy(np.random.RandomState(1).randn(64, 3, 256)
                         .astype(np.float32))
    with torch.no_grad():
        init_params(layer, torch.Generator().manual_seed(0))
        st = stack_encoder_layer(layer)
        ref = skip_encoder_stack_plain(x, st, 0, 4)
        monkeypatch.setattr(fused_layer, "_mm", mm_3xtf32(mode))
        out = skip_encoder_stack_plain(x, st, 0, 4)
    assert torch.isfinite(ref).all()
    err = (out - ref).abs().max().item()
    assert (err <= 1e-4) == within, err


@pytest.mark.parametrize("mode,within", [("even", True), ("away", True),
                                         ("single", False)])
def test_causal_bar(mode, within):
    # K4's f32 arm at the CLIP tower's uncropped context: 12 heads of 64 over
    # S = 77, q and k ~ N(0, 1), v at half that scale; K4's bar 1e-5
    rng = np.random.RandomState(2)
    q, k = (torch.from_numpy(rng.randn(1, 12, 77, 64).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(0.5 * rng.randn(1, 12, 77, 64).astype(np.float32))
    scale = 64 ** -0.5
    ref = flash_causal_plain(q, k, v, scale)
    mm = mm_3xtf32(mode)
    neg = torch.full((77, 77), NEG_INF).triu(1)
    p = torch.softmax(mm(q, k.transpose(-1, -2)) * scale + neg, dim=-1)
    err = (mm(p, v) - ref).abs().max().item()
    assert (err <= 1e-5) == within, err
    if within:
        assert err > 0


@pytest.mark.parametrize("mode,within", [("even", True), ("away", True),
                                         ("single", False)])
def test_decoder_stack_bar(monkeypatch, mode, within):
    # the whole VAE decoder stack at its full width (D=256, H=4, F=1024, 9
    # layers) with the main path's random initialisation, 196 frame queries
    # of two sequences (lengths 196 and 77) and one latent token, through the
    # plain stack with every weight product replaced by the emulation,
    # against the f32 plain stack; K5's bar 1e-4
    dec = SkipTransformerDecoder(256, 4, 9, 1024)
    rng = np.random.RandomState(3)
    tgt = torch.from_numpy(rng.randn(2, 196, 256).astype(np.float32))
    mem = torch.from_numpy(rng.randn(2, 1, 256).astype(np.float32))
    valid = torch.arange(196)[None] < torch.tensor([[196], [77]])
    with torch.no_grad():
        init_params(dec, torch.Generator().manual_seed(0))
        st = stack_skip_decoder(dec)
        ref = skip_decoder_stack_plain(tgt, mem, valid, st, 4, 4)
        monkeypatch.setattr(fused_seq_decoder, "_mm", mm_3xtf32(mode))
        out = skip_decoder_stack_plain(tgt, mem, valid, st, 4, 4)
    assert torch.isfinite(ref).all()
    err = (out - ref)[valid].abs().max().item()
    assert (err <= 1e-4) == within, err
