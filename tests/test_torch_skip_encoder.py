"""Port's denoiser stack (K1) vs the JAX package: the plain PyTorch stack
against ``fused_skip_encoder`` run in interpret mode, and the port's fused
denoiser forward against JAX's. Same numpy inputs and weights on both sides
(weights carried by ``flax_to_state_dict``). The CUDA kernel itself is
checked against the same plain stack on the card by ``chip_smoke.py``.

Tolerances: f32 atol 5e-5 / rtol 1e-4, the bar ``tests/test_fused_layer.py``
holds the TPU kernel to; both sides use LayerNorm eps 1e-5 (the kernel's).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.models.denoiser import MldDenoiser as JaxDenoiser
from mld_tpu.ops.fused_denoiser import (
    fused_denoiser_forward as jax_fused_denoiser_forward)
from mld_tpu.ops.fused_layer import fused_skip_encoder
from mld_tpu.ops.transformer import SkipTransformerEncoder as JaxSkipEncoder

from mld_tpu_torch.models.denoiser import MldDenoiser
from mld_tpu_torch.ops import fused_layer
from mld_tpu_torch.ops.fused_denoiser import (fused_denoiser_forward,
                                              precompute_cond)
from mld_tpu_torch.ops.fused_layer import (cluster_size, pack_fragments,
                                           pack_tiles, seq_per_block,
                                           skip_encoder_stack,
                                           skip_encoder_stack_plain,
                                           smem_bytes, stack_skip_encoder)
from mld_tpu_torch.ops.transformer import SkipTransformerEncoder
from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.convert import flax_to_state_dict


def _stack_pair(L, D, H, F, B, S=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, D).astype(np.float32)
    jax_stack = JaxSkipEncoder(d_model=D, num_heads=H, num_layers=L,
                               ff_size=F, dropout=0.0)
    params = jax_stack.init({"params": jax.random.PRNGKey(seed)},
                            jnp.asarray(x))["params"]
    enc = SkipTransformerEncoder(D, H, L, F)
    enc.load_state_dict(flax_to_state_dict(params))
    return x, params, enc


@pytest.mark.parametrize("L,D,H,F,B", [
    (3, 64, 2, 128, 8),
    (9, 256, 4, 1024, 2),   # flagship width, small batch
])
def test_plain_stack_matches_jax_kernel(L, D, H, F, B):
    x, params, enc = _stack_pair(L, D, H, F, B)
    ref = fused_skip_encoder(jnp.asarray(x), params, L, H, interpret=True)
    out = skip_encoder_stack_plain(torch.from_numpy(x),
                                   stack_skip_encoder(enc), (L - 1) // 2, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=5e-5, rtol=1e-4)


def test_plain_stack_bf16_weights_matches_jax_kernel():
    # both sides round weights AND the activation operand to bf16 and
    # accumulate exact products in f32, so they agree to f32 summation
    # order; an activation that sits on a bf16 rounding boundary can round
    # the other way on one side and move a product by one bf16 ulp of the
    # operand (2^-8 relative), which 3 layers and their LayerNorms carry to
    # the output: hence 1e-3, two orders below the bf16-vs-f32 gap checked
    # by the second assertion
    L, D, H, F, B = 3, 64, 2, 128, 8
    x, params, enc = _stack_pair(L, D, H, F, B)
    ref = fused_skip_encoder(jnp.asarray(x), params, L, H, interpret=True,
                             weight_dtype=jnp.bfloat16)
    st = stack_skip_encoder(enc, torch.bfloat16)
    assert st.wqkv.dtype == torch.bfloat16 and st.bqkv.dtype == torch.float32
    out = skip_encoder_stack_plain(torch.from_numpy(x), st, 1, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)
    f32 = skip_encoder_stack_plain(torch.from_numpy(x),
                                   stack_skip_encoder(enc), 1, H)
    assert np.abs(f32.numpy() - out.numpy()).max() > 1e-3


def test_wrapper_takes_plain_version_on_cpu_only():
    L, D, H, F, B = 3, 64, 2, 128, 4
    x, _, enc = _stack_pair(L, D, H, F, B)
    st = stack_skip_encoder(enc)
    xt = torch.from_numpy(x)
    before = trace.total("launch.k1")
    out = skip_encoder_stack(xt, st, 1, H)
    np.testing.assert_array_equal(
        out.numpy(), skip_encoder_stack_plain(xt, st, 1, H).numpy())
    assert trace.total("launch.k1") == before
    with pytest.raises(ValueError, match="no skip-encoder kernel"):
        skip_encoder_stack(xt.to("meta"), st, 1, H)


def test_kernel_argument_checks():
    L, D, H, F, B = 3, 64, 2, 128, 4
    x, _, enc = _stack_pair(L, D, H, F, B)
    st = stack_skip_encoder(enc)
    xt = torch.from_numpy(x)
    fused_layer._check(xt, st, 1, H)                       # accepted
    with pytest.raises(ValueError, match="f32"):
        fused_layer._check(xt.double(), st, 1, H)
    with pytest.raises(ValueError, match="S <= 8"):
        fused_layer._check(torch.zeros(2, 9, D), st, 1, H)
    with pytest.raises(ValueError, match="stacked.wqkv"):
        fused_layer._check(xt, st._replace(wqkv=st.wqkv[:2]), 1, H)
    with pytest.raises(ValueError, match="stacked.b1"):
        fused_layer._check(xt, st._replace(b1=st.b1.double()), 1, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_is_checked_once_a_stack(dtype):
    # the wrapper checks a stack and shape once and keeps the C entry's
    # fixed arguments; the same stack again reuses them, another stack (new
    # tensors) or an input the kernel refuses is checked again
    L, D, H, F, B = 3, 64, 2, 128, 4
    _, _, enc = _stack_pair(L, D, H, F, B)
    st = stack_skip_encoder(enc, dtype)
    x = torch.zeros(B, 3, D)
    plan = fused_layer._plan(x, st, 1, H, num_sms=132)
    assert fused_layer._plan(x, st, 1, H, num_sms=132) is plan
    assert plan.weights == tuple(getattr(st, f).data_ptr()
                                 for f in fused_layer._KERNEL_FIELDS)
    assert (plan.spb, plan.cluster) == (
        seq_per_block(B, 3),
        cluster_size(1, D, F, 132, dtype == torch.bfloat16, H))
    other = stack_skip_encoder(enc, dtype)
    assert fused_layer._plan(x, other, 1, H, num_sms=132) is not plan
    with pytest.raises(ValueError, match="f32"):
        fused_layer._plan(x.double(), st, 1, H, num_sms=132)
    with pytest.raises(ValueError, match="contiguous"):
        fused_layer._plan(torch.zeros(3, B, D).transpose(0, 1), st, 1, H,
                          num_sms=132)


@pytest.mark.parametrize("n_seq,expect", [(2, 2), (132, 10), (133, 10),
                                          (256, 10), (4096, 10)])
def test_tile_choice(n_seq, expect):
    # S=3: as many sequences as 32 rows hold (10), fewer only for fewer
    assert seq_per_block(n_seq, 3) == expect


@pytest.mark.parametrize("K,N", [(256, 768), (1024, 256), (64, 128)])
def test_pack_fragments_is_the_kernels_read_order(K, N):
    # csrc/skip_encoder.cu, f32 arm: lane 4g + t loads 16 bytes of n-tile j
    # at k pair p, element 2s + e of step s, from element
    # ((p * N/8 + j) * 32 + lane) * 4 + ...; b0 = row 2t, b1 = row 2t+1 of
    # the step (k permuted)
    w = torch.randn(2, K, N)
    p, j, g, t, st, e = np.meshgrid(
        np.arange(K // 16), np.arange(N // 8), np.arange(8), np.arange(4),
        np.arange(2), np.arange(2), indexing="ij")
    idx = ((p * (N // 8) + j) * 32 + 4 * g + t) * 4 + st * 2 + e
    k = p * 16 + st * 8 + 2 * t + e
    n = 8 * j + g
    packed = pack_fragments(w)
    assert packed.shape == (2, K * N) and packed.dtype == torch.float32
    for layer in range(2):
        np.testing.assert_array_equal(packed[layer].numpy()[idx.ravel()],
                                      w[layer].numpy()[k.ravel(), n.ravel()])
    assert np.array_equal(np.sort(idx.ravel()), np.arange(K * N))


@pytest.mark.parametrize("K,N", [(256, 768), (1024, 256), (256, 1024),
                                 (64, 128)])
def test_pack_tiles_is_the_kernels_read_order(K, N):
    # csrc/skip_encoder.cu, bf16 arm: the producer copies tile (mt, ks) of a
    # matrix, 8 KB from byte (mt * K/64 + ks) * 8192, and wgmma reads its
    # element (output feature 64 mt + f, k = 64 ks + 8 c + e) at byte
    # f * 128 + (c ^ (f % 8)) * 16 + 2 e (K-major, 128-byte swizzle)
    w = torch.randn(2, K, N).to(torch.bfloat16)
    mt, ks, f, c, e = np.meshgrid(
        np.arange(N // 64), np.arange(K // 64), np.arange(64), np.arange(8),
        np.arange(8), indexing="ij")
    idx = (mt * (K // 64) + ks) * 4096 + f * 64 + (c ^ (f % 8)) * 8 + e
    k = 64 * ks + 8 * c + e
    n = 64 * mt + f
    packed = pack_tiles(w)
    assert packed.shape == (2, K * N) and packed.dtype == torch.bfloat16
    for layer in range(2):
        np.testing.assert_array_equal(
            packed[layer].float().numpy()[idx.ravel()],
            w[layer].float().numpy()[k.ravel(), n.ravel()])
    assert np.array_equal(np.sort(idx.ravel()), np.arange(K * N))


def test_pack_tiles_keeps_widths_the_kernel_refuses():
    # a stack whose widths are not whole tiles is still stacked (the plain
    # version runs it on the CPU); the kernel refuses it in _check
    w = torch.randn(2, 48, 96).to(torch.bfloat16)
    assert torch.equal(pack_tiles(w), w.reshape(2, 48 * 96))


@pytest.mark.parametrize("dtype,pack", [(torch.float32, pack_fragments),
                                        (torch.bfloat16, pack_tiles)])
def test_stack_packs_each_arm_in_its_order(dtype, pack):
    L, D, H, F, B = 3, 64, 2, 128, 4
    _, _, enc = _stack_pair(L, D, H, F, B)
    st = stack_skip_encoder(enc, dtype)
    for packed, mat in (("pqkv", "wqkv"), ("pwo", "wo"), ("pw1", "w1"),
                        ("pw2", "w2"), ("psx", "wsx"), ("pss", "wss")):
        assert torch.equal(getattr(st, packed), pack(getattr(st, mat)))


@pytest.mark.parametrize("n_tiles,D,F,bf16,H,expect", [
    (1, 256, 1024, False, 4, 8), (16, 256, 1024, False, 4, 8),
    (17, 256, 1024, False, 4, 4), (33, 256, 1024, False, 4, 4),
    (34, 256, 1024, False, 4, 2), (26, 256, 1024, False, 4, 4),
    (67, 256, 1024, False, 4, 1), (1, 128, 512, False, 4, 8),
    (1, 16, 64, False, 4, 2), (1, 24, 48, False, 4, 1),
    # bf16: whole 64-feature tiles of wgmma a block, so at most D / 64, and
    # whole heads a block
    (1, 256, 1024, True, 4, 4), (26, 256, 1024, True, 4, 4),
    (33, 256, 1024, True, 4, 4), (34, 256, 1024, True, 4, 2),
    (66, 256, 1024, True, 4, 2), (67, 256, 1024, True, 4, 1),
    (103, 256, 1024, True, 4, 1), (1, 128, 512, True, 4, 2),
    (1, 64, 128, True, 4, 1), (1, 256, 1024, True, 2, 2),
    (1, 256, 1024, True, 8, 4)])
def test_cluster_choice(n_tiles, D, F, bf16, H, expect):
    # on a 132-SM card: the most blocks a tile that keep every block on an
    # SM and give each block whole n-tiles of D and F (8 columns for the f32
    # arm's mma.sync, 64 output features and whole heads for the bf16 arm's
    # wgmma)
    assert cluster_size(n_tiles, D, F, 132, bf16, H) == expect


@pytest.mark.parametrize("D,F,H,S,fits", [
    (256, 1024, 4, 3, True), (256, 1024, 4, 8, True), (64, 128, 4, 3, True),
    (128, 512, 4, 3, True), (512, 2048, 8, 3, False)])
def test_bf16_ring_fits(D, F, H, S, fits):
    # the bf16 arm's buffers beside a ring of MIN_STAGES weight tiles (the C
    # entry requires ring_stages >= 4) fit shared memory at the port's widths
    assert (smem_bytes(D, F, H, S, bf16=True) <= fused_layer.SMEM_LIMIT) == fits


def _denoiser_pair(D, TD, layers, seed=0):
    rng = np.random.RandomState(seed)
    B = 8
    sample = rng.randn(B, 1, D).astype(np.float32)
    cond = rng.randn(B, 1, TD).astype(np.float32)
    jden = JaxDenoiser(nfeats=263, condition="text", latent_size=1,
                       latent_dim=D, ff_size=4 * D, num_layers=layers,
                       num_heads=4, dropout=0.1, arch="trans_enc",
                       skip_connect=True, text_encoded_dim=TD)
    params = jden.init({"params": jax.random.PRNGKey(seed)},
                       jnp.asarray(sample), jnp.asarray(0),
                       jnp.asarray(cond))["params"]
    den = MldDenoiser(1, D, 4 * D, layers, 4, TD)
    den.load_state_dict(flax_to_state_dict(params))
    return sample, cond, params, den


@pytest.mark.parametrize("D,TD,layers", [(64, 48, 3), (256, 768, 9)])
def test_fused_denoiser_matches_jax(D, TD, layers):
    sample, cond, params, den = _denoiser_pair(D, TD, layers)
    ref = jax_fused_denoiser_forward(
        params, jnp.asarray(sample), jnp.asarray(981), jnp.asarray(cond),
        num_heads=4, num_layers=layers, latent_dim=D, text_encoded_dim=TD,
        interpret=True)
    out = fused_denoiser_forward(den, torch.from_numpy(sample), 981,
                                 torch.from_numpy(cond))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)


def test_hoisted_preamble_matches_inline():
    sample, cond, _, den = _denoiser_pair(64, 48, 3)
    s, c = torch.from_numpy(sample), torch.from_numpy(cond)
    timesteps = torch.tensor([981, 761, 41])
    time_tab, cond_lat = precompute_cond(den, timesteps, c)
    assert time_tab.shape == (3, 64) and cond_lat.shape == (8, 1, 64)
    for i, t in enumerate(timesteps.tolist()):
        inline = den.fused_forward(s, t, c)
        hoisted = den.fused_forward(s, t, c, time_emb=time_tab[i],
                                    cond_lat=cond_lat)
        np.testing.assert_allclose(hoisted.numpy(), inline.numpy(),
                                   atol=1e-6, rtol=0)


def test_stacked_weights_follow_loads():
    _, _, params, den = _denoiser_pair(64, 48, 3)
    first = den.stacked_encoder().wqkv.clone()
    other = {k: v * 2 for k, v in flax_to_state_dict(params).items()}
    den.load_state_dict(other)
    w = den.encoder.input_blocks[0].self_attn.in_proj_weight
    np.testing.assert_array_equal(den.stacked_encoder().wqkv[0].numpy(),
                                  w.detach().t().numpy())
    np.testing.assert_array_equal(den.stacked_encoder().wqkv.numpy(),
                                  2 * first.numpy())
