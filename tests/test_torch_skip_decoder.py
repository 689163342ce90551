"""Port's VAE decoder stack (K5) vs the JAX package: the plain PyTorch stack
against ``fused_skip_decoder`` run in interpret mode, the port's
``fused_vae_decode`` against JAX's, and the stacked weights. Same numpy
inputs and weights on both sides (weights carried by ``flax_to_state_dict``).
The CUDA kernels themselves are checked against the same plain stack on the
card by ``chip_smoke.py``.

Tolerances: f32 atol 1e-4, the bar ``tests/test_fused_seq_decoder.py`` holds
the TPU kernel to; both sides use LayerNorm eps 1e-5 (the kernel's).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.vae import MldVae as JaxVae
from mld_tpu.ops.fused_seq_decoder import (_stack_decoder_params,
                                           fused_skip_decoder,
                                           fused_vae_decode as jax_vae_decode)
from mld_tpu.ops.transformer import SkipTransformerDecoder as JaxSkipDecoder

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.models.vae import MldVae
from mld_tpu_torch.ops import fused_seq_decoder
from mld_tpu_torch.ops.attention import flash_plain
from mld_tpu_torch.ops.fused_seq_decoder import (_attend, can_fuse_decode,
                                                 fused_vae_decode,
                                                 launch_count,
                                                 skip_decoder_stack,
                                                 skip_decoder_stack_plain,
                                                 stack_skip_decoder,
                                                 workspace_bytes)
from mld_tpu_torch.ops.transformer import SkipTransformerDecoder
from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.convert import flax_to_state_dict


def _decoder_pair(B, S, M, D, H, F, L, lengths, seed=0):
    rng = np.random.RandomState(seed)
    tgt = rng.randn(B, S, D).astype(np.float32)
    mem = rng.randn(B, M, D).astype(np.float32)
    valid = np.arange(S)[None] < np.asarray(lengths)[:, None]
    jdec = JaxSkipDecoder(d_model=D, num_heads=H, num_layers=L, ff_size=F,
                          dropout=0.0)
    params = jdec.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(tgt),
                       jnp.asarray(mem), jnp.asarray(valid))["params"]
    dec = SkipTransformerDecoder(D, H, L, F)
    dec.load_state_dict(flax_to_state_dict(params))
    return tgt, mem, valid, params, dec


def _jax_stack(tgt, mem, valid, params, L, H, **kw):
    return np.asarray(fused_skip_decoder(
        jnp.asarray(tgt), jnp.asarray(mem), jnp.asarray(valid), params, L, H,
        interpret=True, tile_b=2, **kw))


def _plain(tgt, mem, valid, dec, L, H, weight_dtype=torch.float32):
    return skip_decoder_stack_plain(
        torch.from_numpy(tgt), torch.from_numpy(mem), torch.from_numpy(valid),
        stack_skip_decoder(dec, weight_dtype), (L - 1) // 2, H).numpy()


@pytest.mark.parametrize("B,S,M,D,H,F,L,lengths", [
    (5, 30, 1, 64, 4, 128, 3, [30, 27, 7, 29, 12]),
    (4, 26, 2, 64, 2, 96, 5, [26, 23, 7, 25]),  # 2 latent tokens, 2 levels
    (3, 19, 1, 64, 4, 128, 3, [19, 1, 7]),      # 3 rows over tile_b=2, len 1
])
def test_plain_stack_matches_jax_kernel(B, S, M, D, H, F, L, lengths):
    tgt, mem, valid, params, dec = _decoder_pair(B, S, M, D, H, F, L, lengths)
    ref = _jax_stack(tgt, mem, valid, params, L, H)
    out = _plain(tgt, mem, valid, dec, L, H)
    assert out.shape == ref.shape == (B, S, D)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[valid], ref[valid], atol=1e-4, rtol=1e-4)


def test_plain_stack_bf16_weights_matches_jax_kernel():
    # both sides round the weights AND the activation operand to bf16 and
    # accumulate exact products in f32, so they agree to f32 summation order.
    # Where an activation sits on a bf16 rounding boundary, one side can round
    # it the other way and move a product by one bf16 ulp of that operand
    # (2^-8 relative), which later layers and their LayerNorms carry on. The
    # bf16 stack is that sensitive by itself: a 1e-7 relative perturbation of
    # its input moves it by up to 5.2e-3 at these weights (f32 weights:
    # 1.4e-6); the two packages differ by 1.6e-3. Hence 1e-2, still below the
    # bf16-vs-f32 gap (1.85e-2 here) that the second assertion requires
    B, S, M, D, H, F, L = 5, 30, 1, 64, 4, 128, 3
    tgt, mem, valid, params, dec = _decoder_pair(
        B, S, M, D, H, F, L, [30, 27, 7, 29, 12])
    ref = _jax_stack(tgt, mem, valid, params, L, H,
                     weight_dtype=jnp.bfloat16)
    st = stack_skip_decoder(dec, torch.bfloat16)
    assert st.wqkv_s.dtype == torch.bfloat16 and st.bqkv_s.dtype == torch.float32
    out = _plain(tgt, mem, valid, dec, L, H, torch.bfloat16)
    np.testing.assert_allclose(out[valid], ref[valid], atol=1e-2)
    f32 = _plain(tgt, mem, valid, dec, L, H)
    assert np.abs(f32[valid] - out[valid]).max() > 1e-2


@pytest.fixture(scope="module")
def vae_pair():
    B, T, nfeats, D, L = 4, 29, 67, 64, 3
    jvae = JaxVae(nfeats=nfeats, latent_dim=D, latent_size=1, ff_size=128,
                  num_layers=L, num_heads=4, dropout=0.1,
                  arch="encoder_decoder")
    rng = np.random.RandomState(0)
    feats = rng.randn(B, T, nfeats).astype(np.float32)
    lens = np.array([T, T - 5, 9, T - 1])
    mask = np.arange(T)[None] < lens[:, None]
    params = jvae.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(feats),
                       jnp.asarray(mask))["params"]
    vae = MldVae(nfeats, 1, D, 128, L, 4)
    vae.load_state_dict(flax_to_state_dict(params))
    z = rng.randn(B, 1, D).astype(np.float32)
    return params, vae, z, mask


def test_fused_vae_decode_matches_jax(vae_pair):
    params, vae, z, mask = vae_pair
    ref = jax_vae_decode(params, jnp.asarray(z), jnp.asarray(mask),
                         num_layers=3, num_heads=4, nfeats=67,
                         interpret=True, tile_b=2)
    out = fused_vae_decode(vae, torch.from_numpy(z), torch.from_numpy(mask))
    assert out.shape == (4, 29, 67)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    assert not out.numpy()[~mask].any()


def test_stacked_weights_equal_jax_layout():
    cfg_over = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 5,
                          "denoiser_num_layers": 3, "num_heads": 4,
                          "text_encoded_dim": 48, "clip_layers": 1,
                          "clip_heads": 2, "clip_compute_dtype": "float32"},
                "dataset": {"max_motion_len": 40}}
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=cfg_over))
    params = jax.tree_util.tree_map(np.asarray,
                                    jmld.init_params(jax.random.PRNGKey(0)))
    mld = MLD(load_config(preset="mld_humanml3d", overrides=cfg_over),
              fused_decode=True, device="cpu")
    mld.load_flax_params(params)
    st = mld.vae.stacked_decoder()
    dec = params["vae"]["decoder"]
    layers = ([dec[f"input_blocks_{i}"] for i in range(2)]
              + [dec["middle_block"]]
              + [dec[f"output_blocks_{i}"] for i in range(2)])
    ref = _stack_decoder_params(layers)
    # beyond JAX's fields: the skip linears split in two, and the kernels'
    # [out, in] copies of the matrices
    assert len(ref) == len(st) - 3 - len(fused_seq_decoder._PACKED)
    for name, want in zip(st._fields, ref):
        got = getattr(st, name).numpy()
        np.testing.assert_array_equal(got, np.asarray(want).reshape(got.shape),
                                      err_msg=name)
    skips = [dec[f"linear_blocks_{i}"] for i in range(2)]
    np.testing.assert_array_equal(
        st.wsx.numpy(), np.stack([s["kernel"][:64] for s in skips]))
    np.testing.assert_array_equal(
        st.wss.numpy(), np.stack([s["kernel"][64:] for s in skips]))
    np.testing.assert_array_equal(st.bs.numpy(),
                                  np.stack([s["bias"] for s in skips]))


def test_wrapper_takes_plain_version_on_cpu_only():
    tgt, mem, valid, _, dec = _decoder_pair(3, 12, 1, 64, 4, 128, 3,
                                            [12, 5, 1])
    st = stack_skip_decoder(dec)
    args = (torch.from_numpy(tgt), torch.from_numpy(mem),
            torch.from_numpy(valid))
    before = trace.total("launch.k5")
    out = skip_decoder_stack(*args, st, 1, 4)
    np.testing.assert_array_equal(
        out.numpy(), skip_decoder_stack_plain(*args, st, 1, 4).numpy())
    assert trace.total("launch.k5") == before
    with pytest.raises(ValueError, match="no skip-decoder kernel"):
        skip_decoder_stack(*(a.to("meta") for a in args), st, 1, 4)
    # the kernels are forward-only: off the CPU an input autograd tracks is
    # refused rather than cut from its graph
    grad_tgt = torch.zeros(3, 12, 64, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        skip_decoder_stack(grad_tgt, *(a.to("meta") for a in args[1:]), st,
                           1, 4)


def test_kernel_argument_checks():
    tgt, mem, valid, _, dec = _decoder_pair(2, 12, 1, 64, 4, 128, 3, [12, 5])
    st = stack_skip_decoder(dec)
    t, m = torch.from_numpy(tgt), torch.from_numpy(mem)
    v = torch.from_numpy(valid).int()
    check = fused_seq_decoder._check
    check(t, m, v, st, 1, 4)                                # accepted
    with pytest.raises(ValueError, match="tgt must be contiguous f32"):
        check(t.double(), m, v, st, 1, 4)
    with pytest.raises(ValueError, match="mem must be"):
        check(t, torch.zeros(2, 9, 64), v, st, 1, 4)
    with pytest.raises(ValueError, match="valid must be"):
        check(t, m, v.bool(), st, 1, 4)
    with pytest.raises(ValueError, match="head width"):
        check(t, m, v, st, 1, 32)
    with pytest.raises(ValueError, match="stacked.wqkv_x"):
        check(t, m, v, st._replace(wqkv_x=st.wqkv_x[:2]), 1, 4)
    with pytest.raises(ValueError, match="stacked.ln3b"):
        check(t, m, v, st._replace(ln3b=st.ln3b.double()), 1, 4)


def test_launch_count_and_workspace():
    # flagship: 9 layers, one latent token: the key mask, then per layer 7
    # kernels (QKV, K3, Wo + LN1 + LN2, the latent's value and out
    # projections, W1, W2 + LN3) and 4 skip merges; 2 latent tokens take the
    # general cross-attention path (two kernels more a layer)
    assert launch_count(4, 1) == 68
    assert launch_count(4, 2) == 86
    assert launch_count(0, 1) == 8
    # B=128, T=196, D=256, F=1024, n=4: 283 MB of scratch with f32 weights;
    # bf16 weights keep the skip stack and the FFN hidden layer in bf16
    assert workspace_bytes(128, 196, 1, 256, 1024, 4, False) == 283_009_536
    assert workspace_bytes(128, 196, 1, 256, 1024, 4, True) == 205_939_200
    # every buffer starts on a 256-byte boundary: R=7 rows of D=64 give 1792
    # bytes a buffer, the QKV buffer 5376, and the latent's K/V (512), the
    # cross output (256) and the key mask (7) round up
    assert workspace_bytes(1, 7, 1, 64, 128, 0, False) == (
        3 * 1792 + 5376 + 512 + 256 + 256)


def _untile(t, N, K):
    """The inverse of fused_seq_decoder.tile_weights, written out: [L, P,
    N * K] tiles of 64 rows x 128 bytes, 16-byte piece c of row r at c ^ (r
    % 8) -> [L, P, N, K]."""
    L, P = t.shape[:2]
    e = 16 // t.element_size()
    v = t.reshape(L, P, N // 64, K // (8 * e), 64, 8, e)
    out = torch.empty(L, P, N // 64, 64, K // (8 * e), 8, e, dtype=t.dtype)
    for r in range(64):
        for c in range(8):
            out[:, :, :, r, :, c] = v[:, :, :, :, r, c ^ (r % 8)]
    return out.reshape(L, P, N, K)


@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
def test_kernel_weights_reconstruct_stacked(weight_dtype):
    # the kernels' copies of the matrices hold exactly the stacked weights:
    # transposed to [out, in], tiled, and for f32 split into a TF32 part
    # (low 13 bits zero) and the rest, whose sum is the weight
    _, _, _, _, dec = _decoder_pair(2, 12, 1, 128, 4, 192, 3, [12, 5])
    st = stack_skip_decoder(dec, weight_dtype)
    mats = {"pqkv_s": st.wqkv_s, "pwo_s": st.wo_s, "pqkv_x": st.wqkv_x,
            "pwo_x": st.wo_x, "pw1": st.w1, "pw2": st.w2,
            "pws": torch.cat([st.wsx, st.wss], dim=1)}
    for name, m in mats.items():
        want = m.transpose(1, 2)
        got = _untile(getattr(st, name), *want.shape[1:])
        assert got.dtype == weight_dtype, name
        if weight_dtype == torch.bfloat16:
            assert got.shape[1] == 1, name
            assert torch.equal(got[:, 0], want), name
        else:
            big, small = got[:, 0], got[:, 1]
            assert torch.equal(big + small, want), name
            assert not (big.view(torch.int32) & 0x1FFF).any(), name
            assert (small.abs() <= big.abs() * 2.0 ** -11).all(), name


def test_self_attention_through_k3_plain():
    # K5's self-attention is K3 on the heads of the packed QKV projection
    # with key 0 always valid: K3's plain version under that mask equals the
    # plain stack's attention (a sequence of length 0 included)
    rng = np.random.RandomState(4)
    B, T, D, H = 3, 20, 64, 4
    q, k, v = (torch.from_numpy(rng.randn(B, T, D).astype(np.float32))
               for _ in range(3))
    valid = torch.arange(T)[None] < torch.tensor([[20], [7], [0]])
    key_ok = valid.clone()
    key_ok[:, 0] = True
    ref = _attend(q / np.sqrt(D // H), k, v, key_ok, H)

    def heads(t):
        return t.reshape(B, T, H, D // H).transpose(1, 2)

    out = flash_plain(heads(q), heads(k), heads(v), key_ok)
    out = out.transpose(1, 2).reshape(B, T, D)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


def test_can_fuse_decode_rules():
    m = load_config(preset="mld_humanml3d").model
    assert can_fuse_decode(m)
    for override in ({"latent_size": 9}, {"normalize_before": True},
                     {"vae_arch": "all_encoder"},
                     {"position_embedding": "sine"}):
        cfg = load_config(preset="mld_humanml3d",
                          overrides={"model": override})
        assert not can_fuse_decode(cfg.model), override
    assert not can_fuse_decode(load_config(preset="novae_humanml3d").model)
    with pytest.raises(ValueError, match="fused_decode needs"):
        MLD(load_config(preset="mld_humanml3d",
                        overrides={"model": {"latent_size": 9}}),
            fused_decode=True, device="cpu")


def test_decoder_stack_follows_loads_and_moves(vae_pair):
    params, _, _, _ = vae_pair
    vae = MldVae(67, 1, 64, 128, 3, 4)
    vae.load_state_dict(flax_to_state_dict(params))
    first = vae.stacked_decoder()
    w = vae.decoder.middle_block.multihead_attn.in_proj_weight
    np.testing.assert_array_equal(first.wqkv_x[1].numpy(),
                                  w.detach().t().numpy())
    other = {k: v * 2 for k, v in flax_to_state_dict(params).items()}
    vae.load_state_dict(other)
    np.testing.assert_array_equal(vae.stacked_decoder().wqkv_x.numpy(),
                                  2 * first.wqkv_x.numpy())
    np.testing.assert_array_equal(vae.stacked_decoder().b1.numpy(),
                                  2 * first.b1.numpy())
    vae.to("meta")
    assert vae.stacked_decoder().w1.device.type == "meta"
