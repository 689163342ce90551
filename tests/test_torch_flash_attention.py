"""Port's bidirectional attention (K3's wrapper ``sdpa`` and its plain
version ``flash_plain``), the decoder stack and the ``trans_dec`` raw-motion
denoiser vs the JAX package.

The plain version runs on CPU tensors; the JAX side runs ``sdpa_pallas``
in interpret mode, as its own tests do, and its modules with
``use_pallas=True``, which reach that kernel. Bars: f32 1e-5 and bf16 2e-2
(``tests/test_attention.py``) for the kernel, 2e-5 for the stack and the
denoiser (``tests/test_transformer_parity.py``). The CUDA kernel is held
against the same plain version on the card by ``chip_smoke.py``.

Fully masked rows: the port computes ``sdpa_xla``'s mean of v over the Sk
keys; ``sdpa_pallas`` pads Sk to a multiple of 128 and divides by that
(ROADMAP.md, section 3), so those rows are held against ``sdpa_xla``.
"""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.models.denoiser import MldDenoiser as JaxDenoiser
from mld_tpu.ops.attention import sdpa_pallas, sdpa_xla
from mld_tpu.ops.transformer import TransformerDecoder as JaxDecoder

from mld_tpu_torch.models.denoiser import RawMotionDenoiser
from mld_tpu_torch.ops import attention
from mld_tpu_torch.ops.attention import flash_operands, flash_plain, sdpa
from mld_tpu_torch.ops.transformer import MultiheadAttention, TransformerDecoder
from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.convert import flax_to_state_dict


def _qkv(B, H, Sq, Sk, Dh, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Sq, Dh).astype(np.float32),
            rng.randn(B, H, Sk, Dh).astype(np.float32),
            rng.randn(B, H, Sk, Dh).astype(np.float32))


# lengths of the valid keys a row (every row keeps at least one); None = all
CASES = {
    "self, partial masks": ((3, 2, 20, 20, 16), [20, 7, 1]),
    "self, no mask": ((2, 4, 33, 33, 32), None),
    "cross, Sk=1": ((2, 4, 40, 1, 16), None),
    "cross, Sk=2": ((3, 2, 40, 2, 64), None),
    "ragged Sk, masked": ((2, 2, 33, 70, 64), [70, 65]),
    "Sk past one key tile": ((1, 2, 9, 130, 128), [129]),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("jdt,tdt,atol", [
    (jnp.float32, torch.float32, 1e-5),
    (jnp.bfloat16, torch.bfloat16, 2e-2),
])
def test_plain_matches_jax_kernel(case, jdt, tdt, atol):
    shape, lengths = CASES[case]
    B, H, Sq, Sk, Dh = shape
    q, k, v = _qkv(*shape, seed=1)
    valid = (None if lengths is None
             else np.arange(Sk)[None] < np.asarray(lengths)[:, None])
    ref = sdpa_pallas(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                      jnp.asarray(v, jdt),
                      None if valid is None else jnp.asarray(valid),
                      interpret=True)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    tv = None if valid is None else torch.from_numpy(valid)
    before = trace.total("launch.k3")
    out = sdpa(*t, tv)
    assert trace.total("launch.k3") == before      # CPU: the plain version
    assert out.dtype == tdt and out.shape == (B, H, Sq, Dh)
    np.testing.assert_array_equal(out.float().numpy(),
                                  flash_plain(*t, tv).float().numpy())
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


def test_fully_masked_row_is_sdpa_xla():
    # example 1 has no valid key: its rows average v over the Sk = 20 keys,
    # as sdpa_xla; sdpa_pallas averages over 128 padded keys, so its rows
    # there are exactly 20/128 of that
    B, H, S, Dh = 2, 2, 20, 16
    q, k, v = _qkv(B, H, S, S, Dh, seed=2)
    valid = np.ones((B, S), bool)
    valid[1] = False
    valid[0, 13:] = False
    jargs = [jnp.asarray(a) for a in (q, k, v)] + [jnp.asarray(valid)]
    xla = np.asarray(sdpa_xla(*jargs))
    pallas = np.asarray(sdpa_pallas(*jargs, interpret=True))
    out = sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
               torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(out, xla, atol=1e-5)
    np.testing.assert_allclose(out[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), out[1].shape), atol=1e-6)
    # the divergence lies in the JAX kernel, and only on that row
    np.testing.assert_allclose(pallas[0], xla[0], atol=1e-5)
    np.testing.assert_allclose(pallas[1], xla[1] * S / 128, atol=1e-6)


def test_plain_f32_is_the_earlier_plain_attention():
    # in f32 flash_plain computes what the port's plain sdpa computed
    # before K3 (the port of sdpa_xla), bit for bit
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 11, 5, 8, seed=3))
    valid = torch.tensor([[True] * 5, [True, True, False, False, False]])
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(8))
    scores = scores.masked_fill(~valid[:, None, None, :], attention.NEG_INF)
    earlier = torch.matmul(torch.softmax(scores, dim=-1), v)
    np.testing.assert_array_equal(flash_plain(q, k, v, valid).numpy(),
                                  earlier.numpy())


def test_kernel_takes_packed_views_without_copies():
    # the self-attention hands sdpa views into the packed QKV projection
    # (row stride 3d) and cross-attention views of [B, S, d]; the kernel is
    # given their pointers and strides as they are, and writes the output
    # as [B, Sq, H, Dh] memory
    B, S, M, H, Dh = 2, 7, 2, 4, 16
    d = H * Dh
    qkv = torch.randn(B, S, 3 * d)
    q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    valid = torch.ones(B, S, dtype=torch.bool)
    attention._check_flash(q, k, v, valid)
    out, args, kept = flash_operands(q, k, v, valid)
    assert [t.data_ptr() for t in kept[:3]] == [q.data_ptr(), k.data_ptr(),
                                               v.data_ptr()]
    assert args[3] == valid.data_ptr() and args[5:10] == (B, H, S, S, Dh)
    assert args[10:13] == (S * 3 * d, Dh, 3 * d)          # q's strides
    assert args[19:22] == (S * d, Dh, d) == out.stride()[:3]
    assert out.shape == (B, H, S, Dh)
    assert out.transpose(1, 2).is_contiguous()   # merging heads is a view
    assert args[22] == pytest.approx(1 / 4) and args[23] == 0
    mem = torch.randn(B, M, d)
    km = mem.reshape(B, M, H, Dh).transpose(1, 2)
    _, args, _ = flash_operands(q, km, km, None)
    assert args[3] is None and args[8] == M
    assert args[13:16] == (M * d, Dh, d)
    # a tensor without a unit stride along Dh is the one copy
    qt = q.transpose(2, 3).contiguous().transpose(2, 3)
    _, _, kept = flash_operands(qt, k, v, None)
    assert kept[0].data_ptr() != qt.data_ptr() and kept[0].is_contiguous()


def test_kernel_argument_checks():
    q = torch.zeros(2, 4, 10, 16)
    k = torch.zeros(2, 4, 3, 16)
    attention._check_flash(q, k, k, torch.ones(2, 3, dtype=torch.bool))
    attention._check_flash(q.bfloat16(), k.bfloat16(), k.bfloat16(), None)
    with pytest.raises(ValueError, match="k must be"):
        attention._check_flash(q, k.bfloat16(), k, None)
    with pytest.raises(ValueError, match="v must be"):
        attention._check_flash(q, k, torch.zeros(2, 4, 4, 16), None)
    with pytest.raises(ValueError, match="f32 or bf16"):
        attention._check_flash(q.double(), k.double(), k.double(), None)
    with pytest.raises(ValueError, match="multiple of 4 up to 128"):
        odd = torch.zeros(2, 4, 10, 30)
        attention._check_flash(odd, odd, odd, None)
    with pytest.raises(ValueError, match="multiple of 4 up to 128"):
        wide = torch.zeros(1, 1, 4, 132)
        attention._check_flash(wide, wide, wide, None)
    with pytest.raises(ValueError, match="key_valid must be"):
        attention._check_flash(q, k, k, torch.ones(2, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="key_valid must be"):
        attention._check_flash(q, k, k, torch.ones(2, 3))


def _meta(t, grad):
    return torch.zeros(t.shape, device="meta", requires_grad=grad)


def test_wrapper_refuses_other_devices_and_autograd():
    # the wrapper is differentiable (its autograd.Function recomputes the
    # plain version's VJP), so autograd is no longer refused: a device
    # without the kernel is, tracked or not
    q = torch.zeros(2, 2, 8, 16)
    with pytest.raises(ValueError, match="no attention kernel for device"):
        sdpa(_meta(q, True), _meta(q, True), _meta(q, True))
    with torch.no_grad():
        with pytest.raises(ValueError, match="no attention kernel for device"):
            sdpa(_meta(q, True), _meta(q, True), _meta(q, True))
    with pytest.raises(ValueError, match="no attention kernel for device"):
        sdpa(_meta(q, False), _meta(q, False), _meta(q, False))
    # on the CPU the plain version keeps the graph
    qc = torch.randn(2, 2, 8, 16, requires_grad=True)
    sdpa(qc, qc, qc).sum().backward()
    assert qc.grad is not None and torch.isfinite(qc.grad).all()


# ------------------------------------------------------ decoder and denoiser
@pytest.mark.parametrize("final_norm", [True, False])
def test_decoder_stack_matches_jax(final_norm):
    D, H, F, L = 64, 4, 128, 3
    rng = np.random.RandomState(0)
    tgt = rng.randn(2, 12, D).astype(np.float32)
    mem = rng.randn(2, 2, D).astype(np.float32)
    tgt_valid = np.arange(12)[None] < np.array([[12], [5]])
    jdec = JaxDecoder(D, H, L, F, dropout=0.0, final_norm=final_norm,
                      use_pallas=True)
    p = jdec.init(jax.random.PRNGKey(0), jnp.asarray(tgt),
                  jnp.asarray(mem))["params"]
    dec = TransformerDecoder(D, H, L, F, final_norm=final_norm)
    dec.load_state_dict(flax_to_state_dict(p))
    assert ("norm.weight" in dec.state_dict()) == final_norm
    with torch.no_grad():
        for valid in (None, tgt_valid):
            ref = jdec.apply({"params": p}, jnp.asarray(tgt),
                             jnp.asarray(mem),
                             None if valid is None else jnp.asarray(valid))
            out = dec(torch.from_numpy(tgt), torch.from_numpy(mem),
                      None if valid is None else torch.from_numpy(valid))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=2e-5)


def test_multihead_attention_via_kernel_wrapper_matches_jax_pallas():
    # the packed self-attention and a cross-attention over 2 memory tokens
    from mld_tpu.ops.transformer import MultiheadAttention as JaxMHA
    D, H = 64, 4
    rng = np.random.RandomState(4)
    x = rng.randn(3, 9, D).astype(np.float32)
    mem = rng.randn(3, 2, D).astype(np.float32)
    jm = JaxMHA(D, H, use_pallas=True)
    xj = jnp.asarray(x)
    p = jm.init(jax.random.PRNGKey(0), xj, xj, xj)["params"]
    port = MultiheadAttention(D, H)
    port.load_state_dict(flax_to_state_dict(p))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(port(xt, xt, xt).numpy(),
                                   np.asarray(jm.apply({"params": p}, xj, xj,
                                                       xj)), atol=2e-5)
        mt = torch.from_numpy(mem)
        ref = jm.apply({"params": p}, xj, jnp.asarray(mem), jnp.asarray(mem))
        np.testing.assert_allclose(port(xt, mt, mt).numpy(), np.asarray(ref),
                                   atol=2e-5)


@pytest.mark.parametrize("D,TD,T,masked", [(64, 48, 40, True),
                                           (64, 64, 17, False)])
def test_raw_motion_denoiser_matches_jax(D, TD, T, masked):
    NF, F, L, B = 263, 128, 3, 4
    rng = np.random.RandomState(5)
    sample = rng.randn(B, T, NF).astype(np.float32)
    text = rng.randn(B, 1, TD).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[T], [T - 3], [1], [T]])
            if masked else None)
    jden = JaxDenoiser(nfeats=NF, latent_dim=D, ff_size=F, num_layers=L,
                       num_heads=4, dropout=0.0, arch="trans_dec",
                       diffusion_only=True, text_encoded_dim=TD,
                       pe_max_len=500, use_pallas=True)
    p = jden.init(jax.random.PRNGKey(0), jnp.asarray(sample), jnp.asarray(0),
                  jnp.asarray(text),
                  None if mask is None else jnp.asarray(mask))["params"]
    den = RawMotionDenoiser(NF, D, F, L, 4, TD, pe_max_len=500)
    den.load_state_dict(flax_to_state_dict(p))
    assert (den.emb_proj is None) == (TD == D)
    # t <= 41, where f32 pins the timestep sinusoid (ROADMAP.md, section 3)
    for t in (0, 7, 41):
        ref = jden.apply({"params": p}, jnp.asarray(sample), jnp.asarray(t),
                         jnp.asarray(text),
                         None if mask is None else jnp.asarray(mask))
        with torch.no_grad():
            out = den(torch.from_numpy(sample), t, torch.from_numpy(text),
                      None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
        if mask is not None:
            assert not out.numpy()[~mask].any()
    # a [B] tensor of timesteps gives what the host integer gives
    with torch.no_grad():
        a = den(torch.from_numpy(sample), 7, torch.from_numpy(text))
        b = den(torch.from_numpy(sample), torch.full((B,), 7),
                torch.from_numpy(text))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
