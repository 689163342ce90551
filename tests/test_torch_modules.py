"""Port modules vs their JAX counterparts, same numpy inputs and weights.

Each port module mirrors the JAX path it is held against, LayerNorm epsilon
included: the flax transformer modules use 1e-6, CLIP 1e-5. Tolerances: 2e-5
per layer and for the embeddings, 1e-4 for stacks and CLIP in f32, 1e-6 for
50-step DDIM trajectories, 1e-5 for joint recovery.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import presets as jax_presets
from mld_tpu.data.humanml.motion_process import (
    recover_from_ric as jax_recover_from_ric)
from mld_tpu.diffusion.schedulers import (DDIMScheduler as JaxDDIM,
                                          DiffusionSchedule as JaxSchedule)
from mld_tpu.models.clip_text import (ClipTextModel as JaxClip,
                                      ClipTokenizer as JaxTokenizer)
from mld_tpu.models.vae import MldVae as JaxVae
from mld_tpu.ops import embeddings as jemb
from mld_tpu.ops import quaternion as jquat
from mld_tpu.ops import transformer as jtr

from mld_tpu_torch.config import presets
from mld_tpu_torch.data.humanml.motion_process import recover_from_ric
from mld_tpu_torch.diffusion.schedulers import DDIMScheduler, DiffusionSchedule
from mld_tpu_torch.models.clip_text import ClipTextModel, ClipTokenizer
from mld_tpu_torch.models.vae import MldVae
from mld_tpu_torch.ops import embeddings as temb
from mld_tpu_torch.ops import quaternion as tquat
from mld_tpu_torch.ops import transformer as ttr
from mld_tpu_torch.utils.convert import (flax_clip_to_state_dict,
                                         flax_to_state_dict)


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def valid_mask(lengths, T):
    return np.arange(T)[None, :] < np.asarray(lengths)[:, None]


def load(module, flax_params):
    module.load_state_dict(flax_to_state_dict(flax_params))
    return module.eval()


# ----------------------------------------------------------------- embeddings
@pytest.mark.parametrize("dim,flip,shift", [(768, True, 0.0), (64, False, 1.0),
                                            (7, True, 0.0)])
def test_timestep_embedding(dim, flip, shift):
    # parity with JAX at 2e-5 where f32 pins the sinusoid that tightly
    # (t <= 41). At t=981 an f32 exp is free to one ulp of the frequency
    # (both XLA's and torch's CPU exp use that freedom, at different
    # entries), which moves the argument by up to t * 2^-23 = 1.2e-4 and the
    # two packages by 6.1e-5 (ROADMAP.md, section 3). There both are held to
    # the float64 value of the formula, within that bound plus 2e-5
    small, large = np.asarray([41, 1, 0]), np.asarray([981, 761])
    ref = jemb.get_timestep_embedding(jnp.asarray(small), dim, flip, shift)
    out = temb.get_timestep_embedding(torch.as_tensor(small), dim, flip,
                                      shift)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)

    half = dim // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half) / (half - shift))
    arg = large[:, None] * freq[None]
    exact = np.concatenate([np.sin(arg), np.cos(arg)], -1)
    if flip:
        exact = np.concatenate([exact[:, half:], exact[:, :half]], -1)
    exact = np.pad(exact, ((0, 0), (0, dim % 2)))
    bound = large.max() * 2.0 ** -23 + 2e-5
    out = temb.get_timestep_embedding(torch.as_tensor(large), dim, flip,
                                      shift)
    ref = jemb.get_timestep_embedding(jnp.asarray(large), dim, flip, shift)
    np.testing.assert_allclose(out.numpy(), exact, atol=bound, rtol=0)
    np.testing.assert_allclose(np.asarray(ref), exact, atol=bound, rtol=0)


def test_learned_pe_and_time_mlp():
    x = rand(2, 5, 32)
    pe = jemb.PositionEmbeddingLearned1D(32, max_len=40)
    p = pe.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    out = load(temb.PositionEmbeddingLearned1D(32, 40), p)(torch.from_numpy(x))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(pe.apply({"params": p}, x)))

    s = rand(4, 48, seed=1)
    te = jemb.TimestepEmbedding(32)
    p = te.init(jax.random.PRNGKey(1), jnp.asarray(s))["params"]
    out = load(temb.TimestepEmbedding(48, 32), p)(torch.from_numpy(s))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(te.apply({"params": p}, s)),
                               atol=2e-5)


# ------------------------------------------------------------------- layers
def test_multihead_attention_self_and_cross():
    D, H = 64, 4
    q, mem = rand(3, 7, D), rand(3, 2, D, seed=1)
    key_valid = valid_mask([7, 4, 1], 7)
    mha = jtr.MultiheadAttention(D, H)
    p = mha.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(q),
                 jnp.asarray(q))["params"]
    port = load(ttr.MultiheadAttention(D, H), p)
    qj = jnp.asarray(q)
    ref = mha.apply({"params": p}, qj, qj, qj, jnp.asarray(key_valid))
    qt = torch.from_numpy(q)
    with torch.no_grad():
        out = port(qt, qt, qt, torch.from_numpy(key_valid))
        cross = port(qt, torch.from_numpy(mem), torch.from_numpy(mem))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    ref = mha.apply({"params": p}, qj, jnp.asarray(mem), jnp.asarray(mem))
    np.testing.assert_allclose(cross.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_encoder_layer(activation):
    D, H, F = 64, 4, 128
    x = rand(3, 6, D)
    key_valid = valid_mask([6, 3, 5], 6)
    layer = jtr.TransformerEncoderLayer(D, H, F, dropout=0.0,
                                        activation=activation)
    p = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = layer.apply({"params": p}, jnp.asarray(x), jnp.asarray(key_valid))
    port = load(ttr.TransformerEncoderLayer(D, H, F, activation), p)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(key_valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_decoder_layer():
    D, H, F = 64, 4, 128
    tgt, mem = rand(3, 6, D), rand(3, 1, D, seed=1)
    tgt_valid = valid_mask([6, 2, 4], 6)
    layer = jtr.TransformerDecoderLayer(D, H, F, dropout=0.0)
    p = layer.init(jax.random.PRNGKey(0), jnp.asarray(tgt),
                   jnp.asarray(mem))["params"]
    ref = layer.apply({"params": p}, jnp.asarray(tgt), jnp.asarray(mem),
                      jnp.asarray(tgt_valid))
    port = load(ttr.TransformerDecoderLayer(D, H, F), p)
    with torch.no_grad():
        out = port(torch.from_numpy(tgt), torch.from_numpy(mem),
                   torch.from_numpy(tgt_valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_skip_encoder_module():
    D, H, F, L = 64, 4, 128, 5
    x = rand(2, 9, D)
    key_valid = valid_mask([9, 5], 9)
    stack = jtr.SkipTransformerEncoder(D, H, L, F, dropout=0.0)
    p = stack.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = stack.apply({"params": p}, jnp.asarray(x), jnp.asarray(key_valid))
    port = load(ttr.SkipTransformerEncoder(D, H, L, F), p)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(key_valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_skip_decoder_module():
    D, H, F, L = 64, 4, 128, 5
    tgt, mem = rand(2, 12, D), rand(2, 1, D, seed=1)
    tgt_valid = valid_mask([12, 7], 12)
    stack = jtr.SkipTransformerDecoder(D, H, L, F, dropout=0.0)
    p = stack.init(jax.random.PRNGKey(0), jnp.asarray(tgt),
                   jnp.asarray(mem))["params"]
    ref = stack.apply({"params": p}, jnp.asarray(tgt), jnp.asarray(mem),
                      jnp.asarray(tgt_valid))
    port = load(ttr.SkipTransformerDecoder(D, H, L, F), p)
    with torch.no_grad():
        out = port(torch.from_numpy(tgt), torch.from_numpy(mem),
                   torch.from_numpy(tgt_valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


# ----------------------------------------------------------------------- VAE
@pytest.fixture(scope="module")
def vae_pair():
    NF, D, F, L, T = 37, 64, 128, 3, 40
    feats = rand(3, T, NF)
    mask = valid_mask([40, 25, 9], T)
    vae = JaxVae(nfeats=NF, latent_dim=D, ff_size=F, num_layers=L,
                 num_heads=4, dropout=0.0)
    p = vae.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(feats),
                 jnp.asarray(mask))["params"]
    port = load(MldVae(NF, 1, D, F, L, 4), p)
    return vae, p, port, feats, mask


def test_vae_decode(vae_pair):
    vae, p, port, _, mask = vae_pair
    z = rand(3, 1, 64, seed=3)
    ref = vae.apply({"params": p}, jnp.asarray(z), jnp.asarray(mask),
                    method=vae.decode)
    with torch.no_grad():      # the module is differentiable (training)
        out = port.decode(torch.from_numpy(z), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    assert not out.numpy()[~mask].any()


def test_vae_encode_mean(vae_pair):
    vae, p, port, feats, mask = vae_pair
    ref_z, (ref_mu, ref_logvar) = vae.apply(
        {"params": p}, jnp.asarray(feats), jnp.asarray(mask),
        sample_mean=True, method=vae.encode)
    with torch.no_grad():      # the module is differentiable (training)
        z, (mu, logvar) = port.encode(torch.from_numpy(feats),
                                      torch.from_numpy(mask))
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(ref_logvar),
                               atol=1e-4)
    np.testing.assert_array_equal(z.numpy(), mu.numpy())


# ---------------------------------------------------------------------- CLIP
@pytest.fixture(scope="module")
def clip_pair():
    ours = JaxClip(vocab_size=1000, width=64, layers=2, heads=4,
                   projection_dim=64, intermediate_size=128)
    ids = np.random.RandomState(0).randint(1, 900, (3, 77))
    ids[:, 0] = 998
    for i, n in enumerate((5, 20, 77)):
        ids[i, n - 1] = 999
        ids[i, n:] = 999 if n < 77 else ids[i, n:]
    p = ours.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32))["params"]
    port = ClipTextModel(vocab_size=1000, width=64, layers=2, heads=4,
                         projection_dim=64, intermediate_size=128)
    port.load_state_dict(flax_clip_to_state_dict(p))
    return ours, p, port.eval(), ids


@pytest.mark.parametrize("mode", ["features", "pooled", "hidden"])
def test_clip_f32(clip_pair, mode):
    ours, p, port, ids = clip_pair
    ref = ours.apply({"params": p}, jnp.asarray(ids, jnp.int32), mode=mode)
    with torch.no_grad():
        out = port(torch.as_tensor(ids), mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_clip_bucketed_matches_full_context():
    """EOT-cropped ids give the same pooled output as 77-context ids
    (tests/test_clip_text.py:123, on the port)."""
    torch.manual_seed(0)
    port = ClipTextModel(vocab_size=1000, width=64, layers=2, heads=4,
                         projection_dim=64, intermediate_size=128).eval()
    rng = np.random.RandomState(1)
    full = np.full((3, 77), 999, np.int64)
    for i, n in enumerate((5, 12, 20)):
        full[i, 0] = 998
        full[i, 1:n - 1] = rng.randint(1, 900, n - 2)
    with torch.no_grad():
        for mode in ("pooled", "features"):
            out_full = port(torch.as_tensor(full), mode=mode)
            out_crop = port(torch.as_tensor(full[:, :24]), mode=mode)
            np.testing.assert_allclose(out_crop.numpy(), out_full.numpy(),
                                       rtol=0, atol=2e-6)


@pytest.mark.parametrize("buckets", [None, (16, 24, 32, 48, 64)])
def test_tokenizer_matches_jax(buckets):
    texts = ["a man kicks something with his left leg.",
             "someone raises both arms and stretches.", "", "word " * 60]
    for rows in (texts[:2], texts[:3], texts):
        np.testing.assert_array_equal(
            ClipTokenizer(None)(rows, buckets=buckets),
            JaxTokenizer(None)(rows, buckets=buckets))


def test_presets_equal_jax():
    assert presets.list_presets() == jax_presets.list_presets()
    for name in presets.list_presets():
        assert presets.get_preset(name) == jax_presets.get_preset(name)


# ---------------------------------------------------------------- schedulers
@pytest.mark.parametrize("prediction,clip_sample", [("epsilon", False),
                                                    ("sample", True)])
def test_ddim_trajectory(prediction, clip_sample):
    jsch = JaxDDIM(JaxSchedule.create(prediction_type=prediction,
                                      clip_sample=clip_sample), 50)
    tsch = DDIMScheduler(DiffusionSchedule.create(
        prediction_type=prediction, clip_sample=clip_sample), 50)
    ts = tsch.timesteps()
    np.testing.assert_array_equal(ts, jsch.timesteps())
    np.testing.assert_array_equal(tsch.schedule.alphas_cumprod,
                                  np.asarray(jsch.schedule.alphas_cumprod))
    x = rand(4, 1, 32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for i, t in enumerate(ts):
        eps = rand(4, 1, 32, seed=i + 1)
        xj = jsch.step(jnp.asarray(eps), jnp.asarray(t), xj)
        xt = tsch.step(torch.from_numpy(eps), int(t), xt)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6,
                               rtol=1e-6)


# ----------------------------------------------------------- joint recovery
def test_recover_from_ric():
    feats = rand(2, 30, 263) * 0.3
    ref = jax_recover_from_ric(jnp.asarray(feats), 22)
    out = recover_from_ric(torch.from_numpy(feats), 22)
    assert out.shape == (2, 30, 22, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_quaternions():
    q, r, v = rand(5, 4), rand(5, 4, seed=1), rand(5, 3, seed=2)
    np.testing.assert_allclose(tquat.qmul(torch.from_numpy(q),
                                          torch.from_numpy(r)).numpy(),
                               np.asarray(jquat.qmul(q, r)), atol=1e-6)
    np.testing.assert_allclose(tquat.qrot(torch.from_numpy(q[:, None]),
                                          torch.from_numpy(v)).numpy(),
                               np.asarray(jquat.qrot(q[:, None], v)),
                               atol=1e-5)
    np.testing.assert_array_equal(tquat.qinv(torch.from_numpy(q)).numpy(),
                                  np.asarray(jquat.qinv(q)))
