"""The port's action-to-motion generation vs the JAX package's, on the CPU.

Same numpy inputs (from seeds) and the same weights (flax-initialised,
carried by the port's bridges) on both sides. Bars: 1e-6 for rotations,
2e-5 f32 for a layer or module, 1e-4 for stacks and the VAE, and for
``generate_joints`` end to end the bar of ``tests/test_torch_generate.py``
(1e-3 x max(scale, 1)) next to a tighter 1e-4 x max(scale, 1); ints and
bytes exactly equal. The fused denoiser forward (K1's plain version) is held
against ``fused_denoiser_forward(..., interpret=True)`` with the action
condition at 15 and 9 layers (n_block 7 and 4).

Also here: the datasets and collator (items and batches of one synthetic
pkl, both presets), the weight bridges, ``global_norm`` against
``optax.global_norm`` on a 3M-element leaf (fault 3.4), and a child process
importing every module of the port with jax, flax, optax and mld_tpu made
unimportable.
"""
import inspect
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data import a2m as jax_a2m
from mld_tpu.data import collate as jax_collate
from mld_tpu.models import smpl as jax_smpl
from mld_tpu.models.actor_vae import ActorVae as JaxActorVae
from mld_tpu.models.denoiser import EmbedAction as JaxEmbedAction
from mld_tpu.models.denoiser import MldDenoiser as JaxDenoiser
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.mld import lengths_to_mask as jax_lengths_to_mask
from mld_tpu.ops import rotation as jrot
from mld_tpu.ops.embeddings import PositionEmbeddingSine1D as JaxSinePE
from mld_tpu.ops.fused_denoiser import (
    fused_denoiser_forward as jax_fused_denoiser_forward)
from mld_tpu.ops.fused_denoiser import precompute_cond as jax_precompute_cond
from mld_tpu.ops.transformer import TransformerEncoder as JaxEncoder
from mld_tpu.utils.torch_convert import torch_state_dict_to_flax

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data import a2m, collate
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.models import smpl
from mld_tpu_torch.models.actor_vae import ActorVae
from mld_tpu_torch.models.denoiser import EmbedAction, MldDenoiser
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.ops import rotation as trot
from mld_tpu_torch.ops.embeddings import PositionEmbeddingSine1D
from mld_tpu_torch.ops.fused_denoiser import (fused_denoiser_forward,
                                              precompute_cond)
from mld_tpu_torch.ops.transformer import TransformerEncoder
from mld_tpu_torch.train import steps
from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.convert import flax_to_state_dict

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROT_ATOL = 1e-6
LAYER_ATOL = 2e-5
STACK_ATOL = 1e-4
SMALL = {"model": {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
                   "denoiser_num_layers": 3, "num_heads": 4,
                   "scheduler": {"num_inference_timesteps": 5}}}
PRESETS = ("mld_humanact12", "mld_uestc")


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def valid_mask(lengths, T):
    return np.arange(T)[None] < np.asarray(lengths)[:, None]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def load(module, params):
    module.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    return module.eval()


# --------------------------------------------------------------- rotations
def _unit_quats(n, seed):
    q = rand(n, 4, seed=seed)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


ROTATIONS = [
    ("axis_angle_to_quaternion", lambda: rand(64, 3, seed=1)),
    ("quaternion_to_axis_angle", lambda: _unit_quats(64, 2)),
    ("axis_angle_to_matrix", lambda: rand(64, 3, seed=3)),
    ("matrix_to_rotation_6d", lambda: rand(64, 3, 3, seed=4)),
    ("rotation_6d_to_matrix", lambda: rand(64, 6, seed=5)),
    ("matrix_to_quaternion", lambda: np.asarray(jrot.axis_angle_to_matrix(
        jnp.asarray(rand(64, 3, seed=6, scale=1.5))))),
    ("axis_angle_to_rotation_6d", lambda: rand(4, 24, 3, seed=7)),
    ("rotation_6d_to_axis_angle", lambda: rand(64, 6, seed=8)),
]


@pytest.mark.parametrize("name,make", ROTATIONS, ids=[r[0] for r in ROTATIONS])
def test_rotation_matches_jax(name, make):
    x = make()
    ref = np.asarray(getattr(jrot, name)(jnp.asarray(x)))
    out = getattr(trot, name)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ROT_ATOL, rtol=0)


def test_small_angles_take_the_series():
    aa = np.array([[0.0, 0.0, 0.0], [1e-8, 0.0, -2e-8]], np.float32)
    np.testing.assert_allclose(
        trot.axis_angle_to_quaternion(torch.from_numpy(aa)).numpy(),
        np.asarray(jrot.axis_angle_to_quaternion(jnp.asarray(aa))),
        atol=ROT_ATOL, rtol=0)


# -------------------------------------------------------------------- SMPL
def test_fallback_skeleton_equals_jax():
    np.testing.assert_array_equal(smpl._APPROX_OFFSETS,
                                  jax_smpl._APPROX_OFFSETS)
    np.testing.assert_array_equal(smpl._APPROX_OFFSETS_ABS(),
                                  jax_smpl._APPROX_OFFSETS_ABS())
    assert smpl.SMPL_PARENTS == jax_smpl.SMPL_PARENTS


def test_fk_joints_match_jax():
    rot6d, trans = rand(5, 24, 6, seed=1), rand(5, 3, seed=2)
    ref = np.asarray(jax_smpl.SMPLLayer(None).joints(jnp.asarray(rot6d),
                                                     jnp.asarray(trans)))
    out = smpl.SMPLLayer(None).joints(torch.from_numpy(rot6d),
                                      torch.from_numpy(trans)).numpy()
    np.testing.assert_allclose(out, ref, atol=ROT_ATOL * 10, rtol=0)


def test_rotation2joints_matches_jax():
    T, lengths = 12, [12, 5, 1]
    feats = rand(3, T, 150, seed=3)
    mask = valid_mask(lengths, T)
    ref = np.asarray(jax_smpl.Rotation2Joints(None)(jnp.asarray(feats),
                                                    jnp.asarray(mask)))
    out = smpl.Rotation2Joints(None)(torch.from_numpy(feats),
                                     torch.from_numpy(mask)).numpy()
    assert out.shape == (3, T, 24, 3) and not out[~mask].any()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    no_trans = smpl.Rotation2Joints(None)(torch.from_numpy(feats),
                                          vertstrans=False).numpy()
    ref_nt = np.asarray(jax_smpl.Rotation2Joints(None)(jnp.asarray(feats),
                                                       vertstrans=False))
    np.testing.assert_allclose(no_trans, ref_nt, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def smpl_pickle(tmp_path_factory):
    """A SMPL-schema pickle with a small seeded body (V = 40 vertices)."""
    rng = np.random.RandomState(0)
    V, J = 40, 24
    reg = rng.rand(J, V)
    data = {"v_template": rng.randn(V, 3) * 0.3,
            "shapedirs": rng.randn(V, 3, 10) * 0.01,
            "J_regressor": reg / reg.sum(1, keepdims=True),
            "weights": rng.dirichlet(np.ones(J), V),
            "posedirs": rng.randn(V, 3, 207) * 0.01,
            "kintree_table": np.stack(
                [[4294967295] + jax_smpl.SMPL_PARENTS[1:], list(range(J))]),
            "f": rng.randint(0, V, (30, 3))}
    path = str(tmp_path_factory.mktemp("smpl") / "SMPL_NEUTRAL.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def test_smpl_load_and_vertices_match_jax(smpl_pickle):
    jl, tl = jax_smpl.SMPLLayer(smpl_pickle), smpl.SMPLLayer(smpl_pickle)
    assert tl.has_asset and jl.has_asset and tl.parents == jl.parents
    np.testing.assert_array_equal(tl.faces, jl.faces)
    np.testing.assert_allclose(tl.joints_rest, np.asarray(jl.joints_rest),
                               atol=1e-6, rtol=0)
    rot6d, trans = rand(3, 24, 6, seed=4), rand(3, 3, seed=5)
    betas = rand(3, 10, seed=6)
    ref = np.asarray(jl.vertices(jnp.asarray(rot6d), jnp.asarray(trans),
                                 jnp.asarray(betas)))
    out = tl.vertices(torch.from_numpy(rot6d), torch.from_numpy(trans),
                      torch.from_numpy(betas)).numpy()
    assert out.shape == (3, 40, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tl.joints(torch.from_numpy(rot6d)).numpy(),
        np.asarray(jl.joints(jnp.asarray(rot6d))), atol=1e-5, rtol=0)
    with pytest.raises(RuntimeError, match="SMPL asset"):
        smpl.SMPLLayer(None).vertices(torch.from_numpy(rot6d))


# ------------------------------------------------ PE, encoder, ACTOR VAE
def test_sine_position_embedding_matches_jax():
    x = rand(2, 62, 32, seed=1)
    pe = JaxSinePE(32, max_len=5000)
    ref = np.asarray(pe.apply({}, jnp.asarray(x)))
    port = PositionEmbeddingSine1D(32, 5000, dropout=0.1)
    # no generator: no dropout (the serving forward)
    np.testing.assert_array_equal(port(torch.from_numpy(x)).numpy(), ref)
    g = torch.Generator().manual_seed(0)
    dropped = port(torch.from_numpy(x), g).numpy()
    kept = dropped != 0
    np.testing.assert_allclose(dropped[kept], ref[kept] / 0.9, rtol=1e-6)
    assert 0.8 < kept.mean() < 0.98


def test_transformer_encoder_matches_jax():
    x, mask = rand(3, 14, 32, seed=2), valid_mask([14, 9, 2], 14)
    enc = JaxEncoder(32, 4, 2, 64, dropout=0.0)
    p = enc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                 jnp.asarray(mask))["params"]
    ref = np.asarray(enc.apply({"params": p}, jnp.asarray(x),
                               jnp.asarray(mask)))
    port = load(TransformerEncoder(32, 4, 2, 64), p)
    assert port.norm is None
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=LAYER_ATOL, rtol=0)


@pytest.fixture(scope="module")
def actor_pair():
    NF, D, T = 150, 32, 20
    feats = rand(3, T, NF, seed=3)
    mask = valid_mask([20, 13, 4], T)
    feats = feats * mask[..., None]
    vae = JaxActorVae(nfeats=NF, latent_dim=D, ff_size=64, num_layers=3,
                      num_heads=4, dropout=0.0)
    p = vae.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(feats),
                 jnp.asarray(mask))["params"]
    port = load(ActorVae(NF, 1, D, 64, 3, 4), p)
    return vae, p, port, feats, mask


def test_actor_vae_encode_matches_jax(actor_pair):
    vae, p, port, feats, mask = actor_pair
    (mu, logvar) = vae.apply({"params": p}, jnp.asarray(feats),
                             jnp.asarray(mask), method=vae.encode_dist)
    eps = rand(3, 1, 32, seed=9)
    with torch.no_grad():
        z, (tmu, tlogvar) = port.encode(torch.from_numpy(feats),
                                        torch.from_numpy(mask),
                                        eps=torch.from_numpy(eps))
        zmean, _ = port.encode(torch.from_numpy(feats),
                               torch.from_numpy(mask), sample_mean=True)
    assert tmu.shape == (3, 1, 32)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu),
                               atol=STACK_ATOL, rtol=0)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar),
                               atol=STACK_ATOL, rtol=0)
    ref_z = np.asarray(mu) + eps * np.exp(0.5 * np.asarray(logvar))
    np.testing.assert_allclose(z.numpy(), ref_z, atol=STACK_ATOL, rtol=0)
    np.testing.assert_array_equal(zmean.numpy(), tmu.numpy())


def test_actor_vae_decode_matches_jax(actor_pair):
    vae, p, port, _, mask = actor_pair
    z = rand(3, 1, 32, seed=4)
    ref = np.asarray(vae.apply({"params": p}, jnp.asarray(z),
                               jnp.asarray(mask), method=vae.decode))
    with torch.no_grad():
        out = port.decode(torch.from_numpy(z), torch.from_numpy(mask)).numpy()
    assert out.shape == (3, 20, 150) and not out[~mask].any()
    np.testing.assert_allclose(out, ref, atol=STACK_ATOL, rtol=0)


def test_actor_vae_names_are_the_references(actor_pair):
    _, p, port, _, _ = actor_pair
    names = set(port.state_dict())
    for name in ("encoder.skel_embedding.weight", "encoder.mu_token",
                 "encoder.logvar_token",
                 "encoder.seqTransEncoder.layers.0.self_attn.in_proj_weight",
                 "decoder.seqTransDecoder.layers.2.multihead_attn."
                 "out_proj.weight", "decoder.final_layer.bias"):
        assert name in names, name
    # the torch names convert back to JAX's tree, leaf for leaf
    back = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in port.state_dict().items()})
    def flat(t):
        leaves = jax.tree_util.tree_flatten_with_path(t)[0]
        return {"/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in leaves}

    ref, got = flat(p), flat(back)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


# ----------------------------------------------------- the action denoiser
@pytest.mark.parametrize("guidance", [7.5, 1.0])
def test_embed_action_eval_matches_jax(guidance):
    ids = np.array([3, 0, 5, 11, 3, 7])
    emb = JaxEmbedAction(12, 16, guidance_scale=guidance)
    p = emb.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    ref = np.asarray(emb.apply({"params": p}, jnp.asarray(ids)))
    port = EmbedAction(12, 16, guidance)
    port.load_state_dict(flax_to_state_dict(_np(p)), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(ids)).numpy()
    assert out.shape == (6, 1, 16)
    np.testing.assert_array_equal(out, ref)
    assert (not out[:3].any()) == (guidance > 1)


def test_embed_action_training_drop():
    ids = np.arange(32) % 12
    emb = JaxEmbedAction(12, 16, guidance_uncondp=0.25)
    p = emb.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    key = jax.random.PRNGKey(5)
    ref = np.asarray(emb.apply({"params": p}, jnp.asarray(ids),
                               training=True, rng=key))
    keep = np.asarray(jax.random.bernoulli(key, 0.75, (32, 1)))[:, 0]
    port = EmbedAction(12, 16, guidance_uncondp=0.25)
    port.load_state_dict(flax_to_state_dict(_np(p)), strict=True)
    with torch.no_grad():
        replay = port(torch.from_numpy(ids), training=True,
                      keep=torch.from_numpy(keep)).numpy()
        drawn = port(torch.from_numpy(ids), training=True,
                     generator=torch.Generator().manual_seed(1)).numpy()
        again = port(torch.from_numpy(ids), training=True,
                     generator=torch.Generator().manual_seed(1)).numpy()
        none = port(torch.from_numpy(ids), training=True).numpy()
    np.testing.assert_array_equal(replay, ref)
    np.testing.assert_array_equal(drawn, again)
    dropped = ~drawn.any(-1)[:, 0]
    assert 0 < dropped.sum() < 32
    table = port.action_embedding.detach().numpy()
    np.testing.assert_array_equal(drawn[~dropped, 0], table[ids[~dropped]])
    np.testing.assert_array_equal(none[:, 0], table[ids])


def _action_denoiser_pair(D, layers, nclasses=12, seed=0):
    rng = np.random.RandomState(seed)
    B = 8
    sample = rng.randn(B, 1, D).astype(np.float32)
    ids = np.concatenate([np.zeros(B // 2, np.int64),
                          rng.randint(0, nclasses, B // 2)])
    jden = JaxDenoiser(nfeats=150, condition="action", latent_size=1,
                       latent_dim=D, ff_size=4 * D, num_layers=layers,
                       num_heads=4, dropout=0.1, arch="trans_enc",
                       skip_connect=True, nclasses=nclasses)
    params = jden.init({"params": jax.random.PRNGKey(seed)},
                       jnp.asarray(sample), jnp.asarray(0),
                       jnp.asarray(ids, jnp.int32))["params"]
    den = MldDenoiser(1, D, 4 * D, layers, 4, condition="action",
                      nclasses=nclasses)
    den.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    return sample, ids, jden, params, den


@pytest.mark.parametrize("layers", [3, 5])
def test_action_denoiser_module_path_matches_jax(layers):
    sample, ids, jden, params, den = _action_denoiser_pair(32, layers)
    for t in (41, 3):
        ref = np.asarray(jden.apply({"params": params}, jnp.asarray(sample),
                                    jnp.asarray(t), jnp.asarray(ids)))
        with torch.no_grad():
            out = den(torch.from_numpy(sample), t,
                      torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(out, ref, atol=STACK_ATOL, rtol=0)


def test_action_time_sinusoid_is_latent_wide():
    _, _, _, params, den = _action_denoiser_pair(32, 3)
    assert den.time_proj_dim == 32 and den.text_encoded_dim == 768
    assert den.time_embedding.linear_1.in_features == 32
    assert np.asarray(params["time_embedding"]["linear_1"]["kernel"]).shape \
        == (32, 32)


@pytest.mark.parametrize("layers", [15, 9])   # n_block 7 and 4
def test_fused_action_denoiser_matches_jax(layers):
    D = 64
    sample, ids, _, params, den = _action_denoiser_pair(D, layers)
    ref = jax_fused_denoiser_forward(
        params, jnp.asarray(sample), jnp.asarray(41),
        jnp.asarray(ids, jnp.int32), num_heads=4, num_layers=layers,
        latent_dim=D, text_encoded_dim=768, condition="action",
        interpret=True)
    out = fused_denoiser_forward(den, torch.from_numpy(sample), 41,
                                 torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LAYER_ATOL,
                               rtol=0)
    # the hoisted preamble: time table and the condition (first half zero)
    timesteps = np.array([981, 41, 3])
    jtab, jcond = jax_precompute_cond(
        params, jnp.asarray(timesteps), jnp.asarray(ids, jnp.int32),
        latent_dim=D, text_encoded_dim=768, condition="action")
    tab, cond = precompute_cond(den, torch.from_numpy(timesteps),
                                torch.from_numpy(ids))
    np.testing.assert_allclose(tab.numpy(), np.asarray(jtab), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(cond.numpy(), np.asarray(jcond))
    assert not cond[:4].any()
    hoisted = fused_denoiser_forward(den, torch.from_numpy(sample), 41,
                                     None, time_emb=tab[1], cond_lat=cond)
    ref_h = jax_fused_denoiser_forward(
        params, jnp.asarray(sample), jnp.asarray(41), None, num_heads=4,
        num_layers=layers, latent_dim=D, text_encoded_dim=768,
        condition="action", interpret=True, time_emb=jtab[1],
        cond_lat=jcond)
    np.testing.assert_allclose(hoisted.numpy(), np.asarray(ref_h),
                               atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(hoisted.numpy(), out.numpy(), atol=1e-5,
                               rtol=0)


# --------------------------------------------------------- end to end
@pytest.fixture(scope="module", params=PRESETS)
def model_pair(request):
    preset = request.param
    jmld = JaxMLD(jax_load_config(preset=preset, overrides=SMALL))
    params = jmld.init_params(jax.random.PRNGKey(0))
    assert "clip" not in params
    tmld = MLD(load_config(preset=preset, overrides=SMALL), device="cpu")
    tmld.load_flax_params(_np(params))
    return preset, jmld, params, tmld


@pytest.mark.parametrize("fused", ["0", "1"])
def test_generate_joints_matches_jax(model_pair, fused, monkeypatch):
    preset, _, params, tmld = model_pair
    monkeypatch.setenv("MLD_TPU_FUSED_DENOISER", fused)
    # a fresh JAX instance: its jitted generate reads the switch when traced
    jmld = JaxMLD(jax_load_config(preset=preset, overrides=SMALL))
    assert jmld._use_fused_denoiser() == (fused == "1")
    tmld.fused_denoiser = fused == "1"
    actions = np.array([0, 5, 11, 3])
    T = tmld.cfg.dataset.num_frames
    lengths = [60, 41, 17, 60]
    mask = jax_lengths_to_mask(jnp.asarray(lengths), T)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jmld.generate_joints(params, jnp.asarray(actions),
                                          mask, key))
    _, init_rng = jax.random.split(key)
    init = np.asarray(jmld._init_latents(init_rng, len(actions), mask))
    before = trace.total("launch.k1")
    out = tmld.generate_joints(torch.from_numpy(actions),
                               lengths_to_mask(lengths, T, "cpu"),
                               init_latents=torch.from_numpy(init)).numpy()
    assert trace.total("launch.k1") == before   # CPU tensors: plain versions
    assert out.shape == ref.shape == (4, T, 24, 3)
    # padded frames: zero in the port; NaN in JAX (zero rot6d times the
    # mask), a recorded divergence
    valid = np.asarray(mask)
    assert np.isnan(ref[~valid]).any() and not out[~valid].any()
    scale = max(np.abs(ref[valid]).max(), 1.0)
    err = np.abs(out[valid] - ref[valid]).max()
    assert err <= 1e-4 * scale, (preset, err, scale)
    tmld.fused_denoiser = None


def test_generate_action_lists_motions(model_pair):
    preset, jmld, params, tmld = model_pair
    motions = tmld.generate_action([1, 2, 7], lengths=[60, 80, 9],
                                   generator=torch.Generator().manual_seed(0))
    assert [m.shape for m in motions] == [(60, 24, 3), (60, 24, 3),
                                          (9, 24, 3)]
    assert all(np.isfinite(m).all() for m in motions)
    ref = jmld.generate_action(params, [1, 2, 7], jax.random.PRNGKey(0),
                               lengths=[60, 80, 9])
    assert [m.shape for m in ref] == [m.shape for m in motions]


def test_action_model_has_no_text_tower(model_pair):
    _, _, _, tmld = model_pair
    assert tmld.clip is None and tmld.tokenizer is None
    assert not any(k.startswith("clip.") for k in tmld.state_dict())
    assert "denoiser.emb_proj.action_embedding" in tmld.state_dict()
    assert tmld.use_fused_denoiser() is False   # "auto" on the CPU


@pytest.mark.parametrize("preset", PRESETS)
def test_full_width_presets_build(preset):
    m = MLD(load_config(preset=preset), device="cpu")
    n_layers = {"mld_humanact12": 15, "mld_uestc": 9}[preset]
    assert 2 * len(m.denoiser.encoder.input_blocks) + 1 == n_layers
    assert len(m.vae.encoder.seqTransEncoder.layers) == 9
    assert m.denoiser.stacked_encoder().wqkv.shape == (n_layers, 256, 768)


def test_stages_of_the_vae_are_jaxs(model_pair):
    """recon_from_motion with JAX's eps replayed."""
    preset, jmld, params, tmld = model_pair
    T = tmld.cfg.dataset.num_frames
    feats = rand(3, T, 150, seed=11, scale=0.5)
    lengths = [60, 33, 8]
    mask = valid_mask(lengths, T)
    key = jax.random.PRNGKey(4)
    j_rst, j_ref = (np.asarray(a) for a in jmld.recon_from_motion(
        params, jnp.asarray(feats), jnp.asarray(mask), key))
    eps = np.asarray(jax.random.normal(key, (3, 1, 32)))
    t_rst, t_ref = (a.numpy() for a in tmld.recon_from_motion(
        torch.from_numpy(feats), torch.from_numpy(mask),
        eps=torch.from_numpy(eps)))
    assert not t_rst[~mask].any() and not t_ref[~mask].any()
    scale = max(np.abs(j_rst[mask]).max(), 1.0)
    np.testing.assert_allclose(t_ref[mask], j_ref[mask], atol=1e-5 * scale,
                               rtol=0)
    np.testing.assert_allclose(t_rst[mask], j_rst[mask], atol=1e-4 * scale,
                               rtol=0)


# ------------------------------------------------------------------- data
def test_synthetic_pkl_is_the_same_bytes(tmp_path):
    a = a2m.synth_humanact12_pkl(str(tmp_path / "p" / "humanact12poses.pkl"),
                                 n_per_class=3, seed=2, num_classes=5)
    b = jax_a2m.synth_humanact12_pkl(
        str(tmp_path / "j" / "humanact12poses.pkl"), n_per_class=3, seed=2,
        num_classes=5)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert (inspect.getsource(a2m.synth_humanact12_pkl)
            == inspect.getsource(jax_a2m.synth_humanact12_pkl))


def test_a2m_collator_is_a_carried_copy():
    assert (inspect.getsource(collate.A2MCollator)
            == inspect.getsource(jax_collate.A2MCollator))


@pytest.mark.parametrize("preset", PRESETS)
def test_datasets_and_batches_match_jax(preset, tmp_path):
    """Both packages over one synthetic pkl, each in its own root (the UESTC
    dataset copies its pkl within its root): the splits, the items (crops
    from each dataset's RandomState(1234)) and the collated batches."""
    roots = []
    for side in ("port", "jax"):
        root = tmp_path / side
        # few clips: the JAX reader computes each clip's rot6d eagerly, one
        # compile per clip length
        if preset == "mld_uestc":
            jax_a2m.synth_humanact12_pkl(str(root / "humanact12poses.pkl"),
                                         n_per_class=3, num_classes=10)
            os.rename(root / "humanact12poses.pkl", root / "uestc_poses.pkl")
        else:
            jax_a2m.synth_humanact12_pkl(str(root / "humanact12poses.pkl"),
                                         n_per_class=2)
        roots.append(str(root))
    over = {"dataset": {"root": roots[0]}, "eval": {"batch_size": 2},
            "train": {"batch_size": 6}}
    dm = get_datamodule(load_config(preset=preset, overrides=over))
    jdm = jax_a2m.get_a2m_datamodule(jax_load_config(preset=preset, overrides={
        **over, "dataset": {"root": roots[1]}}))
    for split in ("train", "test"):
        ds, jds = dm.dataset(split), jdm.dataset(split)
        np.testing.assert_array_equal(ds.indices, jds.indices)
        assert ds.num_classes == jds.num_classes
        for i in range(len(ds)):
            it, jit = ds[i], jds[i]
            np.testing.assert_allclose(it["motion"], jit["motion"],
                                       atol=ROT_ATOL, rtol=0)
            for k in ("action", "action_text", "length"):
                assert it[k] == jit[k], k
    for split, kw in (("train", {"seed": 3}), ("test", {"shuffle": False})):
        port_b = list(dm.loader(split, **kw))
        jax_b = list(jdm.loader(split, **kw))
        assert len(port_b) == len(jax_b) > 1
        for b, jb in zip(port_b, jax_b):
            assert b.keys() == jb.keys()
            np.testing.assert_allclose(b["motion"], jb["motion"],
                                       atol=ROT_ATOL, rtol=0)
            for k in ("length", "mask", "action"):
                np.testing.assert_array_equal(b[k], jb[k])
            assert b["action_text"] == jb["action_text"]
            # every clip is cropped or padded to num_frames (a recorded
            # divergence from the item's own length, as in the JAX package)
            assert (b["length"] == 60).all()


# --------------------------------------------------- training entry points
def test_global_norm_matches_optax():
    """Fault 3.4: the norm accumulates in f64 and holds optax's within 1e-6
    relative on a tree with a 3M-element leaf."""
    rng = np.random.RandomState(0)
    tree = {"big": (rng.randn(3_000_000) * 1e-3 + 2e-3).astype(np.float32),
            "w": rng.randn(256, 768).astype(np.float32),
            "b": rng.randn(768).astype(np.float32) * 10}
    ref = float(optax.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    out = steps.global_norm([torch.from_numpy(v) for v in tree.values()])
    assert out.dtype == torch.float32
    assert abs(out.item() - ref) <= 1e-6 * ref, (out.item(), ref)
    exact = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                        for v in tree.values()))
    assert abs(out.item() - exact) <= 1e-7 * exact


# --------------------------------------------------------- the port's imports
def test_every_port_module_imports_without_jax():
    """Every module of mld_tpu_torch, and chip_smoke, imported in a process
    where importing jax, flax, optax or mld_tpu raises."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'mld_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import mld_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    mld_tpu_torch.__path__, 'mld_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(names)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    for new in ("ops.rotation", "models.smpl", "models.actor_vae",
                "models.humanact12_gru", "models.uestc_stgcn", "data.a2m",
                "metrics.gru", "metrics.stgcn", "eval.a2m_train",
                "eval.__main__", "utils.precision"):
        assert f"mld_tpu_torch.{new}" in names, new
