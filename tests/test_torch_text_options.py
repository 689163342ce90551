"""The text family's model options in the port vs the JAX package.

Each module that changes with an option is held to its JAX counterpart on
the same seeded inputs and the same weights (JAX's init, bridged by
``flax_to_state_dict``): pre-norm layers and stacks at 2e-5, the per-layer
bar of tests/test_transformer_parity.py; every denoiser structure (arch x
skip_connect x diffusion_only, with sine PE, pre-norm, text_uncond and 77
condition tokens) at 2e-5 for t <= 41 (ROADMAP.md section 3); the MLD VAE's
all_encoder / mlp_dist / pre-norm / sine options at 1e-4, the decoder
stack's bar (tests/test_fused_seq_decoder.py); VPosert with non-default
running statistics at 1e-5; the CLIP tower's hidden mode at 1e-5.

End to end, ``generate_feats`` and the joints of each configuration
``chip_smoke.py`` phase 10 serves, plus DDPM on latents, are held to JAX's
``generate_feats`` / ``generate_joints`` on its module path (the CPU
default) at the bar of tests/test_torch_generate.py, 1e-3 x max(scale, 1),
from JAX's initial latents and step noise, replayed. Tiny widths: latent
32, ff 64, 3 layers, 2 heads, CLIP 2 layers of 48 in f32, a 2-step DDIM
schedule (4 train steps for DDPM), T = 32.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.clip_text import ClipTextModel as JaxClip
from mld_tpu.models.denoiser import MldDenoiser as JaxDenoiser
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.mld import lengths_to_mask as jax_lengths_to_mask
from mld_tpu.models.vae import MldVae as JaxVae
from mld_tpu.models.vposert_vae import VPosert as JaxVPosert
from mld_tpu.ops import transformer as jtf

from mld_tpu_torch.config import load_config
from mld_tpu_torch.config.core import merge_dicts
from mld_tpu_torch.eval.pipeline import Evaluator
from mld_tpu_torch.models.clip_text import ClipTextModel
from mld_tpu_torch.models.denoiser import MldDenoiser, RawMotionDenoiser
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.models.vae import MldVae
from mld_tpu_torch.models.vposert_vae import VPosert
from mld_tpu_torch.ops import transformer as ttf
from mld_tpu_torch.ops.embeddings import (PositionEmbeddingSine1D,
                                          build_position_encoding)
from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.convert import (flax_clip_to_state_dict,
                                         flax_to_state_dict)

LAYER_ATOL = 2e-5
VAE_ATOL = 1e-4
VPOSERT_ATOL = 1e-5
CLIP_ATOL = 1e-5
E2E_RTOL = 1e-3
TINY = {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
        "denoiser_num_layers": 3, "num_heads": 2, "text_encoded_dim": 48,
        "clip_layers": 2, "clip_heads": 2, "clip_compute_dtype": "float32",
        "scheduler": {"num_inference_timesteps": 2}}
T = 32
TEXTS = ["a man kicks something with his left leg.", "someone jumps"]
LENGTHS = [32, 19]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: intra-op threads only add overhead, much more of it when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _launches():
    return (trace.total("launch.k3"), trace.total("launch.k4"),
            trace.total("launch.k1"), trace.total("launch.k5"))


# ------------------------------------------------------------- pre-norm
def _layer_case(kind, D=32, H=2, F=64, B=3, S=7, Sm=4):
    rng = np.random.RandomState(3)
    x = rng.randn(B, S, D).astype(np.float32)
    mem = rng.randn(B, Sm, D).astype(np.float32)
    valid = np.arange(S)[None] < np.array([[S], [4], [1]])
    mvalid = np.arange(Sm)[None] < np.array([[Sm], [2], [Sm]])
    kw = dict(dropout=0.0, normalize_before=True)
    if kind == "encoder layer":
        jm = jtf.TransformerEncoderLayer(D, H, F, **kw)
        port = ttf.TransformerEncoderLayer(D, H, F, normalize_before=True)
        args = (x, valid)
    elif kind == "decoder layer":
        jm = jtf.TransformerDecoderLayer(D, H, F, **kw)
        port = ttf.TransformerDecoderLayer(D, H, F, normalize_before=True)
        args = (x, mem, valid, mvalid)
    elif kind == "skip encoder":
        jm = jtf.SkipTransformerEncoder(D, H, 5, F, **kw)
        port = ttf.SkipTransformerEncoder(D, H, 5, F, normalize_before=True)
        args = (x, valid)
    elif kind == "skip decoder":
        jm = jtf.SkipTransformerDecoder(D, H, 3, F, **kw)
        port = ttf.SkipTransformerDecoder(D, H, 3, F, normalize_before=True)
        args = (x, mem, valid, mvalid)
    elif kind == "plain encoder":
        jm = jtf.TransformerEncoder(D, H, 3, F, **kw)
        port = ttf.TransformerEncoder(D, H, 3, F, normalize_before=True)
        args = (x, valid)
    else:  # plain decoder, final norm
        jm = jtf.TransformerDecoder(D, H, 3, F, **kw)
        port = ttf.TransformerDecoder(D, H, 3, F, normalize_before=True)
        args = (x, mem, valid, mvalid)
    return jm, port, args


@pytest.mark.parametrize("kind", ["encoder layer", "decoder layer",
                                  "skip encoder", "skip decoder",
                                  "plain encoder", "plain decoder"])
def test_prenorm_matches_jax(kind):
    jm, port, args = _layer_case(kind)
    jargs = [jnp.asarray(a) for a in args]
    params = jm.init(jax.random.PRNGKey(1), *jargs)["params"]
    port.load_state_dict(flax_to_state_dict(_np(params)), strict=True)
    ref = np.asarray(jm.apply({"params": params}, *jargs))
    with torch.no_grad():
        out = port(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(out, ref, atol=LAYER_ATOL, rtol=0)
    # and it is not the post-norm forward
    post = type(port)(*_post_args(kind))
    post.load_state_dict(port.state_dict())
    with torch.no_grad():
        assert np.abs(post(*[torch.from_numpy(a) for a in args]).numpy()
                      - ref).max() > 1e-2


def _post_args(kind):
    D, H, F = 32, 2, 64
    return {"encoder layer": (D, H, F), "decoder layer": (D, H, F),
            "skip encoder": (D, H, 5, F), "skip decoder": (D, H, 3, F),
            "plain encoder": (D, H, 3, F), "plain decoder": (D, H, 3, F)}[kind]


# --------------------------------------------------- position encodings
@pytest.mark.parametrize("kind", ["v3", "learned", "v2", "sine", "actor"])
def test_position_encoding_kinds(kind):
    from mld_tpu.ops.embeddings import build_position_encoding as jax_build

    x = np.random.RandomState(0).randn(2, 9, 16).astype(np.float32)
    jm = jax_build(16, kind, max_len=40)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pe = build_position_encoding(16, kind, 40)
    if "params" in variables:
        pe.load_state_dict(flax_to_state_dict(_np(variables["params"])),
                           strict=True)
    else:
        assert isinstance(pe, PositionEmbeddingSine1D)
        assert not list(pe.parameters())
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(pe(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="not supported"):
        build_position_encoding(16, "rope")


# ----------------------------------------------------------- denoisers
DENOISERS = {
    # id: (JAX MldDenoiser fields, condition tokens)
    "enc skip latent": (dict(), 1),
    "enc plain latent": (dict(skip_connect=False), 1),
    "enc skip raw": (dict(diffusion_only=True), 1),
    "enc plain raw": (dict(skip_connect=False, diffusion_only=True), 1),
    "dec latent": (dict(arch="trans_dec"), 1),
    "dec raw": (dict(arch="trans_dec", diffusion_only=True), 1),
    "enc plain latent prenorm sine": (
        dict(skip_connect=False, normalize_before=True,
             position_embedding="sine"), 1),
    "dec latent prenorm v2": (
        dict(arch="trans_dec", normalize_before=True,
             position_embedding="v2"), 1),
    "enc skip raw actor-pe": (
        dict(diffusion_only=True, position_embedding="actor"), 1),
    "enc skip latent hidden text_uncond": (
        dict(condition="text_uncond"), 77),
    "enc skip latent size 7": (dict(latent_size=7), 1),
}


@pytest.mark.parametrize("case", list(DENOISERS))
def test_denoiser_structures_match_jax(case):
    fields, n_cond = DENOISERS[case]
    NF, D, TD, B, Tr = 20, 32, 48, 4, 11
    raw = fields.get("diffusion_only", False)
    L = fields.get("latent_size", 1)
    rng = np.random.RandomState(5)
    sample = rng.randn(B, Tr if raw else L, NF if raw else D).astype(
        np.float32)
    cond = rng.randn(B, n_cond, TD).astype(np.float32)
    mask = (np.arange(Tr)[None] < np.array([[Tr], [6], [1], [Tr]])
            if raw else None)
    jden = JaxDenoiser(nfeats=NF, latent_dim=D, ff_size=64, num_layers=3,
                       num_heads=2, dropout=0.0, text_encoded_dim=TD,
                       pe_max_len=100, **fields)
    p = jden.init(jax.random.PRNGKey(0), jnp.asarray(sample), jnp.asarray(0),
                  jnp.asarray(cond),
                  None if mask is None else jnp.asarray(mask))["params"]
    kw = dict(arch=fields.get("arch", "trans_enc"),
              skip_connect=fields.get("skip_connect", True),
              position_embedding=fields.get("position_embedding", "learned"),
              normalize_before=fields.get("normalize_before", False),
              condition=fields.get("condition", "text"))
    if raw:
        den = RawMotionDenoiser(NF, D, 64, 3, 2, TD, pe_max_len=100, **kw)
    else:
        den = MldDenoiser(L, D, 64, 3, 2, TD, pe_max_len=100,
                          cond_tokens=n_cond, **kw)
    den.load_state_dict(flax_to_state_dict(_np(p)), strict=True)
    # K1 serves only the post-norm skip trans_enc in latent mode, <= 8 tokens
    assert den.fusable == (case == "enc skip latent")
    assert (den._stacked is not None) == den.fusable
    for t in (0, 7, 41):
        ref = np.asarray(jden.apply(
            {"params": p}, jnp.asarray(sample), jnp.asarray(t),
            jnp.asarray(cond), None if mask is None else jnp.asarray(mask)))
        with torch.no_grad():
            out = den(torch.from_numpy(sample), t, torch.from_numpy(cond),
                      None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(out.numpy(), ref, atol=LAYER_ATOL, rtol=0)
        if mask is not None:
            assert not out.numpy()[~mask].any()
    if not den.fusable:
        with pytest.raises(ValueError, match="K1 cannot serve"):
            den.fused_forward(torch.from_numpy(sample), 7,
                              torch.from_numpy(cond))


# ---------------------------------------------------------------- VAEs
VAES = {
    "all_encoder": dict(arch="all_encoder"),
    "mlp_dist": dict(mlp_dist=True),
    "all_encoder mlp_dist prenorm sine": dict(
        arch="all_encoder", mlp_dist=True, normalize_before=True,
        position_embedding="sine"),
    "latent 2 mlp_dist prenorm v2": dict(
        latent_size=2, mlp_dist=True, normalize_before=True,
        position_embedding="v2"),
}


@pytest.mark.parametrize("case", list(VAES))
def test_vae_options_match_jax(case):
    fields = VAES[case]
    NF, D, B = 20, 32, 3
    L = fields.get("latent_size", 1)
    rng = np.random.RandomState(2)
    feats = rng.randn(B, T, NF).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[T], [17], [5]])
    jvae = JaxVae(nfeats=NF, latent_dim=D, ff_size=64, num_layers=3,
                  num_heads=2, dropout=0.0, **fields)
    p = jvae.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                  jnp.asarray(mask))["params"]
    vae = MldVae(NF, L, D, 64, 3, 2, arch=fields.get("arch",
                                                      "encoder_decoder"),
                 normalize_before=fields.get("normalize_before", False),
                 position_embedding=fields.get("position_embedding",
                                               "learned"),
                 mlp_dist=fields.get("mlp_dist", False))
    vae.load_state_dict(flax_to_state_dict(_np(p)), strict=True)
    key = jax.random.PRNGKey(4)
    jz, (jmu, jlogvar) = jvae.apply({"params": p}, jnp.asarray(feats),
                                    jnp.asarray(mask), key,
                                    method=jvae.encode)
    eps = np.asarray(jax.random.normal(key, jmu.shape))
    with torch.no_grad():
        z, (mu, logvar) = vae.encode(torch.from_numpy(feats),
                                     torch.from_numpy(mask),
                                     eps=torch.from_numpy(eps))
    for a, b in ((z, jz), (mu, jmu), (logvar, jlogvar)):
        assert a.shape == (B, L, D)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=VAE_ATOL,
                                   rtol=0)
    ref = np.asarray(jvae.apply({"params": p}, jz, jnp.asarray(mask),
                                method=jvae.decode))
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(np.asarray(jz)),
                         torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=VAE_ATOL, rtol=0)
    assert not out[~mask].any()


def test_vposert_matches_jax_with_running_stats():
    NF, MF, LD, NN, B = 12, 10, 8, 16, 3
    rng = np.random.RandomState(7)
    feats = rng.randn(B, MF, NF).astype(np.float32)
    mask = np.arange(8)[None] < np.array([[8], [5], [2]])
    jv = JaxVPosert(nfeats=NF, max_frames=MF, latent_dim=LD, num_neurons=NN)
    variables = jv.init(jax.random.PRNGKey(0), jnp.asarray(feats))
    params = _np(variables["params"])
    # non-default running statistics: the encoder must read them
    stats = {name: {"mean": 0.3 * rng.randn(*s["mean"].shape).astype(
                        np.float32),
                    "var": (0.5 + rng.rand(*s["var"].shape)).astype(
                        np.float32)}
             for name, s in _np(variables["batch_stats"]).items()}
    v = VPosert(NF, MF, 1, LD, NN)
    v.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    key = jax.random.PRNGKey(3)
    jz, (jmu, jlogvar) = jv.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(feats), None,
        key, method=jv.encode)
    eps = np.asarray(jax.random.normal(key, jmu.shape))
    for train in (False, True):        # BatchNorm never takes batch stats
        v.train(train)
        with torch.no_grad():
            z, (mu, logvar) = v.encode(torch.from_numpy(feats),
                                       eps=torch.from_numpy(eps))
        for a, b in ((z, jz), (mu, jmu), (logvar, jlogvar)):
            assert a.shape == (B, 1, LD)
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=VPOSERT_ATOL, rtol=1e-5)
    ref = np.asarray(jv.apply({"params": params}, jz, jnp.asarray(mask),
                              method=jv.decode))
    with torch.no_grad():
        out = v.decode(torch.from_numpy(np.asarray(jz)),
                       torch.from_numpy(mask)).numpy()
    assert out.shape == ref.shape == (B, 8, NF) and not out[~mask].any()
    np.testing.assert_allclose(out, ref, atol=VPOSERT_ATOL, rtol=0)
    # flax's initial statistics (what a tree without batch_stats loads)
    # give another encode: the loaded ones were read
    for bn in (v.bn_in, v.bn_mid):
        bn.reset_running_stats()
    with torch.no_grad():
        mu0 = v.encode(torch.from_numpy(feats))[1][0]
    assert np.abs(mu0.numpy() - np.asarray(jmu)).max() > 1e-3


def test_clip_hidden_mode_matches_jax():
    jclip = JaxClip(width=48, layers=2, heads=2, projection_dim=48,
                    compute_dtype="float32")
    mld = MLD(load_config(preset="mld_humanml3d", overrides={
        "model": {**TINY, "clip_last_hidden": True}}), device="cpu")
    ids = mld.tokenize(TEXTS)
    assert ids.shape == (2, 77)
    params = jclip.init(jax.random.PRNGKey(2),
                        jnp.asarray(ids.numpy()))["params"]
    clip = ClipTextModel(width=48, layers=2, heads=2, projection_dim=48,
                         compute_dtype="float32")
    clip.load_state_dict(flax_clip_to_state_dict(_np(params)), strict=True)
    ref = np.asarray(jclip.apply({"params": params},
                                 jnp.asarray(ids.numpy()), mode="hidden"))
    before = _launches()
    with torch.no_grad():
        out = clip(ids, mode="hidden").numpy()
    assert _launches() == before        # CPU tensors: the plain versions
    assert out.shape == ref.shape == (2, 77, 48)
    np.testing.assert_allclose(out, ref, atol=CLIP_ATOL, rtol=0)
    # the model's encode returns every hidden state, the uncond row too
    mld.clip.load_state_dict(clip.state_dict())
    np.testing.assert_allclose(mld.encode_text_tokens(ids).numpy(), out,
                               atol=0, rtol=0)
    assert mld.encode_uncond().shape == (1, 77, 48)


# ---------------------------------------------------------- end to end
class _JaxStepNoise:
    """Step i's ancestral noise as JAX's diffusion_reverse draws it
    (mld.py:463-466, 485-487), made when the port asks for it."""

    def __init__(self, rng, n_steps, shape):
        rng, _ = jax.random.split(rng)
        self.keys = jax.random.split(rng, n_steps)
        self.normal = jax.jit(
            lambda key: jax.random.normal(key, shape, jnp.float32))

    def __getitem__(self, i):
        return np.array(self.normal(self.keys[i]))


ARMS = {
    # id: (preset, model overrides, port fused_decode)
    "hidden": ("mld_humanml3d", {"clip_last_hidden": True}, False),
    "uncond": ("mld_humanml3d", {"condition": "text_uncond"}, False),
    "ablation": ("mld_humanml3d", {
        "vae_arch": "all_encoder", "mlp_dist": True,
        "position_embedding": "sine", "normalize_before": True,
        "skip_connect": False}, False),
    "vposert": ("mld_humanml3d", {"vae_type": "vposert"}, False),
    "mld7_fused": ("mld_humanml3d", {"latent_size": 7}, True),
    "kit": ("mld_kit", {}, False),
    "latent_dec": ("mld_humanml3d", {"denoiser_arch": "trans_dec"}, False),
    "raw_enc": ("novae_humanml3d", {"denoiser_arch": "trans_enc",
                                    "scheduler": {"kind": "ddim"}}, False),
    "ddpm_latent": ("mld_humanml3d", {"scheduler": {
        "kind": "ddpm", "num_train_timesteps": 4}}, False),
}


def _overrides(model):
    return {"model": merge_dicts(TINY, model), "dataset": {"max_motion_len": T}}


def _stats(nfeats):
    rng = np.random.RandomState(0)
    return ((0.1 * rng.randn(nfeats)).astype(np.float32),
            (0.5 + rng.rand(nfeats)).astype(np.float32))


def _make_pair(preset, model, **kw):
    over = _overrides(model)
    tcfg = load_config(preset=preset, overrides=over)
    mean, std = _stats(tcfg.dataset.nfeats)
    jmld = JaxMLD(jax_load_config(preset=preset, overrides=over),
                  mean=mean, std=std)
    params = _np(jmld.init_params(jax.random.PRNGKey(0)))
    tmld = MLD(tcfg, mean=mean, std=std, device="cpu", **kw)
    tmld.load_flax_params(params)
    return jmld, params, tmld


def _assert_close(out, ref):
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= E2E_RTOL * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("arm", list(ARMS))
def test_generate_matches_jax(arm, monkeypatch):
    preset, model, fused_decode = ARMS[arm]
    for name in ("MLD_TPU_FUSED_DENOISER", "MLD_TPU_FUSED_DECODE"):
        monkeypatch.delenv(name, raising=False)
    if fused_decode:
        monkeypatch.setenv("MLD_TPU_FUSED_DECODE", "1")
    jmld, params, tmld = _make_pair(preset, model, fused_decode=fused_decode)
    assert jmld._use_fused_decode() == tmld.fused_decode == fused_decode
    assert not jmld._use_fused_denoiser() and not tmld.use_fused_denoiser()
    ids = tmld.tokenize(TEXTS)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jmld.tokenize(TEXTS)))
    assert ids.shape[1] == (77 if arm == "hidden" else 16)
    mask = jax_lengths_to_mask(jnp.asarray(LENGTHS), jmld.max_frames)
    rng = jax.random.PRNGKey(3)
    # JAX's generate_feats and generate_joints (mld.py:538-554) in one
    # program: the features, and the joints generate_joints makes of them
    ref_feats, ref = (np.asarray(a) for a in jax.jit(
        lambda p, i, m, r: (lambda f: (f, jmld.feats2joints(f)
                                       * m[..., None, None]))(
            jmld._generate_impl(p, i, m, r)))(
        params, jnp.asarray(ids.numpy()), mask, rng))
    # JAX's draws: the initial latents, and each DDPM step's noise
    _, init_rng = jax.random.split(rng)
    init = np.asarray(jmld._init_latents(init_rng, len(TEXTS), mask))
    n_steps = len(tmld.scheduler.timesteps())
    replay = dict(init_latents=torch.from_numpy(init.copy()),
                  step_noise=_JaxStepNoise(rng, n_steps, init.shape))
    tmask = lengths_to_mask(LENGTHS, tmld.max_frames, "cpu")
    before = _launches()
    feats = tmld.generate_feats(ids, tmask, **replay)
    out = tmld.masked_joints(feats, tmask).numpy()
    assert _launches() == before        # CPU tensors: every plain version
    assert out.shape == ref.shape == (2, T, tmld.njoints, 3)
    assert not out[1, LENGTHS[1]:].any()
    _assert_close(feats.numpy(), ref_feats)
    _assert_close(out, ref)
    # generate_joints is the same computation
    np.testing.assert_array_equal(
        tmld.generate_joints(ids, tmask, **replay).numpy(), out)


def test_text_uncond_never_encodes_the_prompt_under_cfg(monkeypatch):
    mld = MLD(load_config(preset="mld_humanml3d", overrides=_overrides(
        {"condition": "text_uncond"})), device="cpu")
    seen = []
    encode = mld.encode_text_tokens
    monkeypatch.setattr(mld, "encode_text_tokens",
                        lambda ids: seen.append(tuple(ids.shape)) or
                        encode(ids))
    ids = mld.tokenize(TEXTS)
    cond = mld.condition_embedding(ids)
    # only the uncond row was encoded, and both halves are it
    assert seen == [(1, 8)] and cond.shape == (4, 1, 48)
    np.testing.assert_array_equal(cond[:2].numpy(), cond[2:].numpy())
    # without guidance the prompt is encoded
    mld.do_cfg = False
    seen.clear()
    assert mld.condition_embedding(ids).shape == (2, 1, 48)
    assert seen == [tuple(ids.shape)]


def test_vae_humanml3d_reconstructs_like_jax():
    jmld, params, tmld = _make_pair("vae_humanml3d", {})
    rng = np.random.RandomState(4)
    feats = rng.randn(2, T, 263).astype(np.float32)
    mask = np.arange(T)[None] < np.array(LENGTHS)[:, None]
    key = jax.random.PRNGKey(9)
    ref, ref_in = (np.asarray(a) for a in jmld.recon_from_motion(
        params, jnp.asarray(feats), jnp.asarray(mask), key))
    eps = torch.from_numpy(np.asarray(jax.random.normal(
        key, (2, tmld.latent_size, tmld.latent_dim))))
    out, out_in = tmld.recon_from_motion(torch.from_numpy(feats),
                                         torch.from_numpy(mask), eps=eps)
    _assert_close(out.numpy(), ref)
    _assert_close(out_in.numpy(), ref_in)


# ----------------------------------------------------------- rejections
@pytest.mark.parametrize("model", [
    {"clip_last_hidden": True}, {"normalize_before": True},
    {"position_embedding": "sine"}, {"skip_connect": False},
    {"denoiser_arch": "trans_dec"}, {"latent_size": 7}])
def test_fused_denoiser_refuses_what_k1_cannot_serve(model, monkeypatch):
    cfg = load_config(preset="mld_humanml3d", overrides=_overrides(model))
    with pytest.raises(ValueError, match="fused_denoiser needs"):
        MLD(cfg, device="cpu", fused_denoiser=True)
    # the switch, "1" or "auto", takes the module path there, as in JAX
    for flag in ("1", "auto"):
        monkeypatch.setenv("MLD_TPU_FUSED_DENOISER", flag)
        mld = MLD(cfg, device="cpu")
        assert not mld.use_fused_denoiser()
        assert mld.denoiser._stacked is None


def test_unbuildable_configurations_are_rejected():
    with pytest.raises(NotImplementedError,
                       match="condition=action without a VAE"):
        MLD(load_config(preset="novae_humanml3d", overrides={
            "model": {"condition": "action"}}), device="cpu")
    with pytest.raises(NotImplementedError, match="dtype=float16"):
        MLD(load_config(preset="mld_humanml3d", overrides={
            "model": {"dtype": "float16"}}), device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        MLD(load_config(preset="mld_humanml3d", overrides=_overrides(
            {"position_embedding": "rope"})), device="cpu")


# ----------------------------------------------------------- evaluation
class _Stop(Exception):
    pass


@pytest.mark.parametrize("hidden", [False, True])
def test_eval_crops_ids_in_features_mode_only(hidden, monkeypatch):
    cfg = load_config(preset="mld_humanml3d", overrides=_overrides(
        {"clip_last_hidden": hidden}))
    mld = MLD(cfg, device="cpu")
    ev = Evaluator(cfg, mld, None)
    seen = []

    def spy(ids, mask, **kw):
        seen.append(tuple(ids.shape))
        raise _Stop

    monkeypatch.setattr(mld, "generate_feats", spy)
    ids = np.asarray(mld.tokenizer(TEXTS))            # the collator's ids
    batch = {"text_ids": ids, "mask": np.ones((2, T), bool),
             "motion": np.zeros((2, T, 263), np.float32),
             "length": np.array([T, T])}
    with pytest.raises(_Stop):
        ev.eval_batch(batch, "diffusion", {"init_latents": None})
    assert seen == [(2, 77 if hidden else 16)]
