"""The port's fixes of three faults against the JAX package, on the CPU.

- The latent denoiser's module path (the unfused skip encoder, LayerNorm
  eps 1e-6) is what both packages run off a TPU / the card: under
  MLD_TPU_FUSED_DENOISER=0 and under the CPU "auto" default, one denoiser
  call is held to JAX's ``denoise`` at 1e-4 (the stacks' bar,
  tests/test_fused_seq_decoder.py) and generate_joints end to end at
  tests/test_full_sampler_parity.py's 1e-3 x max(scale, 1).
- The attention wrappers are differentiable: the gradients of q, k and v
  through K3's and K4's autograd Functions (their backward recomputes the
  plain version's VJP) match ``jax.vjp`` of ``_sdpa_pallas_ad`` (Pallas in
  interpret mode) and of ``flash_causal_sdpa``, f32, within 2e-5 (the
  per-layer bar). On the CPU the Functions' forward stands in for the
  kernel with its plain version; the card runs them in chip_smoke.py.
- MLD_TPU_TEXT_BUCKETS is read as the JAX package reads it.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.clip_text import convert_hf_clip_text
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.mld import lengths_to_mask as jax_lengths_to_mask
from mld_tpu.ops.attention import _sdpa_pallas_ad, flash_causal_sdpa
from mld_tpu.utils.torch_convert import torch_state_dict_to_flax

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.ops import attention
from mld_tpu_torch.utils import trace

SMALL = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                   "denoiser_num_layers": 3, "num_heads": 4,
                   "text_encoded_dim": 48, "clip_layers": 2,
                   "clip_heads": 2, "clip_compute_dtype": "float32",
                   "scheduler": {"num_inference_timesteps": 5}},
         "dataset": {"max_motion_len": 40}}
TEXTS = ["a man kicks something with his left leg.",
         "a person walks backward slowly.", "someone jumps"]


@pytest.fixture(scope="module")
def pair():
    """The port initialises, JAX loads its weights through the inverse
    bridges of tests/test_torch_weights.py (no flax init to run)."""
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=SMALL))
    tmld = MLD(load_config(preset="mld_humanml3d", overrides=SMALL),
               device="cpu", generator=torch.Generator().manual_seed(0))
    sd = {k: v.detach().numpy().copy() for k, v in tmld.state_dict().items()}
    params = {"clip": convert_hf_clip_text(
        {k[5:]: v for k, v in sd.items() if k.startswith("clip.")})}
    for top in ("vae", "denoiser"):
        tree = torch_state_dict_to_flax(
            {k[len(top) + 1:]: v for k, v in sd.items()
             if k.startswith(top + ".")})
        if "emb_proj_1" in tree:
            tree["emb_proj"] = tree.pop("emb_proj_1")
        params[top] = tree
    return jmld, jax.tree_util.tree_map(jnp.asarray, params), tmld


@pytest.mark.parametrize("env", ["0", None])
def test_module_path_denoiser_matches_jax(pair, monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MLD_TPU_FUSED_DENOISER", raising=False)
    else:
        monkeypatch.setenv("MLD_TPU_FUSED_DENOISER", env)
    jmld, params, tmld = pair
    assert not jmld._use_fused_denoiser() and not tmld.use_fused_denoiser()
    rng = np.random.RandomState(1)
    sample = rng.randn(6, 1, 64).astype(np.float32)
    cond = rng.randn(6, 1, 48).astype(np.float32)
    t = np.asarray([981, 761, 41, 1, 0, 500])
    ref = np.asarray(jmld.denoise(params, jnp.asarray(sample), jnp.asarray(t),
                                  jnp.asarray(cond)))
    before = trace.total("launch.k1")
    with torch.no_grad():
        out = tmld.denoise(torch.from_numpy(sample), torch.from_numpy(t),
                           torch.from_numpy(cond)).numpy()
    assert trace.total("launch.k1") == before
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # the explicit argument overrides the switch; training ignores it
    fused = MLD(load_config(preset="mld_humanml3d", overrides=SMALL),
                device="cpu", fused_denoiser=True)
    assert fused.use_fused_denoiser()
    monkeypatch.setenv("MLD_TPU_FUSED_DENOISER", "1")
    assert tmld.use_fused_denoiser()
    sample_t = torch.from_numpy(sample)
    train_out = tmld.denoise(sample_t, torch.from_numpy(t),
                             torch.from_numpy(cond), training=True)
    assert train_out.requires_grad
    np.testing.assert_allclose(train_out.detach().numpy(), ref, atol=1e-4)


def test_generate_joints_matches_jax_under_cpu_default(pair, monkeypatch):
    monkeypatch.delenv("MLD_TPU_FUSED_DENOISER", raising=False)
    jmld, params, tmld = pair
    lengths = [40, 23, 31]
    ids = tmld.tokenize(TEXTS)
    mask = jax_lengths_to_mask(jnp.asarray(lengths), jmld.max_frames)
    rng = jax.random.PRNGKey(3)
    ref = np.asarray(jmld.generate_joints(params, jnp.asarray(ids.numpy()),
                                          mask, rng))
    _, init_rng = jax.random.split(rng)
    init = np.asarray(jmld._init_latents(init_rng, len(TEXTS), mask))
    out = tmld.generate_joints(ids, lengths_to_mask(lengths, tmld.max_frames,
                                                    "cpu"),
                               init_latents=torch.from_numpy(init.copy())
                               ).numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-3 * max(scale, 1.0)


def _grads_through(fn, inputs, g):
    xs = [torch.from_numpy(x.copy()).requires_grad_() for x in inputs]
    out = fn(*xs)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("masked", [False, True])
def test_flash_function_grads_match_jax_vjp(monkeypatch, masked):
    rng = np.random.RandomState(2)
    B, H, Sq, Sk, Dh = 2, 3, 17, 21, 16
    q, k, v = (rng.randn(B, H, S, Dh).astype(np.float32)
               for S in (Sq, Sk, Sk))
    g = rng.randn(B, H, Sq, Dh).astype(np.float32)
    valid = (np.arange(Sk)[None] < np.asarray([Sk, 9])[:, None]
             if masked else np.ones((B, Sk), bool))
    ref, vjp = jax.vjp(lambda a, b, c: _sdpa_pallas_ad(a, b, c,
                                                       jnp.asarray(valid)),
                       *(jnp.asarray(x) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    # the Function with its forward's kernel stood in for by its plain
    # version (what the kernel is held to on the card)
    monkeypatch.setattr(attention, "_flash_launch",
                        lambda *a: attention.flash_plain(*a))
    kv = torch.from_numpy(valid)
    for fn in (lambda a, b, c: attention._Flash.apply(a, b, c, kv),
               lambda a, b, c: attention.sdpa(a, b, c, kv)):
        out, grads = _grads_through(fn, (q, k, v), g)
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)
        for got, want in zip(grads, ref_grads):
            np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


def test_flash_causal_function_grads_match_jax_vjp(monkeypatch):
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 4, 23, 16).astype(np.float32) for _ in range(3))
    g = rng.randn(2, 4, 23, 16).astype(np.float32)
    scale = 0.25
    ref, vjp = jax.vjp(lambda a, b, c: flash_causal_sdpa(a, b, c, scale),
                       *(jnp.asarray(x) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    monkeypatch.setattr(attention, "_flash_causal_launch",
                        lambda *a: attention.flash_causal_plain(*a))
    for fn in (lambda a, b, c: attention._FlashCausal.apply(a, b, c, scale),
               lambda a, b, c: attention.sdpa_flash_causal(a, b, c, scale)):
        out, grads = _grads_through(fn, (q, k, v), g)
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)
        for got, want in zip(grads, ref_grads):
            np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


def test_attention_dropout_dispatch_by_arguments():
    """Probability dropout takes the plain version on any device, chosen
    by the arguments: on a device without the kernel it still runs."""
    q = torch.randn(2, 2, 5, 8)
    meta = q.to("meta")
    out = attention.sdpa(meta, meta, meta, None, 0.1,
                         torch.Generator().manual_seed(0))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="no attention kernel"):
        attention.sdpa(meta, meta, meta)
    with pytest.raises(ValueError, match="needs the generator"):
        attention.sdpa(q, q, q, None, 0.1)
    a = attention.sdpa(q, q, q, None, 0.1, torch.Generator().manual_seed(4))
    b = attention.flash_plain(q, q, q, None, 0.1,
                              torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert not torch.equal(a, attention.sdpa(q, q, q))


@pytest.mark.parametrize("env", [None, "auto", "0", "off", "16,77", "8"])
def test_text_buckets_env_as_jax(pair, monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MLD_TPU_TEXT_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("MLD_TPU_TEXT_BUCKETS", env)
    jmld, _, tmld = pair
    np.testing.assert_array_equal(tmld.tokenize(TEXTS).numpy(),
                                  np.asarray(jmld.tokenize(TEXTS)))
    if env in ("0", "off"):
        assert tmld.tokenize(TEXTS).shape[1] == 77
