"""Port's CLIP causal attention (K4) and single fused encoder layer (K2) vs
the JAX package, the wrappers' refusal of autograd on the card, and the
decode switch of MLD.

The plain versions run here (CPU tensors); the JAX side runs its Pallas
kernels in interpret mode, as its own tests do. Bars are those of
``tests/test_attention.py`` (f32 1e-5, bf16 2e-2) and
``tests/test_fused_layer.py`` (2e-5). The CUDA kernels are checked against
the same plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.clip_text import ClipTextModel as JaxClip
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.ops.attention import sdpa_flash_causal as jax_flash_causal
from mld_tpu.ops.fused_layer import fused_encoder_layer as jax_encoder_layer
from mld_tpu.ops.transformer import TransformerEncoderLayer as JaxEncoderLayer

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.clip_text import ClipTextModel
from mld_tpu_torch.models.denoiser import MldDenoiser
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.ops import attention, fused_layer
from mld_tpu_torch.ops.attention import flash_causal_plain, sdpa_flash_causal
from mld_tpu_torch.ops.fused_layer import (fused_encoder_layer,
                                           skip_encoder_stack_plain,
                                           stack_encoder_layer)
from mld_tpu_torch.ops.transformer import TransformerEncoderLayer
from mld_tpu_torch.utils import trace
from mld_tpu_torch.utils.convert import (flax_clip_to_state_dict,
                                         flax_to_state_dict)

SMALL = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                   "denoiser_num_layers": 3, "num_heads": 4,
                   "text_encoded_dim": 48, "clip_layers": 1,
                   "clip_heads": 2, "clip_compute_dtype": "float32"},
         "dataset": {"max_motion_len": 40}}


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,scale,jdt,tdt,atol", [
    ((3, 4, 77, 64), 0.125, jnp.float32, torch.float32, 1e-5),
    ((2, 2, 33, 16), 0.25, jnp.bfloat16, torch.bfloat16, 2e-2),
    ((2, 12, 8, 64), 0.125, jnp.float32, torch.float32, 1e-5),  # uncond row
])
def test_plain_causal_matches_jax_kernel(shape, scale, jdt, tdt, atol):
    q, k, v = _qkv(shape, seed=1)
    ref = jax_flash_causal(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                           jnp.asarray(v, jdt), sm_scale=scale,
                           interpret=True)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    out = flash_causal_plain(*t, scale)
    assert out.dtype == tdt and out.shape == shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


def test_causal_wrapper_takes_plain_version_on_cpu_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 3, 16, 8), 2))
    before = trace.total("launch.k4")
    out = sdpa_flash_causal(q, k, v, 0.5)
    np.testing.assert_array_equal(out.numpy(),
                                  flash_causal_plain(q, k, v, 0.5).numpy())
    assert trace.total("launch.k4") == before
    with pytest.raises(ValueError, match="no causal-attention kernel"):
        sdpa_flash_causal(q.to("meta"), k.to("meta"), v.to("meta"))


def test_causal_kernel_argument_checks():
    q = torch.zeros(2, 12, 77, 64)
    attention._check(q, q, q)                               # accepted
    attention._check(q.bfloat16(), q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="k must match q"):
        attention._check(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="f32 or bf16"):
        attention._check(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        attention._check(t, t, t)
    with pytest.raises(ValueError, match="S <= 128"):
        big = torch.zeros(1, 1, 129, 64)
        attention._check(big, big, big)
    with pytest.raises(ValueError, match="multiple of 4"):
        odd = torch.zeros(1, 1, 8, 30)
        attention._check(odd, odd, odd)


@pytest.mark.parametrize("jax_flash", ["1", "0"])
def test_clip_tower_flash_matches_jax(monkeypatch, jax_flash):
    # the port's tower always takes sdpa_flash_causal; JAX's flash and einsum
    # paths compute the same function, and the port matches both
    jclip = JaxClip(width=64, layers=2, heads=4, projection_dim=64)
    ids = np.random.RandomState(0).randint(1, 49405, size=(3, 77))
    ids = jnp.asarray(ids, jnp.int32)
    monkeypatch.setenv("MLD_TPU_CLIP_FLASH", jax_flash)
    params = jclip.init(jax.random.PRNGKey(0), ids)["params"]
    ref = jclip.apply({"params": params}, ids, mode="hidden")
    clip = ClipTextModel(width=64, layers=2, heads=4, projection_dim=64)
    clip.load_state_dict(flax_clip_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    before = trace.total("launch.k4")
    with torch.no_grad():
        out = clip(torch.as_tensor(np.array(ids), dtype=torch.long),
                   mode="hidden")
    assert trace.total("launch.k4") == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("B,S,D,H,F", [(5, 3, 64, 4, 128), (2, 8, 32, 2, 96)])
def test_fused_encoder_layer_matches_jax(B, S, D, H, F):
    rng = np.random.RandomState(0)
    x = rng.randn(B, S, D).astype(np.float32)
    jlayer = JaxEncoderLayer(d_model=D, num_heads=H, ff_size=F, dropout=0.0)
    params = jlayer.init({"params": jax.random.PRNGKey(0)},
                         jnp.asarray(x))["params"]
    ref = jax_encoder_layer(jnp.asarray(x), params, H, interpret=True)
    layer = TransformerEncoderLayer(D, H, F)
    layer.load_state_dict(flax_to_state_dict(params))
    before = trace.total("launch.k2")
    with torch.no_grad():
        out = fused_encoder_layer(torch.from_numpy(x), layer)
    assert trace.total("launch.k2") == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_single_layer_stack_has_empty_skips():
    layer = TransformerEncoderLayer(64, 4, 128)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.1)
    st = stack_encoder_layer(layer, torch.bfloat16)
    assert st.wqkv.shape == (1, 64, 192) and st.wqkv.dtype == torch.bfloat16
    assert st.wsx.shape == st.wss.shape == (0, 64, 64)
    assert st.wsx.dtype == torch.bfloat16 and st.bs.shape == (0, 64)
    x = torch.randn(4, 3, 64)
    fused_layer._check(x, st, 0, 4)   # what the CUDA entry is handed
    with torch.no_grad():
        np.testing.assert_array_equal(
            fused_encoder_layer(x, layer, st).numpy(),
            skip_encoder_stack_plain(x, st, 0, 4).numpy())
    with pytest.raises(ValueError, match="no encoder-layer kernel"):
        fused_encoder_layer(x.to("meta"), layer, st)


@pytest.mark.parametrize("decode_env", [
    None, "1", "0", "auto", "true", "on", "false", "yes"])
def test_switches_parse_as_jax(monkeypatch, decode_env):
    if decode_env is None:
        monkeypatch.delenv("MLD_TPU_FUSED_DECODE", raising=False)
    else:
        monkeypatch.setenv("MLD_TPU_FUSED_DECODE", decode_env)
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=SMALL))
    mld = MLD(load_config(preset="mld_humanml3d", overrides=SMALL),
              device="cpu")
    assert mld.fused_decode == jmld._use_fused_decode()
    assert (mld.vae._stacked is not None) == mld.fused_decode
    # the explicit argument overrides the environment
    off = MLD(load_config(preset="mld_humanml3d", overrides=SMALL),
              fused_decode=False, device="cpu")
    assert not off.fused_decode and off.vae._stacked is None


def _meta(t, grad):
    return torch.zeros(t.shape, device="meta", requires_grad=grad)


@pytest.mark.parametrize("which", ["flash_causal", "skip_encoder",
                                   "encoder_layer"])
def test_kernel_wrappers_refuse_autograd(which):
    # K1 and K2 are forward-only: off the CPU, an input autograd tracks is
    # refused before any launch, rather than cut from its graph
    layer = TransformerEncoderLayer(64, 4, 128)
    st = stack_encoder_layer(layer)
    x = torch.zeros(2, 3, 64)
    q = torch.zeros(2, 2, 8, 16)
    call = {
        "flash_causal": lambda g: sdpa_flash_causal(
            _meta(q, g), _meta(q, g), _meta(q, g)),
        "skip_encoder": lambda g: fused_layer.skip_encoder_stack(
            _meta(x, g), st, 0, 4),
        "encoder_layer": lambda g: fused_encoder_layer(_meta(x, g), layer,
                                                       st),
    }[which]
    if which == "flash_causal":
        # K4's wrapper is differentiable (its autograd.Function recomputes
        # the plain version's VJP): only the device is refused
        with pytest.raises(ValueError, match="kernel for device meta"):
            call(True)
    else:
        with pytest.raises(RuntimeError, match="has no backward"):
            call(True)
    with torch.no_grad():                   # refused for the device only
        with pytest.raises(ValueError, match="kernel for device meta"):
            call(True)
    with pytest.raises(ValueError, match="kernel for device meta"):
        call(False)
    # on the CPU the plain version keeps the graph
    qc = torch.randn(2, 2, 8, 16, requires_grad=True)
    sdpa_flash_causal(qc, qc, qc).sum().backward()
    assert qc.grad is not None and torch.isfinite(qc.grad).all()


def test_fused_decode_env_needs_a_fusable_config(monkeypatch):
    monkeypatch.setenv("MLD_TPU_FUSED_DECODE", "1")
    over = {**SMALL, "model": {**SMALL["model"], "latent_size": 9}}
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=over))
    assert not jmld._use_fused_decode()
    # the port builds it too, on the plain decode
    cfg = load_config(preset="mld_humanml3d", overrides=over)
    assert not MLD(cfg, device="cpu").fused_decode
    # latent_size 9 also exceeds the denoiser kernel's 8 tokens: the module
    # path serves it, and asking for K1 raises
    with pytest.raises(ValueError, match="exceeds the fused"):
        MLD(cfg, device="cpu", fused_denoiser=True)


def test_encoder_stack_follows_loads_and_moves():
    den = MldDenoiser(1, 64, 128, 3, 4, 48)
    for p in den.parameters():
        torch.nn.init.normal_(p, std=0.1)
    den.restack()
    first = den.stacked_encoder()
    den.load_state_dict({k: 2 * v for k, v in den.state_dict().items()})
    np.testing.assert_array_equal(den.stacked_encoder().w1.numpy(),
                                  2 * first.w1.numpy())
    np.testing.assert_array_equal(den.stacked_encoder().ln2b.numpy(),
                                  2 * first.ln2b.numpy())
    den.to("meta")
    assert den.stacked_encoder().wqkv.device.type == "meta"


def test_mld_stacks_follow_load_flax_params():
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=SMALL))
    params = jax.tree_util.tree_map(np.asarray,
                                    jmld.init_params(jax.random.PRNGKey(1)))
    mld = MLD(load_config(preset="mld_humanml3d", overrides=SMALL),
              fused_decode=True, device="cpu")
    before_dec = mld.vae.stacked_decoder().w2.clone()
    before_enc = mld.denoiser.stacked_encoder().w2.clone()
    mld.load_flax_params(params)
    dec_w2 = params["vae"]["decoder"]["middle_block"]["linear2"]["kernel"]
    enc_w2 = params["denoiser"]["encoder"]["middle_block"]["linear2"]["kernel"]
    np.testing.assert_array_equal(mld.vae.stacked_decoder().w2[1].numpy(),
                                  dec_w2)
    np.testing.assert_array_equal(mld.denoiser.stacked_encoder().w2[1].numpy(),
                                  enc_w2)
    assert not torch.equal(mld.vae.stacked_decoder().w2, before_dec)
    assert not torch.equal(mld.denoiser.stacked_encoder().w2, before_enc)
