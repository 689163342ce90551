"""Weight bridge between the packages, and the port's import hygiene.

``flax_to_state_dict`` is the inverse of ``torch_state_dict_to_flax`` (and
``flax_clip_to_state_dict`` of ``convert_hf_clip_text``): a JAX param tree
survives flax -> torch -> flax unchanged, and the port's modules carry the
reference torch / HF names, so the converted dict loads strictly.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.models.clip_text import convert_hf_clip_text
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.utils.torch_convert import torch_state_dict_to_flax

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.clip_text import ClipTextModel
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.utils.convert import (flax_clip_to_state_dict,
                                         flax_to_state_dict)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                   "denoiser_num_layers": 3, "num_heads": 4,
                   "text_encoded_dim": 48, "clip_layers": 2,
                   "clip_heads": 2, "clip_compute_dtype": "float32"},
         "dataset": {"max_motion_len": 40}}


@pytest.fixture(scope="module")
def jax_params():
    mld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=SMALL))
    return jax.tree_util.tree_map(np.asarray,
                                  mld.init_params(jax.random.PRNGKey(0)))


def assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("top", ["denoiser", "vae"])
def test_round_trip_transformer_subtrees(jax_params, top):
    sd = flax_to_state_dict(jax_params[top])
    if top == "denoiser":
        assert "emb_proj.1.weight" in sd and "encoder.input_blocks.0.self_attn.in_proj_weight" in sd
    back = torch_state_dict_to_flax(sd)
    if top == "denoiser":
        back["emb_proj"] = back.pop("emb_proj_1")
    assert_trees_equal(back, jax_params[top])


def test_round_trip_clip(jax_params):
    sd = flax_clip_to_state_dict(jax_params["clip"])
    assert_trees_equal(convert_hf_clip_text(sd), jax_params["clip"])


def test_port_loads_jax_params_strictly(jax_params):
    mld = MLD(load_config(preset="mld_humanml3d", overrides=SMALL),
              device="cpu")
    mld.load_flax_params(jax_params)
    sd = mld.state_dict()
    w = jax_params["denoiser"]["encoder"]["input_blocks_0"]["linear1"]["kernel"]
    np.testing.assert_array_equal(
        sd["denoiser.encoder.input_blocks.0.linear1.weight"].numpy(), w.T)
    np.testing.assert_array_equal(
        sd["vae.global_motion_token"].numpy(),
        jax_params["vae"]["global_motion_token"])
    # the kernel's stacked weights were rebuilt from the loaded params
    np.testing.assert_array_equal(
        mld.denoiser.stacked_encoder().w1[0].numpy(), w)


def test_hf_clip_state_dict_loads_as_is():
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    torch.manual_seed(0)
    hf = CLIPTextModelWithProjection(CLIPTextConfig(
        vocab_size=1000, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=77, projection_dim=64,
        hidden_act="quick_gelu", eos_token_id=999, bos_token_id=998)).eval()
    port = ClipTextModel(vocab_size=1000, width=64, layers=2, heads=4,
                         projection_dim=64, intermediate_size=128).eval()
    sd = {k: v for k, v in hf.state_dict().items()
          if not k.endswith("position_ids")}
    port.load_state_dict(sd, strict=True)
    ids = np.random.RandomState(0).randint(1, 900, (2, 16))
    ids[:, 0], ids[0, 5:], ids[1, 11:] = 998, 999, 999
    with torch.no_grad():
        ref = hf(torch.as_tensor(ids)).text_embeds
        out = port(torch.as_tensor(ids), mode="features")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)


def test_port_imports_no_jax_and_sets_nothing():
    code = (
        "import json, sys, torch\n"
        "before = (torch.get_float32_matmul_precision(),\n"
        "          torch.backends.cuda.matmul.allow_tf32,\n"
        "          torch.backends.cudnn.allow_tf32)\n"
        "import mld_tpu_torch.models.mld, mld_tpu_torch.ops.fused_layer\n"
        "import chip_smoke\n"
        "after = (torch.get_float32_matmul_precision(),\n"
        "         torch.backends.cuda.matmul.allow_tf32,\n"
        "         torch.backends.cudnn.allow_tf32)\n"
        "print(json.dumps({'jax': sorted(m for m in sys.modules\n"
        "                   if m == 'jax' or m.startswith(('jax.', 'mld_tpu.'))\n"
        "                   or m == 'mld_tpu'),\n"
        "                  'same': before == after}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"jax": [], "same": True}
