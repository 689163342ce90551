"""Training the text family's model options in the port vs the JAX package.

One step of ``diffusion`` in hidden mode (the [B, 77, text_dim] condition of
the collator's full-context ids, the full-context uncond row broadcast,
nothing cropped), under ``text_uncond`` (trained exactly as ``text``) and
with the ablation's denoiser (a plain pre-norm encoder with sine PE), and
one step of ``vae`` with the ablation's VAE (all_encoder, mlp_dist,
pre-norm, sine PE), each held to ``mld_tpu/train/steps.py`` as
tests/test_torch_train.py holds the presets' steps: every log within 1e-5 x
max(|v|, 1), every gradient leaf within 1e-4 of its largest |g|, from
JAX's draws replayed through ``draws=``, on tests/test_torch_train.py's
tiny configuration and synthetic corpus. A VPosert VAE is refused by
``create_train_state`` and ``train()``: the JAX trainer cannot encode
through it.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data.datamodule import get_datamodule as jax_get_datamodule
from mld_tpu.models.mld import MLD as JaxMLD

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.mld import MLD
from mld_tpu_torch.train import steps
from mld_tpu_torch.train.loop import train

from test_torch_train import (GRAD_RTOL, LOG_RTOL, _one_torch_thread,  # noqa
                              jax_draws, jax_grads, jax_params_of,
                              synth_root, tiny_over, torch_named)

ABLATION = {"vae_arch": "all_encoder", "mlp_dist": True,
            "position_embedding": "sine", "normalize_before": True,
            "skip_connect": False}
CASES = {
    "diffusion hidden": ("diffusion", {"clip_last_hidden": True}),
    "diffusion text_uncond": ("diffusion", {"condition": "text_uncond"}),
    "diffusion ablation": ("diffusion", ABLATION),
    "vae ablation": ("vae", ABLATION),
}


def make_pair(synth_root, stage, model):
    """JAX's and the port's MLD on the port's initial weights (JAX loads
    them through the inverse bridges), with a batch of JAX's loader."""
    over = tiny_over(synth_root, stage)
    over["model"].update(model)
    jcfg = jax_load_config(preset="mld_humanml3d", overrides=over)
    tcfg = load_config(preset="mld_humanml3d", overrides=over)
    mean = np.load(f"{synth_root}/Mean.npy")
    std = np.load(f"{synth_root}/Std.npy")
    jmld = JaxMLD(jcfg, mean=mean, std=std)
    tmld = MLD(tcfg, mean=mean, std=std, device="cpu",
               generator=torch.Generator().manual_seed(0))
    params = jax_params_of(tmld)
    dm = jax_get_datamodule(jcfg, tokenizer=jmld.tokenizer)
    batch = next(iter(dm.loader("train", batch_size=4, prefetch=0)))
    keys = ("motion", "mask", "text_ids")
    jbatch = {k: jnp.asarray(batch[k]) for k in keys}
    jbatch["row_valid"] = jnp.ones(4, bool)
    return jmld, params, tmld, jbatch, steps.batch_to_device(batch, "cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(synth_root, case):
    stage, model = CASES[case]
    jmld, params, tmld, jbatch, tbatch = make_pair(synth_root, stage, model)
    assert tbatch["text_ids"].shape == (4, 77)
    rng = jax.random.PRNGKey(7)
    _, jlogs, jgrads = jax_grads(jmld, params, stage, jbatch, rng)

    state = steps.create_train_state(tmld, stage)
    draws = jax_draws(jmld, stage, rng, jbatch)
    if "hidden" in case:
        # the condition is every hidden state of the full-context ids
        cond = tmld.encode_text_tokens(tbatch["text_ids"])
        assert cond.shape == (4, 77, 32)
        assert tmld.encode_uncond().shape == (1, 77, 32)
    logs, grads = steps.compute_grads(state, tbatch, None, draws)

    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        v = float(v)
        assert abs(float(logs[k]) - v) <= LOG_RTOL * max(abs(v), 1.0), (
            k, float(logs[k]), v)
    want = torch_named(jgrads)
    assert set(grads) == set(want)
    for k, g in want.items():
        scale = max(float(g.abs().max()), 1e-6)
        err = float((grads[k] - g).abs().max())
        assert err <= GRAD_RTOL * scale, (k, err, scale)
    assert steps.apply_grads(state)


@pytest.mark.parametrize("entry", ["create_train_state", "train"])
def test_vposert_training_is_refused(synth_root, tmp_path, entry):
    over = tiny_over(synth_root, "vae")
    over["model"]["vae_type"] = "vposert"
    over["logger"] = {"folder": str(tmp_path)}
    cfg = load_config(preset="mld_humanml3d", overrides=over)
    with pytest.raises(NotImplementedError,
                       match="cannot encode motion through VPosert"):
        if entry == "train":
            train(cfg, max_steps=1, device="cpu")
        else:
            steps.create_train_state(MLD(cfg, device="cpu"), "diffusion")
