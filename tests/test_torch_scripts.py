"""The port's user scripts held against the JAX package's on the CPU: the
safetensors reader, the HF CLIP hydration, the checkpoint converter, the
parity drill (piece by piece and whole), the operation counts, the latent
trajectories, the DDIM ablation and the carried copies of the asset
scripts.

Assets are fabricated at a tiny width (``mld_tpu_torch/scripts/
drill_assets.py``: a reference-format checkpoint, an HF-named text tower,
finest.tar, the meta statistics, a synthetic HumanML3D corpus). Bars: bit
equality where both sides read the same bytes (the reader, the converted
weights, the carried copies); the CLIP tower's 1e-4
(tests/test_torch_modules.py); the evaluation's metrics at
tests/test_torch_eval.py's (1e-4 relative, R-precision within one
retrieval of its R-size); the sampler's latents within 1e-3 x max(scale,
1) (tests/test_torch_generate.py); operation counts exactly.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.config import merge_dicts as jax_merge_dicts
from mld_tpu.eval import pipeline as jax_pipeline
from mld_tpu.eval.pipeline import Evaluator as JaxEvaluator
from mld_tpu.models.clip_text import ClipTextModel as JaxClip
from mld_tpu.models.clip_text import load_hf_clip_weights as jax_hydrate
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.mld import lengths_to_mask as jax_lengths_to_mask

from mld_tpu_torch.config import load_config
from mld_tpu_torch.models.clip_text import ClipTextModel, load_hf_clip_weights
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.ops import work
from mld_tpu_torch.scripts import (ablate_ddim_steps, convert_checkpoint,
                                   drill_assets, parity_drill,
                                   train_synthetic_e2e, tsne)
from mld_tpu_torch.scripts import flops as port_flops
from mld_tpu_torch.utils.convert import state_dict_to_flax
from mld_tpu_torch.utils.flops import count, generate_parts, parts_total
from mld_tpu_torch.utils.safetensors import load_file
from scripts import ablate_ddim_steps as jax_ablate_ddim_steps
from scripts import convert_checkpoint as jax_convert_checkpoint
from scripts import parity_drill as jax_parity_drill

from conftest import REPO_ROOT

EMB_ATOL = 1e-4
METRIC_RTOL = 1e-4
LATENT_RTOL = 1e-3
TINY = {"model": {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
                  "denoiser_num_layers": 3, "num_heads": 4,
                  "text_encoded_dim": 32, "clip_layers": 2, "clip_heads": 4,
                  "clip_compute_dtype": "float32",
                  "scheduler": {"num_inference_timesteps": 3}},
        "eval": {"batch_size": 8, "r_size": 4, "diversity_times": 6},
        "logger": {"tensorboard": False}}


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(argv, timeout=600):
    return subprocess.run([sys.executable] + argv, capture_output=True,
                          text=True, timeout=timeout, env=_env(),
                          cwd=REPO_ROOT)


def _jax_main(script, argv):
    """A JAX script's main() in this process with `argv`: its exit code."""
    saved = sys.argv
    sys.argv = [script.__file__] + argv
    try:
        script.main()
    except SystemExit as e:
        return e.code
    finally:
        sys.argv = saved
    return 0


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The drill's assets at the tiny width, the overrides file and both
    packages' resolved configs."""
    root = str(tmp_path_factory.mktemp("drill_assets"))
    yml = os.path.join(root, "tiny.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(TINY, f)
    paths = parity_drill.asset_paths(root)
    cfg = parity_drill.drill_config(root, paths, 1, yml)
    drill_assets.fabricate(root, cfg, n_clips=48)
    over = jax_merge_dicts({
        "debug": False,
        "dataset": {"root": paths["data"],
                    "word_vectorizer_path": paths["glove"]},
        "model": {"clip_path": paths["clip"],
                  "t2m_path": os.path.join(root, "deps", "t2m")},
        "test": {"replication_times": 1}}, TINY)
    jcfg = jax_load_config(None, over, preset="mld_humanml3d")
    return {"root": root, "yaml": yml, "paths": paths, "cfg": cfg,
            "jcfg": jcfg}


# ------------------------------------------------------------- safetensors
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_reader_bit_equal(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g), "b.c": torch.randn(
        7, generator=g), "scalar": torch.randn((), generator=g),
        "empty": torch.randn(0, 4, generator=g)}
    tensors = {k: (v * 1000).to(dtype) for k, v in tensors.items()}
    path = str(tmp_path / "t.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    ours, ref = load_file(path), st.load_file(path)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert torch.equal(ours[k], v), k


def test_safetensors_reader_raises_on_other_dtypes(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    path = str(tmp_path / "t.safetensors")
    st.save_file({"x": torch.zeros(3, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        load_file(path)
    with open(path, "wb") as f:
        f.write(b"\x05\x00")
    with pytest.raises(ValueError, match="too short"):
        load_file(path)


# ---------------------------------------------------------- CLIP hydration
def _hf_clip_dir(root, fmt):
    """A tiny HF CLIPModel state dict (the text tower, plus the vision
    keys, logit_scale and position_ids the loader drops) of seeded
    values."""
    tower = ClipTextModel(vocab_size=1000, width=64, layers=2, heads=4,
                          projection_dim=64, intermediate_size=128)
    state = drill_assets._seeded_like(tower.state_dict(), 7, scale=0.05)
    state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    state["vision_model.embeddings.class_embedding"] = torch.ones(8)
    state["visual_projection.weight"] = torch.ones(4, 8)
    state["logit_scale"] = torch.tensor(2.0)
    os.makedirs(root, exist_ok=True)
    if fmt == "safetensors":
        st = pytest.importorskip("safetensors.torch")
        st.save_file(state, os.path.join(root, "model.safetensors"))
    else:
        torch.save(state, os.path.join(root, "pytorch_model.bin"))
    return root


def _clip_ids():
    ids = np.random.RandomState(0).randint(1, 900, (3, 77))
    ids[:, 0] = 998
    for i, n in enumerate((5, 20, 77)):
        ids[i, n - 1] = 999
        ids[i, n:] = 999 if n < 77 else ids[i, n:]
    return ids


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_clip_hydration_matches_jax(tmp_path, fmt):
    root = _hf_clip_dir(str(tmp_path / "clip"), fmt)
    port = ClipTextModel(vocab_size=1000, width=64, layers=2, heads=4,
                         projection_dim=64, intermediate_size=128)
    state = load_hf_clip_weights(root, tower=port)
    assert "logit_scale" not in state and not any(
        k.startswith(("vision_model.", "visual_projection.")) or
        k.endswith("position_ids") for k in state)
    params = jax_hydrate(root)
    jclip = JaxClip(vocab_size=1000, width=64, layers=2, heads=4,
                    projection_dim=64, intermediate_size=128)
    ids = _clip_ids()
    for mode in ("features", "pooled", "hidden"):
        ref = jclip.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                          mode=mode)
        with torch.no_grad():
            out = port.eval()(torch.as_tensor(ids), mode=mode)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=EMB_ATOL)


def test_clip_hydration_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_hf_clip_weights(str(tmp_path))
    torch.save({"vision_model.x": torch.zeros(2)},
               str(tmp_path / "pytorch_model.bin"))
    with pytest.raises(ValueError, match="no CLIP text-tower"):
        load_hf_clip_weights(str(tmp_path))


# --------------------------------------------------------------- converter
def test_converter_matches_jax_script(assets, tmp_path):
    ckpt = assets["paths"]["ckpt"]
    ours = str(tmp_path / "port.npz")
    cfg = load_config(assets["yaml"], None, preset="mld_humanml3d")
    tops, mld = convert_checkpoint.convert(ckpt, cfg, "cpu", ours)
    assert sorted(tops) == ["denoiser", "vae"]
    ref = str(tmp_path / "jax.npz")
    assert _jax_main(jax_convert_checkpoint, ["--ckpt", ckpt, "--cfg",
                                              assets["yaml"], "--out",
                                              ref]) == 0
    with np.load(ours) as a, np.load(ref) as b:
        # JAX's extra subtree is its random clip init (the divergence)
        assert {k for k in b.files if k not in a.files} == {
            k for k in b.files if k.startswith("clip/")}
        assert not any(k.startswith("clip/") for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # and the npz reloads into the model bit for bit
    from mld_tpu_torch.utils.checkpoint import load_pretrained
    fresh = MLD(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    assert sorted(load_pretrained(fresh, ours)) == ["denoiser", "vae"]
    own = mld.state_dict()
    for k, v in fresh.state_dict().items():
        if k.startswith(("vae.", "denoiser.")):
            assert torch.equal(v, own[k]), k


# -------------------------------------------------------------------- drill
DRILL_ARGS = ["--replications", "1", "--no-mm", "--skip-timing"]


@pytest.fixture(scope="module")
def drills(assets, tmp_path_factory):
    """Both packages' drills run whole on the assets: the port's as its CLI
    in a subprocess, JAX's main() meanwhile in this process with its
    evaluator spied on (its model, the params it converted and hydrated,
    its results with each batch's rng). Each with (exit code, report)."""
    out = tmp_path_factory.mktemp("drill_reports")
    common = ["--assets-root", assets["root"], "--cfg", assets["yaml"]]
    common += DRILL_ARGS
    port_path = str(out / "port.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mld_tpu_torch.scripts.parity_drill",
         "--device", "cpu"] + common + ["--out", port_path],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=REPO_ROOT)
    seen = {"rngs": []}

    class Spy(JaxEvaluator):
        def run(self, params, *args, **kwargs):
            seen["mld"], seen["params"] = self.mld, params
            jit = self._eval_batch_jit

            def spy(p, text_ids, *a, stage):
                seen["rngs"].append((a[-1], text_ids.shape[0]))
                return jit(p, text_ids, *a, stage=stage)

            self._eval_batch_jit = spy
            seen["results"] = super().run(params, *args, **kwargs)
            return seen["results"]

    jax_path = str(out / "jax.json")
    jax_pipeline.Evaluator = Spy
    try:
        code = _jax_main(jax_parity_drill, common + ["--out", jax_path])
    finally:
        jax_pipeline.Evaluator = JaxEvaluator
        _, err = proc.communicate(timeout=600)
    seen["jax"] = (code, json.load(open(jax_path)))
    assert os.path.exists(port_path), err[-3000:]
    seen["port"] = (proc.returncode, json.load(open(port_path)))
    return seen


@pytest.fixture(scope="module")
def port_drill(assets):
    present = {k: os.path.exists(v) for k, v in assets["paths"].items()}
    report = parity_drill.Report(steps=[])
    dm, mld = parity_drill.build(assets["cfg"], assets["paths"], present,
                                 torch.device("cpu"), report)
    return {"dm": dm, "mld": mld, "report": report}


def test_drill_build_converts_and_hydrates_like_jax(assets, drills,
                                                    port_drill):
    steps = {s["step"]: s["ok"] for s in port_drill["report"]["steps"]}
    assert steps == {"tokenizer": True, "convert+shape-validate": True,
                     "clip-hydrate": True, "t2m-eval-stats": True}
    mld, params = port_drill["mld"], drills["params"]
    tree = state_dict_to_flax({k: v for k, v in mld.state_dict().items()
                               if k.startswith(("vae.", "denoiser."))})
    for top in ("vae", "denoiser"):
        flat = jax.tree_util.tree_flatten_with_path(params[top])[0]
        ours = jax.tree_util.tree_flatten_with_path(tree[top])[0]
        assert [p for p, _ in flat] == [p for p, _ in ours], top
        for (path, ref), (_, got) in zip(flat, ours):
            assert np.array_equal(np.asarray(ref), got), (top, path)
    ids = _clip_ids() % 49000
    jclip = drills["mld"].clip
    with torch.no_grad():
        out = mld.clip(torch.as_tensor(ids), mode="features")
    ref = jclip.apply({"params": params["clip"]}, jnp.asarray(ids, jnp.int32),
                      mode="features")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=EMB_ATOL)


def test_drill_evaluate_with_jax_draws_gives_jax_metrics(assets, drills,
                                                         port_drill):
    jmld, dm = drills["mld"], port_drill["dm"]
    n = len(dm.dataset("test"))
    B = assets["cfg"].eval.batch_size
    rows = [B] * (n // B) + ([n % B] if n % B else [])
    draws = []
    for (srng, pad_rows), real in zip(drills["rngs"], rows):
        _, init_rng = jax.random.split(srng)
        init = np.asarray(jmld._init_latents(init_rng, pad_rows, None))
        draws.append({"init_latents": torch.from_numpy(init[:real].copy())})
    assert len(draws) == len(rows)
    res, _ = parity_drill.evaluate(assets["cfg"], port_drill["mld"], dm, 1,
                                   False, draws=[draws])
    ref = drills["results"]
    assert set(res) == set(ref)
    r_count = n // assets["cfg"].eval.r_size * assets["cfg"].eval.r_size
    for k, v in ref.items():
        if "R_precision" in k and not k.endswith("conf95"):
            assert abs(res[k] - v) <= 1.0 / r_count + 1e-12, (k, res[k], v)
        elif not k.endswith("conf95"):
            assert abs(res[k] - v) <= METRIC_RTOL * max(abs(v), 1e-12), (
                k, res[k], v)


def test_drill_reports_agree(drills):
    (jcode, jrep), (code, rep) = drills["jax"], drills["port"]
    assert code == jcode == 1          # random weights fail the targets
    assert set(rep) == set(jrep)
    assert [s["step"] for s in rep["steps"]] == [s["step"]
                                                 for s in jrep["steps"]]
    assert [s["ok"] for s in rep["steps"]] == [s["ok"] for s in jrep["steps"]]
    assert rep["verdict"].split(":")[0] == jrep["verdict"].split(":")[0] \
        == "fail"
    assert rep["verdict"].endswith("not release-grade)")
    assert set(rep["results"]) == set(jrep["results"])
    assert set(rep["comparisons"]) == set(jrep["comparisons"])


def test_drill_verdict_equals_jax_on_its_results(drills):
    _, jrep = drills["jax"]
    comparisons, verdict = parity_drill.verdict(jrep["results"],
                                                jrep["budget"], False)
    assert comparisons == jrep["comparisons"]
    assert verdict == jrep["verdict"]
    passing = {k: v * 1.01 for k, v in parity_drill.PAPER_TARGETS.items()}
    assert parity_drill.verdict(passing, 0.05, True)[1] == "pass"


def test_drills_blocked_on_an_empty_root(tmp_path):
    argv = ["--assets-root", str(tmp_path / "none"), "--out"]
    jax_path, port_path = str(tmp_path / "jax.json"), str(tmp_path / "p.json")
    assert _jax_main(jax_parity_drill, argv + [jax_path]) == 2
    code, report, built = parity_drill.run(parity_drill.parse_args(
        argv + [port_path, "--device", "cpu"]))
    assert code == 2 and built == {}
    for path in (jax_path, port_path):
        assert json.load(open(path))["verdict"].startswith("blocked"), path
    assert report["verdict"] == json.load(open(jax_path))["verdict"]


# -------------------------------------------------------------------- flops
@pytest.fixture(scope="module")
def tiny_mld(assets):
    cfg = load_config(assets["yaml"], None, preset="mld_humanml3d")
    return MLD(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def test_kernel_counters_count_the_plain_products():
    """Each kernel's counted operations equal FlopCounterMode's count of
    its plain version's products (so a stage counts alike on the card and
    on the CPU)."""
    from mld_tpu_torch.models.vae import MldVae
    from mld_tpu_torch.ops.attention import flash_causal_plain, flash_plain
    from mld_tpu_torch.ops.fused_layer import (skip_encoder_stack_plain,
                                               stack_skip_encoder)
    from mld_tpu_torch.ops.fused_seq_decoder import (
        skip_decoder_stack_plain, stack_skip_decoder)
    from mld_tpu_torch.ops.transformer import SkipTransformerEncoder
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(3, 4, 5, 8, generator=g), torch.randn(3, 4, 7, 8,
                                                             generator=g)
    valid = torch.rand(3, 7, generator=g) > 0.3
    assert count(lambda: flash_plain(q, k, k, valid)) \
        == work.dense_attention_flops(q, k)
    assert count(lambda: flash_causal_plain(q, q, q)) \
        == work.dense_attention_flops(q, q)
    enc = SkipTransformerEncoder(32, 4, 5, 64).eval()
    x = torch.randn(6, 3, 32, generator=g)
    assert count(lambda: skip_encoder_stack_plain(
        x, stack_skip_encoder(enc), 2, 4)) == work.encoder_flops(6, 3, 32,
                                                                 64, 2)
    vae = MldVae(263, 2, 32, 64, 5, 4)
    tgt, mem = torch.randn(2, 9, 32, generator=g), torch.randn(2, 2, 32,
                                                               generator=g)
    assert count(lambda: skip_decoder_stack_plain(
        tgt, mem, torch.ones(2, 9, dtype=torch.bool),
        stack_skip_decoder(vae.decoder), 2, 4)) \
        == work.decoder_plain_flops(2, 9, 2, 32, 64, 2)


def test_stage_counts_equal_their_products(tiny_mld):
    """Each loop-free stage, counted as it runs, equals an analytic count
    of its matrix products."""
    m = tiny_mld
    c = m.cfg.model
    D, F, W, B, T = c.latent_dim, c.ff_size, c.text_encoded_dim, 2, 40
    nb = (c.num_layers - 1) // 2
    rep = port_flops.analyze(m, B, T)
    S = 77
    clip = (c.clip_layers * (8 * B * S * W * W + 4 * B * S * S * W
                             + 4 * B * S * W * 4 * W) + 2 * B * W * W)
    assert rep["clip_text"]["flops"] == clip
    rows = 2 * B
    # the time MLP; the text projection only where the widths differ
    step = (2 * rows * (W * D + D * D)
            + (2 * rows * W * D if m.denoiser.emb_proj is not None else 0)
            + work.encoder_flops(rows, c.latent_size + 2, D, F, nb))
    assert rep["denoiser_step"]["flops"] == step
    Tm = m.max_frames
    assert rep["vae_decode"]["flops"] == (
        work.decoder_plain_flops(B, Tm, c.latent_size, D, F, nb)
        + 2 * B * Tm * D * m.nfeats)
    assert rep["vae_encode"]["flops"] == (
        2 * B * Tm * m.nfeats * D
        + work.encoder_flops(B, Tm + 2 * c.latent_size, D, F, nb))
    assert all(v["bytes_accessed"] is None for v in rep.values()
               if isinstance(v, dict) and "flops" in v)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_generate_feats_is_the_sum_of_its_parts(tiny_mld, monkeypatch,
                                                fused):
    monkeypatch.setenv("MLD_TPU_FUSED_DENOISER", fused)
    m = tiny_mld
    ids = torch.zeros((2, 77), dtype=torch.long)
    mask = lengths_to_mask([40, 40], m.max_frames, "cpu")
    parts = generate_parts(m, ids, mask, torch.Generator().manual_seed(0))
    assert parts["whole"] == parts_total(parts)
    assert parts["steps"] == 3
    assert (parts["sampler_preamble"] > 0) == (fused == "1")


def test_stage_counts_against_xla(assets, tiny_mld):
    """XLA's cost analysis of each loop-free stage counts the same products
    and the elementwise work besides, so the port's count lies below it:
    0.72 of XLA's for the denoiser step, 0.76 for the VAE decode and 0.90
    for the text tower at this tiny width on the CPU; the band held is
    0.55 to 1.0. (generate_feats is not compared: XLA counts the sampler's
    scan body once, the port every step.)"""
    from scripts.flops import analyze as xla
    m = tiny_mld
    jmld = JaxMLD(assets["jcfg"])
    params = jmld.init_params(jax.random.PRNGKey(0))
    B, T = 1, m.max_frames
    rep = port_flops.analyze(m, B, T)
    ids = jnp.zeros((B, 77), jnp.int32)
    mask = jax_lengths_to_mask(jnp.full((B,), T), T)
    sample = jnp.zeros((2 * B, m.latent_size, m.latent_dim))
    cond = jnp.zeros((2 * B, 1, m.cfg.model.text_encoded_dim))
    ref = {
        "denoiser_step": xla(lambda p, s, c_: jmld.denoise(
            p, s, jnp.asarray(500), c_), params, sample, cond),
        "vae_decode": xla(lambda p, z, mk: jmld.decode_latent(p, z, mk),
                          params, sample[:B], mask),
        "clip_text": xla(lambda p, i: jmld.encode_text_tokens(p, i), params,
                         ids),
    }
    for k in ("denoiser_step", "vae_decode", "clip_text"):
        ratio = rep[k]["flops"] / ref[k]["flops"]
        assert 0.55 <= ratio <= 1.0, (k, ratio)
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(params))
    assert rep["param_count"] == n_jax


# --------------------------------------------------------------------- tsne
def test_trajectory_matches_jax(assets, tiny_mld):
    from scripts.tsne import diffusion_reverse_trajectory as jax_traj
    m = tiny_mld
    jmld = JaxMLD(assets["jcfg"])
    from test_torch_train import jax_params_of
    params = jax_params_of(m)
    texts = ["a person walks forward", "a person jumps"]
    T = m.max_frames
    mask = jax_lengths_to_mask(jnp.full((2,), T), T)
    ids = jnp.asarray(jmld.tokenizer(texts))
    uncond = jnp.broadcast_to(jnp.asarray(jmld.tokenizer([""])), ids.shape)
    jcond = jmld.encode_text_tokens(params, jnp.concatenate([uncond, ids]))
    rng = jax.random.PRNGKey(0)
    ref = np.asarray(jax_traj(jmld, params, jcond, mask, rng))
    _, init_rng = jax.random.split(rng)
    init = np.asarray(jmld._init_latents(init_rng, 2, mask))
    cond = tsne.full_context_condition(m, texts)
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), atol=EMB_ATOL)
    out = tsne.diffusion_reverse_trajectory(
        m, cond, init_latents=torch.from_numpy(init.copy())).numpy()
    assert out.shape == ref.shape == (3, 2, 1, m.latent_dim)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= LATENT_RTOL * max(scale, 1.0)


def test_embeddings_equal_the_originals():
    import inspect
    from scripts import tsne as jax_tsne
    for name in ("pca_2d", "tsne_2d"):
        assert inspect.getsource(getattr(tsne, name)) == inspect.getsource(
            getattr(jax_tsne, name)), name
    x = np.random.RandomState(0).randn(40, 8)
    np.testing.assert_array_equal(tsne.pca_2d(x), jax_tsne.pca_2d(x))
    np.testing.assert_array_equal(tsne.tsne_2d(x, perplexity=5, iters=50),
                                  jax_tsne.tsne_2d(x, perplexity=5, iters=50))


def test_tsne_cli_writes_the_plot(assets, tmp_path):
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "t.png")
    traj, emb = tsne.main(["--device", "cpu", "--cfg", assets["yaml"],
                           "--method", "pca", "--out", png])
    assert os.path.getsize(png) > 0
    assert traj.shape == (3, 4, 1, 32) and emb.shape == (3, 4, 2)
    np.testing.assert_array_equal(emb, tsne.embed(traj, "pca"))


# ----------------------------------------------------------------- ablation
def test_ablation_report_has_jax_keys(tmp_path):
    work_dir = str(tmp_path / "e2e")
    assert train_synthetic_e2e.main([
        "--device", "cpu", "--steps", "3", "--clip-steps", "3",
        "--eval-steps", "3", "--samples", "440", "--skip-loop",
        "--skip-final-eval", "--workdir", work_dir, "--out",
        str(tmp_path / "e2e.json")]) == 0
    argv = ["--workdir", work_dir, "--steps", "2", "--bench-batch", "4",
            "--bench-iters", "1"]
    ours = ablate_ddim_steps.main(argv + ["--device", "cpu", "--out",
                                          str(tmp_path / "port.json")])
    assert _jax_main(jax_ablate_ddim_steps,
                     argv + ["--out", str(tmp_path / "jax.json")]) == 0
    ref = json.load(open(tmp_path / "jax.json"))
    assert set(ours) == set(ref)
    assert set(ours["arms"]) == set(ref["arms"]) == {"2"}
    assert set(ours["arms"]["2"]) == set(ref["arms"]["2"])
    assert ours["backend"] == ref["backend"] == "cpu"
    assert all(np.isfinite(v) for v in ours["arms"]["2"].values())


# ----------------------------------------------------------- carried copies
def _body(path):
    with open(path) as f:
        src = f.read()
    return src[src.index('"""', 3) + 3:]


ROOT2 = "os.path.dirname(os.path.dirname(os.path.abspath(__file__)))"
ROOT3 = ("os.path.dirname(os.path.dirname(os.path.dirname("
         "os.path.abspath(__file__))))")


@pytest.mark.parametrize("name", ["prepare_assets", "prepare_uestc"])
def test_carried_copies_equal_originals(name):
    """The copies differ from the originals only by the repository root's
    depth, the package and the drill's command."""
    orig = _body(os.path.join(REPO_ROOT, "scripts", f"{name}.py"))
    orig = (orig.replace(ROOT2, ROOT3).replace("mld_tpu.", "mld_tpu_torch.")
            .replace("python scripts/parity_drill.py",
                     "python -m mld_tpu_torch.scripts.parity_drill"))
    port = _body(os.path.join(REPO_ROOT, "mld_tpu_torch", "scripts",
                              f"{name}.py"))
    assert port == orig


def test_prepare_assets_verify_offline(monkeypatch, capsys):
    from mld_tpu_torch.scripts import prepare_assets
    monkeypatch.setattr(prepare_assets, "_have_network", lambda *a: False)
    monkeypatch.setattr(sys, "argv", ["prepare_assets", "--verify"])
    assert prepare_assets.main() == 0
    out = capsys.readouterr().out
    assert "readiness:" in out and "clip" in out
    assert prepare_assets.REPO == REPO_ROOT


def test_prepare_uestc_output_loads_in_the_port(tmp_path):
    from mld_tpu_torch.data.a2m import UestcDataset
    from mld_tpu_torch.scripts import prepare_uestc as pu
    raw, out = str(tmp_path / "raw"), str(tmp_path / "uestc")
    pu.fabricate_raw(raw, n_videos=20)
    path = pu.preprocess(raw, out)
    import pickle
    with open(path, "rb") as f:
        data = pickle.load(f)
    ds = UestcDataset(out, num_frames=32, split="train",
                      synthesize_if_missing=False)
    assert len(ds) == len(data["split"]["train"]) > 0
    item = ds[0]
    assert item["motion"].shape == (32, 150)
    assert 0 <= item["action"] < 40
    proc = _run(["-m", "mld_tpu_torch.scripts.prepare_uestc", "--selftest"])
    assert proc.returncode == 0 and "selftest ok" in proc.stdout
