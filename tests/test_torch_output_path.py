"""The port's output path against the JAX package's, on the CPU: FBX export
(``mld_tpu_torch/export``, ``python -m mld_tpu_torch.scripts.fbx_export``),
``plys2npy``, the skeleton and mesh renders and ``python -m
mld_tpu_torch.render``, the demo CLI (``python -m mld_tpu_torch.demo``) in
each task, and the reference-checkpoint loader.

Bars: FBX files byte for byte equal, where both sides write the same numbers
(joints, the pkl tree's axis-angle poses); from a fit npz each side converts
rot6d to axis-angle itself, so the files are read back and their key values
held within 1e-4 (degrees, of rotations; centimetres, of translations).
Renders: the decoded images (PNG pixels, every GIF frame) exactly equal.
The CLIs: the same files in the same order (and for the demo the same
shapes and prompt txts). The reference checkpoint: the generated joints of
the two packages with the same weights and initial latents within
1e-4 x max(scale, 1).

The CLIs of both packages run in this process (``main(argv)``, or the JAX
scripts' ``main()`` under a patched ``sys.argv``).
"""
import argparse
import importlib.util
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from conftest import REPO_ROOT

import mld_tpu  # noqa: F401
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.export import read_fbx as jax_read_fbx
from mld_tpu.models.mld import MLD as JaxMLD
from mld_tpu.models.mld import lengths_to_mask as jax_lengths_to_mask
from mld_tpu.render import mesh as jax_mesh
from mld_tpu.render import skeleton as jax_skeleton
from mld_tpu.utils.checkpoint import (
    load_reference_checkpoint as jax_load_reference_checkpoint)

from mld_tpu_torch.config import load_config
from mld_tpu_torch.export import fbx as port_fbx
from mld_tpu_torch.fit import write_ply
from mld_tpu_torch.models.mld import MLD, lengths_to_mask
from mld_tpu_torch.render import mesh as port_mesh
from mld_tpu_torch.render import skeleton as port_skeleton
from mld_tpu_torch.utils.checkpoint import load_pretrained, model_state


def load_repo_module(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO_ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_cli(monkeypatch, relpath, argv):
    mod = load_repo_module(relpath, "jax_cli_" + os.path.basename(
        relpath)[:-3])
    monkeypatch.setattr(sys, "argv", [relpath] + list(argv))
    return mod.main()


def files_of(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def motion(T=12, J=22, seed=0):
    rng = np.random.RandomState(seed)
    return np.cumsum(0.05 * rng.randn(T, J, 3), 0).astype(np.float32)


# ------------------------------------------------------------ carried copies
def _code(path, redirect=False):
    """A module's source after its docstring (imports redirected)."""
    with open(path) as f:
        src = f.read()
    body = src[src.index('"""', 3) + 3:]
    return body.replace("mld_tpu.", "mld_tpu_torch.") if redirect else body


@pytest.mark.parametrize("relpath", ["export/fbx.py", "export/__init__.py",
                                     "render/mesh.py", "render/skeleton.py",
                                     "render/__init__.py"])
def test_carried_copies_equal_originals(relpath):
    orig = os.path.join(REPO_ROOT, "mld_tpu", relpath)
    port = os.path.join(REPO_ROOT, "mld_tpu_torch", relpath)
    if relpath.endswith("__init__.py"):
        assert open(port).read() == open(orig).read()
    else:
        assert _code(port) == _code(orig, redirect=True)


# ----------------------------------------------------------------------- FBX
@pytest.fixture
def fit_outputs(tmp_path):
    """A joints npy, its fit npz and its per-frame pkl tree, each in a
    directory per package (the same bytes in both)."""
    from mld_tpu_torch.fit import export_ply_pkl
    from mld_tpu_torch.ops.rotation import axis_angle_to_rotation_6d

    T = 10
    rng = np.random.RandomState(1)
    aa = np.cumsum(0.05 * rng.randn(T, 24, 3), 0).astype(np.float32)
    rot6d = axis_angle_to_rotation_6d(torch.from_numpy(aa)).numpy()
    trans = np.cumsum(0.02 * rng.randn(T, 3), 0).astype(np.float32)
    verts = rng.randn(T, 6, 3).astype(np.float32)
    dirs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        np.save(d / "walk_10_batch0_0.npy", motion(T))
        np.savez(d / "walk_10_batch0_0_fit.npz", rot6d=rot6d, trans=trans,
                 joints_fit=motion(T, 24))
        export_ply_pkl(str(d / "SMPLFit_walk"), verts,
                       {"rot6d": rot6d, "trans": trans}, None)
        dirs[side] = d
    return dirs


def test_fbx_export_cli_matches_jax(fit_outputs, monkeypatch):
    from mld_tpu_torch.scripts import fbx_export

    def argv(d):
        return ["--npy", str(d / "walk_10_batch0_0.npy"),
                "--npz", str(d / "walk_10_batch0_0_fit.npz"),
                "--pkl-dir", str(d / "SMPLFit_walk")]

    run_jax_cli(monkeypatch, "scripts/fbx_export.py", argv(fit_outputs["jax"]))
    written = fbx_export.main(argv(fit_outputs["port"]))
    names = ["walk_10_batch0_0.fbx", "walk_10_batch0_0_fit.fbx",
             "SMPLFit_walk.fbx"]
    assert [os.path.basename(p) for p in written] == names
    assert files_of(fit_outputs["port"]) == files_of(fit_outputs["jax"])
    for name in (names[0], names[2]):
        assert ((fit_outputs["port"] / name).read_bytes()
                == (fit_outputs["jax"] / name).read_bytes()), name

    def curves(path):
        return [np.asarray(n.props[0], np.float64) for n in nodes(
            port_fbx.read_fbx(str(path))[1], "KeyValueFloat")]

    out = curves(fit_outputs["port"] / names[1])
    ref = curves(fit_outputs["jax"] / names[1])
    assert len(out) == len(ref) > 24
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def nodes(roots, name):
    """Every node called `name` under `roots`, depth first."""
    out = []
    for n in roots:
        if n.name == name:
            out.append(n)
        out += nodes(n.children, name)
    return out


def as_tree(node):
    return (node.name, [p.tolist() if isinstance(p, np.ndarray) else p
                        for p in node.props],
            [as_tree(c) for c in node.children])


def test_fbx_reads_back_in_both_readers(tmp_path):
    """A skeleton from the port's writer reads back alike through both
    packages' readers: 22 bones, one key a frame."""
    parents = [-1] + [0] * 21
    path = str(tmp_path / "s.fbx")
    port_fbx.export_skeleton_fbx(path, motion(7), parents, fps=20.0)
    version, roots = port_fbx.read_fbx(path)
    jversion, jroots = jax_read_fbx(path)
    assert version == jversion == port_fbx.FBX_VERSION
    assert [as_tree(n) for n in roots] == [as_tree(n) for n in jroots]
    assert len(nodes(roots, "Model")) == 22
    assert {len(n.props[0]) for n in nodes(roots, "KeyTime")} == {7}


# ------------------------------------------------------------------ plys2npy
def test_plys2npy_matches_jax(tmp_path, monkeypatch):
    from mld_tpu_torch.scripts import plys2npy

    rng = np.random.RandomState(2)
    d = tmp_path / "SMPLFit_walk"
    d.mkdir()
    faces = rng.randint(0, 9, (5, 3))
    verts = rng.randn(4, 9, 3).astype(np.float32)
    for i, v in enumerate(verts):
        write_ply(str(d / f"motion_{i:04d}.ply"), v, faces)
    run_jax_cli(monkeypatch, "scripts/plys2npy.py",
                ["--dir", str(d), "--out", str(tmp_path / "jax.npy")])
    out = plys2npy.main(["--dir", str(d), "--out",
                         str(tmp_path / "port.npy")])
    a, b = np.load(out), np.load(tmp_path / "jax.npy")
    assert a.shape == (4, 9, 3) and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, verts, atol=1e-6, rtol=0)


# -------------------------------------------------------------------- render
def _pixels(path):
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(f.convert("RGBA")).copy()
                for f in ImageSequence.Iterator(im)]


def _same_image(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert len(pa) == len(pb) >= 1
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)


def make_mesh_seq(T=3, V=1200, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randn(V, 3).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    seq = np.stack([base * (1.0 + 0.1 * t) + [0.02 * t, 0, 0]
                    for t in range(T)]).astype(np.float32)
    return seq, rng.randint(0, V, (200, 3)).astype(np.int64)


@pytest.mark.parametrize("kind", ["skeleton_frame", "skeleton_sequence",
                                  "skeleton_animation", "mesh_frame",
                                  "mesh_sequence", "mesh_animation"])
def test_renders_match_jax(tmp_path, kind):
    joints = motion(4)
    seq, faces = make_mesh_seq()
    calls = {
        "skeleton_frame": lambda m, p: m.save_skeleton_frame(joints[2], p,
                                                             title="t"),
        "skeleton_sequence": lambda m, p: m.save_skeleton_sequence(
            joints, p, num=3),
        "skeleton_animation": lambda m, p: m.save_skeleton_animation(
            joints, p, fps=5),
        "mesh_frame": lambda m, p: m.save_mesh_frame(seq, p, faces,
                                                     exact_frame=0.5),
        "mesh_sequence": lambda m, p: m.save_mesh_sequence(seq, p, faces,
                                                           num=2),
        "mesh_animation": lambda m, p: m.save_mesh_animation(
            seq, p, faces, fps=4, downsample=1),
    }
    ext = ".gif" if kind.endswith("animation") else ".png"
    mods = ((jax_skeleton, port_skeleton) if kind.startswith("skeleton")
            else (jax_mesh, port_mesh))
    paths = [str(tmp_path / f"{side}{ext}") for side in ("jax", "port")]
    for mod, path in zip(mods, paths):
        calls[kind](mod, path)
    _same_image(*paths)


def test_render_cli_matches_render_py(tmp_path, monkeypatch, capsys):
    """A mixed directory (a mesh npy, a joints npy, a non-motion npy) in
    frame mode: the same files, mesh first, then the skip-if-rendered
    pass."""
    from mld_tpu_torch.render import __main__ as port_render

    seq, faces = make_mesh_seq()
    dirs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        np.save(d / "walk_mesh.npy", seq)
        np.save(d / "walk.npy", motion(5))
        np.save(d / "scalar.npy", np.zeros(3))
        np.save(tmp_path / "faces.npy", faces)
        dirs[side] = str(d)

    def argv(side):
        return ["--dir", dirs[side], "--mode", "frame", "--faces",
                str(tmp_path / "faces.npy")]

    def rendered(text, side):
        return [ln.replace(dirs[side], "D") for ln in text.splitlines()
                if ln.startswith(("rendered", "already", "skip"))]

    run_jax_cli(monkeypatch, "render.py", argv("jax"))
    ref = rendered(capsys.readouterr().out, "jax")
    pairs = port_render.main(argv("port"))
    out = rendered(capsys.readouterr().out, "port")
    assert out == ref and "walk_mesh" in out[0] and len(pairs) == 2
    assert files_of(dirs["port"]) == files_of(dirs["jax"])
    for name in ("walk_mesh.png", "walk.png"):
        _same_image(os.path.join(dirs["jax"], name),
                    os.path.join(dirs["port"], name))
    run_jax_cli(monkeypatch, "render.py", argv("jax"))
    ref = rendered(capsys.readouterr().out, "jax")
    assert port_render.main(argv("port")) == []
    out = rendered(capsys.readouterr().out, "port")
    assert out == ref and all(ln.startswith(("already", "skip"))
                              for ln in out)


# ---------------------------------------------------------------------- demo
TINY = {"model": {"latent_dim": 32, "ff_size": 64, "num_layers": 3,
                  "denoiser_num_layers": 3, "num_heads": 4,
                  "text_encoded_dim": 32, "clip_layers": 2, "clip_heads": 2,
                  "scheduler": {"num_inference_timesteps": 3}},
        "dataset": {"max_motion_len": 64, "min_motion_len": 16}}


@pytest.fixture(scope="module")
def demo_assets(tmp_path_factory):
    """Config files (YAML-readable JSON) of a tiny text model on a
    synthetic corpus and a tiny action model, an example file, and a
    feature npy to reconstruct."""
    import json

    from mld_tpu_torch.data.synthetic import build_synthetic_dataset

    root = tmp_path_factory.mktemp("demo")
    corpus = root / "humanml3d"
    build_synthetic_dataset(str(corpus), n_samples=12, seed=1)
    t2m = dict(TINY, dataset=dict(TINY["dataset"], root=str(corpus)))
    a2m = {"model": dict(TINY["model"]),
           "dataset": {"root": str(root / "humanact12")}}
    for name, cfg in (("t2m.yaml", t2m), ("a2m.yaml", a2m)):
        (root / name).write_text(json.dumps(cfg))
    (root / "example.txt").write_text(
        "32 a person walks forward\n\n24 someone jumps\n")
    feats = np.random.RandomState(3).randn(40, 263).astype(np.float32)
    np.save(root / "feats.npy", feats)
    return root


DEMO_TASKS = {
    "text_motion": lambda a: ["--cfg", str(a / "t2m.yaml"), "--example",
                              str(a / "example.txt"), "--replication", "2",
                              "--allinone"],
    "text_args": lambda a: ["--cfg", str(a / "t2m.yaml"), "--text",
                            "a man kicks", "someone waves", "--length",
                            "20", "99"],
    "action": lambda a: ["--cfg", str(a / "a2m.yaml"), "--task", "action",
                         "--action", "3", "7", "--length", "30", "60"],
    "random_sampling": lambda a: ["--cfg", str(a / "t2m.yaml"), "--task",
                                  "random_sampling", "--length", "16", "40",
                                  "--replication", "2"],
    "reconstruction": lambda a: ["--cfg", str(a / "t2m.yaml"), "--task",
                                 "reconstruction", "--motion",
                                 str(a / "feats.npy")],
}


@pytest.mark.parametrize("task", sorted(DEMO_TASKS))
def test_demo_cli_matches_demo_py(demo_assets, tmp_path, monkeypatch, task):
    from mld_tpu_torch import demo as port_demo

    argv = DEMO_TASKS[task](demo_assets)
    run_jax_cli(monkeypatch, "demo.py", argv + ["--out",
                                                str(tmp_path / "jax")])
    result = port_demo.main(argv + ["--out", str(tmp_path / "port"),
                                    "--device", "cpu"])
    names = files_of(tmp_path / "jax")
    assert files_of(tmp_path / "port") == names and names
    assert sorted(os.path.basename(f) for f in result["files"]) == sorted(
        n for n in names if n.endswith(".npy") and "allinone" not in n)
    for n in names:
        a, b = tmp_path / "port" / n, tmp_path / "jax" / n
        if n.endswith(".txt"):
            assert a.read_text() == b.read_text()
        else:
            x, y = np.load(a), np.load(b)
            assert x.shape == y.shape and x.dtype == y.dtype, n
            assert np.isfinite(x).all(), n
    if task == "text_motion":
        assert len(result["times"]) == 2
        assert np.load(tmp_path / "port" / "text_motion_allinone.npy"
                       ).shape == (2, 2, 32, 22, 3)


def test_demo_defaults_to_the_card(monkeypatch, demo_assets, tmp_path):
    from mld_tpu_torch import demo as port_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_demo.main(DEMO_TASKS["text_motion"](demo_assets)
                       + ["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# ------------------------------------------------ reference checkpoint loader
SMALL = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                   "denoiser_num_layers": 3, "num_heads": 4,
                   "text_encoded_dim": 48, "clip_layers": 2,
                   "clip_heads": 2, "clip_compute_dtype": "float32"},
         "dataset": {"max_motion_len": 40}}


def test_reference_checkpoint_loads_alike(tmp_path, monkeypatch):
    """A Lightning-style checkpoint in the reference's schema (vae.*,
    denoiser.* with emb_proj.1, denoiser.sequence_pos_encoding.pe, the
    frozen text_encoder.*, and hyper-parameters that are not tensors) of
    seeded arrays, loaded by both packages' loaders into models that start
    from the same weights; then the same prompts with the same initial
    latents."""
    monkeypatch.setenv("MLD_TPU_FUSED_DENOISER", "1")
    rng = np.random.RandomState(0)
    mean = (0.1 * rng.randn(263)).astype(np.float32)
    std = (0.5 + rng.rand(263)).astype(np.float32)
    jmld = JaxMLD(jax_load_config(preset="mld_humanml3d", overrides=SMALL),
                  mean=mean, std=std)
    params = jmld.init_params(jax.random.PRNGKey(0))
    tmld = MLD(load_config(preset="mld_humanml3d", overrides=SMALL),
               mean=mean, std=std, device="cpu")
    tmld.load_flax_params(jax.tree_util.tree_map(np.asarray, params))

    state = {k: torch.from_numpy((0.05 * rng.randn(*v.shape)).astype(
                 np.float32) + (1.0 if k.endswith("norm1.weight") else 0.0))
             for k, v in model_state(tmld).items()}
    assert any(k.startswith("denoiser.emb_proj.1.") for k in state)
    state["denoiser.sequence_pos_encoding.pe"] = torch.randn(500, 1, 64)
    state["text_encoder.text_model.final_layer_norm.weight"] = torch.ones(8)
    path = str(tmp_path / "mld_humanml3d.ckpt")
    torch.save({"state_dict": state, "epoch": 3, "global_step": 120,
                "hyper_parameters": {"cfg": argparse.Namespace(lr=1e-4)}},
               path)

    jparams = jax_load_reference_checkpoint(path, params)
    tops = load_pretrained(tmld, path)
    tmld.drop_stacks()
    assert list(tops) == ["denoiser", "vae"]
    own = tmld.state_dict()
    for k, v in state.items():
        if k in own:
            assert torch.equal(own[k], v), k

    texts = ["a man kicks something", "someone jumps"]
    lengths = [40, 27]
    ids = tmld.tokenize(texts)
    mask = jax_lengths_to_mask(jnp.asarray(lengths), jmld.max_frames)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jmld.generate_joints(jparams, jnp.asarray(ids.numpy()),
                                          mask, key))
    _, init_rng = jax.random.split(key)
    init = np.asarray(jmld._init_latents(init_rng, len(texts), mask))
    out = tmld.generate_joints(ids, lengths_to_mask(lengths, 40, "cpu"),
                               init_latents=torch.from_numpy(init.copy())
                               ).numpy()
    assert out.shape == ref.shape == (2, 40, 22, 3)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-4 * max(scale, 1.0)
    # and a port checkpoint (.pt, told apart by its contents) still loads
    from mld_tpu_torch.utils.checkpoint import CheckpointManager
    CheckpointManager(str(tmp_path / "ckpts")).save(5, tmld)
    assert sorted(load_pretrained(
        tmld, str(tmp_path / "ckpts" / "5.pt"))) == ["denoiser", "vae"]


class ConfigObject:
    """A pickled config object, as a released checkpoint's hyper-parameters
    may be: neither a tensor nor a container, so unpickling it runs code."""
    lr = 1e-4


@pytest.mark.parametrize("hparams", ["namespace", "config_object"])
def test_checkpoint_loads_weights_only_unless_trusted(tmp_path, hparams):
    """Every checkpoint file is loaded weights-only: an argparse.Namespace
    among its hyper-parameters loads, another object raises unless the
    caller trusts the file."""
    model = torch.nn.Module()
    model.vae = torch.nn.Linear(3, 2)
    state = {f"vae.{k}": torch.randn_like(v)
             for k, v in model.vae.state_dict().items()}
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": state, "hyper_parameters":
                argparse.Namespace(lr=1e-4) if hparams == "namespace"
                else ConfigObject()}, path)
    if hparams == "config_object":
        import pickle

        with pytest.raises(pickle.UnpicklingError, match="trust"):
            load_pretrained(model, path)
        assert not torch.equal(model.vae.weight, state["vae.weight"])
    assert list(load_pretrained(model, path, trust=hparams != "namespace")
                ) == ["vae"]
    assert torch.equal(model.vae.weight, state["vae.weight"])


@pytest.mark.parametrize("trusted", [False, True])
def test_demo_checkpoint_needs_trust_for_objects(demo_assets, tmp_path,
                                                 trusted):
    """The demo's --checkpoint on a reference-style file whose
    hyper-parameters are a config object: refused, or with
    --trust_checkpoint loaded and run."""
    import pickle

    from mld_tpu_torch import demo as port_demo
    from mld_tpu_torch.data.datamodule import get_datamodule

    cfg = load_config(str(demo_assets / "t2m.yaml"), None,
                      preset="mld_humanml3d")
    dm = get_datamodule(cfg)
    mld = MLD(cfg, mean=dm.mean, std=dm.std, device="cpu",
              generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": model_state(mld),
                "hyper_parameters": ConfigObject()}, path)
    argv = DEMO_TASKS["text_args"](demo_assets) + [
        "--checkpoint", path, "--out", str(tmp_path / "out"), "--device",
        "cpu"]
    if not trusted:
        with pytest.raises(pickle.UnpicklingError, match="trust"):
            port_demo.main(argv)
        assert not (tmp_path / "out").exists()
        return
    result = port_demo.main(argv + ["--trust_checkpoint"])
    # 99 frames are cut to the tiny model's 64
    assert [np.load(f).shape for f in result["files"]] == [(20, 22, 3),
                                                           (64, 22, 3)]
