"""The port's C++ batch loader (``mld_tpu_torch/native``) and its data path
vs the JAX package's, on the CPU with ``g++`` (skipped without a
toolchain, as the JAX package's own tests are).

- ``loader.cc`` is a carried copy of ``mld_tpu/native/loader.cc``: equal
  below its header comment; the lazy dataset is a carried copy of JAX's.
- ``NativeBatchLoader`` gives JAX's batches bit for bit on seeded npy files
  (f4 and f8, crops that end at a file's last row), and raises on a bad
  file.
- The port's native data module gives JAX's native data module's batches
  and the port's numpy path's for one seed: lengths, masks and texts
  equal, motion within 1e-5 (JAX's bar, tests/test_native_pipeline.py).
- Where the loader cannot be built the data module keeps the numpy
  collator and logs the build error.
- A clip holding a NaN raises through either collator, naming the clip.
"""
import inspect
import logging
import os
import re

import numpy as np
import pytest

import mld_tpu.native
from mld_tpu.config import load_config as jax_load_config
from mld_tpu.data import dataset as jdataset
from mld_tpu.data.datamodule import get_datamodule as jax_get_datamodule
from mld_tpu.native import NativeBatchLoader as JaxNativeBatchLoader
from mld_tpu.native import get_native_loader as jax_get_native_loader

from mld_tpu_torch.config import load_config
from mld_tpu_torch.data import dataset
from mld_tpu_torch.data.collate import MldCollator, NativeMldCollator
from mld_tpu_torch.data.datamodule import get_datamodule
from mld_tpu_torch.data.synthetic import build_synthetic_dataset
from mld_tpu_torch.native import NativeBatchLoader, batch_loader

MOTION_ATOL = 1e-5
NFEATS = 12


@pytest.fixture(scope="module")
def toolchain():
    if batch_loader.get_native_loader() is None:
        pytest.skip(f"no C++ toolchain: {batch_loader.build_error()}")
    if jax_get_native_loader() is None:
        pytest.skip("the JAX package's loader cannot be built")


@pytest.fixture(scope="module")
def npy_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("npys_torch")
    rng = np.random.RandomState(0)
    for i, t in enumerate((50, 33, 200)):
        np.save(d / f"{i}.npy", rng.randn(t, NFEATS).astype(np.float32))
    np.save(d / "f64.npy", rng.randn(20, NFEATS))   # float64: converted
    return d


def _body(path):
    """A C++ source below its header comment."""
    with open(path) as f:
        return re.sub(r"\A(//[^\n]*\n)+", "", f.read())


def test_loader_source_is_a_carried_copy():
    jax_src = os.path.join(os.path.dirname(mld_tpu.native.__file__),
                           "loader.cc")
    assert _body(batch_loader.SRC) == _body(jax_src)
    assert (inspect.getsource(dataset.Text2MotionDatasetLazy)
            == inspect.getsource(jdataset.Text2MotionDatasetLazy))


def test_library_name_carries_the_source_hash(toolchain):
    path = batch_loader.library_path()
    assert path.parent == batch_loader.BUILD_DIR and path.exists()
    assert re.fullmatch(r"libmldloader_[0-9a-f]{16}\.so", path.name)


def test_header_parse(toolchain, npy_dir):
    loader = NativeBatchLoader(np.zeros(NFEATS), np.ones(NFEATS), 64)
    assert loader.npy_shape(str(npy_dir / "0.npy")) == (50, NFEATS)
    assert loader.npy_shape(str(npy_dir / "f64.npy")) == (20, NFEATS)


def test_batches_equal_jax_bit_for_bit(toolchain, npy_dir):
    rng = np.random.RandomState(1)
    mean = rng.randn(NFEATS).astype(np.float32)
    std = (np.abs(rng.randn(NFEATS)) + 0.5).astype(np.float32)
    paths = [str(npy_dir / f"{i}.npy") for i in range(3)] + [
        str(npy_dir / "f64.npy")]
    # the second crop ends at its file's last row, the fourth at the f8
    # file's; the third is cut to max_len
    starts, crops = [5, 13, 100, 4], [40, 20, 80, 16]
    motion, lengths = NativeBatchLoader(mean, std, 64).load(paths, starts,
                                                            crops)
    jmotion, jlengths = JaxNativeBatchLoader(mean, std, 64).load(
        paths, starts, crops)
    assert motion.dtype == jmotion.dtype == np.float32
    np.testing.assert_array_equal(motion, jmotion)
    np.testing.assert_array_equal(lengths, jlengths)
    np.testing.assert_array_equal(lengths, [40, 20, 64, 16])
    for i, (p, s, n) in enumerate(zip(paths, starts, lengths)):
        want = (np.load(p).astype(np.float32)[s:s + n] - mean) / std
        np.testing.assert_allclose(motion[i, :n], want, rtol=0, atol=1e-6)
        assert not motion[i, n:].any()


@pytest.mark.parametrize("path, start, crop", [
    ("missing.npy", 0, 10), ("0.npy", 45, 10), ("not_npy.npy", 0, 4)])
def test_bad_file_raises(toolchain, npy_dir, path, start, crop):
    (npy_dir / "not_npy.npy").write_bytes(b"not an npy file at all")
    loader = NativeBatchLoader(np.zeros(NFEATS), np.ones(NFEATS), 64)
    with pytest.raises(IOError):
        loader.load([str(npy_dir / path)], [start], [crop])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_native_torch")
    build_synthetic_dataset(str(root), n_samples=24, seed=2)
    return str(root)


def _over(root, native):
    return {"debug": True,
            "dataset": {"root": root, "max_motion_len": 64,
                        "min_motion_len": 16, "native_loader": native},
            "train": {"batch_size": 6}}


def _items(ds, seed):
    ds.rng = np.random.RandomState(seed)
    return [ds[i] for i in range(min(len(ds), 6))]


@pytest.mark.parametrize("split", ["train", "test"])
def test_native_datamodule_equals_jax_and_numpy(toolchain, corpus, split):
    dm = get_datamodule(load_config(preset="mld_humanml3d",
                                    overrides=_over(corpus, True)))
    dm_np = get_datamodule(load_config(preset="mld_humanml3d",
                                       overrides=_over(corpus, False)))
    jdm = jax_get_datamodule(jax_load_config(
        preset="mld_humanml3d", overrides=_over(corpus, True)))
    assert dm.use_native and jdm.use_native and not dm_np.use_native
    assert isinstance(dm.collate, NativeMldCollator)
    assert isinstance(dm.dataset(split), dataset.Text2MotionDatasetLazy)
    assert isinstance(dm_np.collate, MldCollator)
    ref = jdm.collate(_items(jdm.dataset(split), 7))
    for b in (dm.collate(_items(dm.dataset(split), 7)),
              dm_np.collate(_items(dm_np.dataset(split), 7))):
        np.testing.assert_array_equal(b["length"], ref["length"])
        np.testing.assert_array_equal(b["mask"], ref["mask"])
        assert b["text"] == ref["text"]
        np.testing.assert_allclose(b["motion"], ref["motion"], rtol=0,
                                   atol=MOTION_ATOL)
        if split == "test":     # the evaluators' word features
            np.testing.assert_array_equal(b["word_embs"], ref["word_embs"])
            np.testing.assert_array_equal(b["text_len"], ref["text_len"])


def test_loaders_of_both_collators_give_one_stream(toolchain, corpus):
    """Whole epochs of the shuffled train loader, native against numpy:
    the lazy dataset draws its captions and crops in the eager one's
    order."""
    kw = dict(seed=3, drop_last=True, prefetch=2)
    native = get_datamodule(load_config(
        preset="mld_humanml3d", overrides=_over(corpus, True)))
    numpy_ = get_datamodule(load_config(
        preset="mld_humanml3d", overrides=_over(corpus, False)))
    a, b = native.loader("train", **kw), numpy_.loader("train", **kw)
    n = 0
    for _ in range(2):
        for x, y in zip(a, b, strict=True):
            assert x["text"] == y["text"]
            np.testing.assert_array_equal(x["length"], y["length"])
            np.testing.assert_allclose(x["motion"], y["motion"], rtol=0,
                                       atol=MOTION_ATOL)
            n += 1
    assert n >= 2


def test_unbuildable_loader_falls_back_and_says_why(corpus, monkeypatch,
                                                    caplog):
    monkeypatch.setattr(batch_loader, "_lib", None)
    monkeypatch.setattr(batch_loader, "_error", "RuntimeError: g++ failed")
    with caplog.at_level(logging.INFO, "mld_tpu_torch.data.datamodule"):
        dm = get_datamodule(load_config(preset="mld_humanml3d",
                                        overrides=_over(corpus, True)))
    assert not dm.use_native and isinstance(dm.collate, MldCollator)
    assert not isinstance(dm.dataset("train"),
                          dataset.Text2MotionDatasetLazy)
    assert "numpy collator" in caplog.text and "g++ failed" in caplog.text
    batch = next(iter(dm.loader("train", prefetch=0, drop_last=True)))
    assert batch["motion"].shape == (6, 64, dm.nfeats)


@pytest.mark.parametrize("native", [True, False])
def test_nan_clip_raises_through_either_collator(toolchain, tmp_path,
                                                 native):
    build_synthetic_dataset(str(tmp_path), n_samples=24, seed=2)
    motions = tmp_path / "new_joint_vecs"
    bad = sorted(motions.glob("*.npy"))[0]
    clip = np.load(bad)
    np.save(bad, np.full_like(clip, np.nan))
    dm = get_datamodule(load_config(preset="mld_humanml3d",
                                    overrides=_over(str(tmp_path), native)))
    assert dm.use_native == native
    with pytest.raises(ValueError, match=f"nan in motion .*{bad.stem}"):
        for split in ("train", "val", "test"):
            for _ in dm.loader(split, shuffle=False, prefetch=0):
                pass
