"""ctypes binding and build of the C++ batch loader (the twin of
``mld_tpu/native/batch_loader.py``).

``loader.cc`` is compiled with ``g++`` at first use into ``build/`` at the
repository root, not into the package tree. The library's file name carries
a hash of the source and the flags, as ``ops/_build.py`` names the CUDA
library, so a stale build is never loaded; a build writes a temporary file
and renames it, so processes that build at once never load a half-written
one. ``get_native_loader()`` returns None when the library cannot be built
or loaded, and ``build_error()`` then says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libmldloader_{h.hexdigest()[:16]}.so"


def _build(path: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{proc.stderr.strip()}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_native_loader():
    """The loaded library, built if needed; None if it cannot be built or
    loaded (the failure is kept: ``build_error``)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.mld_load_batch.restype = ctypes.c_int
        lib.mld_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.mld_read_npy_header.restype = ctypes.c_int
        lib.mld_read_npy_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long)]
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    return _error


class NativeBatchLoader:
    """Assemble normalized padded motion batches straight from npy files:
    the crop / normalize / pad loop runs in C++ threads writing into the
    output buffer."""

    def __init__(self, mean: np.ndarray, std: np.ndarray, max_len: int,
                 num_threads: int = 8):
        self.lib = get_native_loader()
        if self.lib is None:
            raise RuntimeError(f"native loader unavailable: {build_error()}")
        self.mean = np.ascontiguousarray(mean, np.float32)
        self.std = np.ascontiguousarray(std, np.float32)
        self.nfeats = len(self.mean)
        self.max_len = max_len
        self.num_threads = num_threads

    def npy_shape(self, path: str):
        rows = ctypes.c_long()
        cols = ctypes.c_long()
        rc = self.lib.mld_read_npy_header(path.encode(), ctypes.byref(rows),
                                          ctypes.byref(cols))
        if rc != 0:
            raise IOError(f"bad npy {path} (rc={rc})")
        return int(rows.value), int(cols.value)

    def load(self, paths: Sequence[str], starts: Sequence[int],
             crops: Sequence[int]):
        """[n, max_len, nfeats] f32 motion (rows start .. start + crop of
        each file, z-normalized, zero past the crop) and [n] int32
        lengths."""
        n = len(paths)
        if not len(starts) == len(crops) == n:
            raise ValueError(f"{n} paths, {len(starts)} starts, "
                             f"{len(crops)} crops")
        motion = np.zeros((n, self.max_len, self.nfeats), np.float32)
        lengths = np.zeros(n, np.int32)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        c_starts = np.ascontiguousarray(starts, np.int32)
        c_crops = np.ascontiguousarray(crops, np.int32)
        rc = self.lib.mld_load_batch(
            c_paths, n,
            c_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            c_crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            self.max_len,
            self.mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.nfeats,
            motion.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            self.num_threads)
        if rc != 0:
            raise IOError("native batch load failed")
        return motion, lengths
