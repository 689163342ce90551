"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``mld_tpu_torch/csrc/`` are compiled at first use, by
``nvcc`` for ``sm_90a``, into ``build/`` at the repository root. The library's
file name carries a hash of the sources and flags, so a stale build is never
loaded. Nothing here runs at import: the CPU tests import every module of the
port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# mld_skip_encoder_forward(x, out, 15 weight pointers, n_seq, S, D, H, F,
#                          n_block, seq_per_block, weight_bf16, stream)
_SIGNATURES = {
    "mld_skip_encoder_forward": [_P] * 17 + [_I] * 8 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmld_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernel library unless a build of these sources exists.

    Returns {"path", "seconds", "built", "log"}; "log" holds nvcc's output
    (register and shared-memory use per kernel, from -Xptxas -v).
    """
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "built": True, "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
