"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``mld_tpu_torch/csrc/`` are compiled at first use, by
``nvcc`` for ``sm_90a``, one process a source, all started together, and
linked into one library in ``build/`` at the repository root. The library's
file name carries a hash of the sources and flags, so a stale build is never
loaded. Nothing here runs at import: the CPU tests import every module of the
port on machines without ``nvcc``. ``check_no_grad`` is the rule the
serving-only kernels' wrappers (K1, K2, K5) apply before they launch: they
have no backward. The attention wrappers (K3, K4) are differentiable
(``ops/attention.py``).
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # (x, out, skip scratch, 15 weight pointers, n_seq, S, D, H, F, n_block,
    #  seq_per_block, cluster, weight_bf16, stream)
    "mld_skip_encoder_forward": [_P] * 18 + [_I] * 9 + [_P],
    # (tgt, mem, valid, out, 20 weight pointers, ws, ws_bytes, B, T, M, D,
    #  H, F, n_block, weight_bf16, kernels launched (out), stream)
    "mld_skip_decoder_forward": ([_P] * 25 + [_L] + [_I] * 8
                                 + [ctypes.POINTER(_I), _P]),
    # (q, k, v, out, BH, S, Dh, sm_scale, bf16, stream)
    "mld_flash_causal_forward": [_P] * 4 + [_I] * 3 + [_F, _I, _P],
    # (q, k, v, valid or null, out, B, H, Sq, Sk, Dh, batch/head/row strides
    #  of q, k, v and out, sm_scale, arm (attention.FLASH_ARMS), stream)
    "mld_flash_forward": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _I, _P],
    # (x, w, b or null, y, M, N, K, stream)
    "mld_linear_bf16_forward": [_P] * 4 + [_I] * 3 + [_P],
}


def check_no_grad(what: str, *tensors):
    """A serving-only kernel has no backward: refuse inputs that autograd
    tracks rather than return an output cut off from their graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the {what} kernel has no backward; call it "
                           f"under torch.no_grad() or with inputs that do "
                           f"not require grad")


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ("-c", "-shared")).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmld_tpu_torch_{h.hexdigest()[:16]}.so"


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> dict:
    """Compile the kernel library unless a build of these sources exists.

    Returns {"path", "seconds", "built", "log"}; "log" holds nvcc's output
    (register and shared-memory use per kernel, from -Xptxas -v).
    """
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        sources = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, f"{s.stem}.o") for s in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                for o, s in zip(objs, sources)]
        with ThreadPoolExecutor(len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        lib = os.path.join(tmp, "lib.so")
        logs.append(_run([nvcc, "-shared", "-o", lib, *objs]))
        os.replace(lib, path)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "built": True, "log": "".join(logs)}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
