"""A reader of ``.safetensors`` files that needs only torch.

The format: an 8-byte little-endian header length N, N bytes of a JSON
header mapping each tensor's name to its ``dtype``, ``shape`` and
``data_offsets`` [begin, end) into the byte buffer that follows (plus an
optional ``__metadata__`` entry of strings), then that buffer, row-major
and little-endian. The JAX package reads an HF CLIP clone's
``model.safetensors`` through the ``safetensors`` package
(``mld_tpu/models/clip_text.py:287``); the port reads it here, so that it
needs no package beyond torch. Only the dtypes a CLIP clone or a
checkpoint holds are read; any other raises.
"""
from __future__ import annotations

import json
import struct
import sys
from typing import Dict

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64}
# a header larger than this is not a safetensors file (the format's limit)
MAX_HEADER = 100 * 1024 * 1024


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, on the CPU, in its stored dtype and shape
    (each a copy: nothing refers to the file's bytes afterwards)."""
    if sys.byteorder != "little":
        raise RuntimeError("the safetensors reader takes a little-endian "
                           "host")
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw[:8])
    if n > MAX_HEADER or 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} does not fit the file "
                         f"of {len(raw)} bytes")
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    buf = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}; this reader takes "
                             f"{sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        count = 1
        for s in shape:
            count *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or end > len(buf):
            raise ValueError(f"{path}: tensor {name} spans bytes "
                             f"[{begin}, {end}) for {count} x {itemsize} "
                             f"of a {len(buf)}-byte buffer")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(bytearray(buf[begin:end]),
                                     dtype=dtype).reshape(shape)
    return out
