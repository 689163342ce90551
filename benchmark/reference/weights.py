"""Random weights from a seed, made on the device in a few large draws, by
the reference torch names of the served model.

Families: lecun-normal 2-D weights (std 1/sqrt(fan_in)); xavier-uniform
packed attention projections, motion tokens and action table; normal 0.02
token embeddings and text projection, 0.01 text positions, 1 for the ACTOR
mu / logvar tokens; uniform [0, 1) learned PE tables; LayerNorm scales 1 +
normal 0.02; biases normal 0.02 (not zero, so that a kernel that drops a
bias or a LayerNorm shift shows).
"""
from __future__ import annotations

import hashlib

import torch

NORMAL, UNIFORM = "normal", "uniform"


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def family(name: str, shape) -> tuple:
    """(draw, scale, shift) of one tensor: value = draw * scale + shift,
    draw N(0, 1) or U[-1, 1)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "pe":
        return UNIFORM, 0.5, 0.5
    if "token_embedding" in name or "text_projection" in name:
        return NORMAL, 0.02, 0.0
    if "position_embedding" in name:
        return NORMAL, 0.01, 0.0
    if leaf in ("mu_token", "logvar_token"):
        return NORMAL, 1.0, 0.0
    if leaf in ("in_proj_weight", "global_motion_token", "action_embedding"):
        return UNIFORM, (6.0 / (shape[0] + shape[1])) ** 0.5, 0.0
    if leaf == "weight" and len(shape) == 2:
        return NORMAL, shape[1] ** -0.5, 0.0
    if leaf == "weight":
        return NORMAL, 0.02, 1.0
    return NORMAL, 0.02, 0.0


def make(shapes: dict, seed: int, device) -> dict:
    """{name: shape} -> {name: f32 tensor on `device`}: one normal and one
    uniform draw for all of them, from a generator on the device."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, "weights"))
    fams = {n: family(n, s) for n, s in shapes.items()}
    sizes = {n: int(torch.Size(s).numel()) for n, s in shapes.items()}
    total = {k: sum(sizes[n] for n in shapes if fams[n][0] == k)
             for k in (NORMAL, UNIFORM)}
    pool = {NORMAL: torch.randn(total[NORMAL], generator=g, device=device),
            UNIFORM: torch.rand(total[UNIFORM], generator=g, device=device)
            * 2.0 - 1.0}
    offset = dict.fromkeys(pool, 0)
    out = {}
    for n, s in shapes.items():
        kind, scale, shift = fams[n]
        flat = pool[kind][offset[kind]: offset[kind] + sizes[n]]
        offset[kind] += sizes[n]
        out[n] = (flat * scale + shift).reshape(s)
    return out
