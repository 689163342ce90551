#!/usr/bin/env python3
"""Drive the PyTorch port (mld_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: require CUDA; print the nvidia-smi name/power-limit line and the
     TF32 settings of the run;
  2. build: compile the CUDA kernels from mld_tpu_torch/csrc/ with nvcc for
     sm_90a and print the build time and ptxas resource lines;
  3. kernel vs plain: the skip-encoder kernel against its plain PyTorch
     version at the flagship denoiser shapes (S=3, D=256, H=4, F=1024, L=9),
     f32 and bf16 weights, with times;
  4. main path: MLD for the mld_humanml3d preset at full width from seeded
     random weights answers the prompts of demo/example.txt through
     MLD.generate, then one generate_joints at B=128; checks shapes,
     finiteness, masking and 50 kernel launches per call; then holds the
     card's joints for one prompt against the same model run on the CPU
     (plain versions, f32 text tower);
  5. prints the kernels JSON line, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
Needs one card, imports nothing of JAX, and builds into build/.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

SEED = 0
# flagship denoiser stack (mld_humanml3d): S tokens [z; t; text]
S, D, H, FF, N_LAYERS = 3, 256, 4, 1024, 9
N_BLOCK = (N_LAYERS - 1) // 2
B_LARGE = 128
# sequences per call: B=1 and B=128 under CFG, plus counts that leave a
# ragged last tile (the wrapper packs 2 and 5 sequences a block there)
KERNEL_SEQS = (2, 2 * B_LARGE, 201, 1001)
F32_ATOL = 1e-4
# bf16 weights: kernel and plain version both round weights and the
# activation operand to bf16 and accumulate exact products in f32, so they
# differ only where f32 summation order flips the bf16 rounding of an
# activation (one flip moves a product by 2^-8 of that operand) and nine
# layers carry the flips on. The bf16 stack is that sensitive by itself: a
# 1e-7 relative perturbation of its input moves the plain version's output
# by up to 1.9e-2 at these weights (B=128, on the CPU), against 4e-6 for
# f32 weights. 5e-2 leaves room for that and still fails a wrong weight,
# layout or rounding, which moves outputs of scale ~4 by O(1)
BF16_ATOL = 5e-2
# card (kernel, bf16-free f32 path) vs CPU (plain versions) joints after 50
# CFG steps: f32 summation order on two devices, the end-to-end bar of
# tests/test_full_sampler_parity.py
E2E_RTOL = 1e-3


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    smi = nvidia_smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[device] tf32: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")
    return smi


def phase_build():
    from mld_tpu_torch.ops import _build

    info = _build.build()
    log(f"[build] {'built' if info['built'] else 'found'} {info['path']} "
        f"in {info['seconds']:.1f} s (nvcc sm_90a)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    _build.library()


def _time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(torch, encoder):
    """K1 vs its plain version on the main path's weights."""
    from mld_tpu_torch.ops.fused_layer import (skip_encoder_stack,
                                               skip_encoder_stack_plain,
                                               stack_skip_encoder)

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    results = {}
    for wname, wdt, atol in (("f32", torch.float32, F32_ATOL),
                             ("bf16", torch.bfloat16, BF16_ATOL)):
        st = stack_skip_encoder(encoder, wdt)
        for n_seq in KERNEL_SEQS:
            x = torch.randn(n_seq, S, D, device=DEVICE, generator=g)
            out = skip_encoder_stack(x, st, N_BLOCK, H)
            torch.cuda.synchronize()
            ref = skip_encoder_stack_plain(x, st, N_BLOCK, H)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError(f"kernel gave non-finite output "
                                   f"({wname}, {n_seq} seqs)")
            err = (out - ref).abs().max().item()
            ms = _time_ms(torch, lambda: skip_encoder_stack(x, st, N_BLOCK, H))
            plain_ms = _time_ms(
                torch, lambda: skip_encoder_stack_plain(x, st, N_BLOCK, H))
            log(f"[kernel] skip_encoder {wname} seqs={n_seq} rows="
                f"{n_seq * S} max_abs_err={err:.3e} (atol {atol:g}) "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            if not err <= atol:
                raise RuntimeError(f"kernel disagrees with plain version: "
                                   f"{err:.3e} > {atol:g} ({wname}, "
                                   f"{n_seq} seqs)")
            results[(wname, n_seq)] = (err, ms, plain_ms)
    return results


def _demo_prompts():
    texts, lengths = [], []
    with open(os.path.join(REPO, "demo", "example.txt")) as f:
        for line in f:
            s = line.strip()
            if s:
                head = s.split(" ")[0]
                lengths.append(int(head))
                texts.append(s[len(head) + 1:])
    return texts, lengths


def _check_joints(torch, joints, mask, shape):
    if tuple(joints.shape) != shape:
        raise RuntimeError(f"joints shape {tuple(joints.shape)} != {shape}")
    if not torch.isfinite(joints).all():
        raise RuntimeError("non-finite joints")
    outside = joints[~mask]
    if outside.numel() and outside.abs().max().item() != 0.0:
        raise RuntimeError("joints are not zero outside the mask")


def phase_main_path(torch):
    import numpy as np

    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.models.mld import MLD, lengths_to_mask
    from mld_tpu_torch.ops import fused_layer

    cfg = load_config(preset="mld_humanml3d")
    m = cfg.model
    log(f"[main] mld_humanml3d: CLIP {m.clip_layers}x{m.text_encoded_dim} "
        f"{m.clip_compute_dtype}, denoiser {m.denoiser_num_layers}x"
        f"{m.latent_dim}, VAE {m.num_layers}x{m.latent_dim}, "
        f"{cfg.dataset.max_motion_len} frames, DDIM-"
        f"{m.scheduler.num_inference_timesteps}, CFG {m.guidance_scale}")
    t0 = time.perf_counter()
    mld = MLD(cfg, device=DEVICE,
              generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"[main] built MLD on {DEVICE} in {time.perf_counter() - t0:.1f} s")
    n_steps = len(mld.scheduler.timesteps())
    kernel_results = phase_kernels(torch, mld.denoiser.encoder)

    # prompts of demo/example.txt through MLD.generate
    texts, lengths = _demo_prompts()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    fused_layer.LAUNCHES = 0
    t0 = time.perf_counter()
    motions = mld.generate(texts, lengths, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_demo = fused_layer.LAUNCHES
    if launches_demo != n_steps:
        raise RuntimeError(f"generate launched the kernel {launches_demo} "
                           f"times, expected {n_steps}")
    for motion, n in zip(motions, lengths):
        if motion.shape != (n, mld.njoints, 3) or not np.isfinite(motion).all():
            raise RuntimeError(f"bad motion {motion.shape} for length {n}")
    log(f"[main] generate: {len(texts)} prompts in {wall:.3f} s (first call), "
        f"{launches_demo} kernel launches, shapes "
        f"{[tuple(x.shape) for x in motions]}")

    # one batch of B=128 through generate_joints
    reps = -(-B_LARGE // len(texts))
    btexts = (texts * reps)[:B_LARGE]
    blengths = (lengths * reps)[:B_LARGE]
    ids = mld.tokenize(btexts)
    mask = lengths_to_mask(blengths, mld.max_frames, mld.device)
    fused_layer.LAUNCHES = 0
    t0 = time.perf_counter()
    joints = mld.generate_joints(ids, mask, generator=gen)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = fused_layer.LAUNCHES
    if launches_b != n_steps:
        raise RuntimeError(f"generate_joints launched the kernel "
                           f"{launches_b} times, expected {n_steps}")
    _check_joints(torch, joints, mask,
                  (B_LARGE, mld.max_frames, mld.njoints, 3))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mld.generate_joints(ids, mask, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[1]
    log(f"[main] generate_joints B={B_LARGE}: first {wall_b:.4f} s, then "
        f"{', '.join(f'{t:.4f}' for t in times)} s (median {med:.4f} s, "
        f"{B_LARGE / med:.1f} motions/s), {launches_b} kernel launches")

    phase_reference(torch, cfg, texts[0], lengths[0])
    return kernel_results, launches_b, med


def phase_reference(torch, cfg, text, length):
    """One prompt on the card (kernel) and on the CPU (plain versions),
    same weights and initial noise, f32 text tower on both."""
    from mld_tpu_torch.config.core import config_from_dict, merge_dicts
    from mld_tpu_torch.config.core import config_to_dict
    from mld_tpu_torch.models.mld import MLD, lengths_to_mask

    cfg32 = config_from_dict(merge_dicts(
        config_to_dict(cfg), {"model": {"clip_compute_dtype": "float32"}}))
    out = {}
    init = torch.randn(1, cfg.model.latent_size, cfg.model.latent_dim,
                       generator=torch.Generator().manual_seed(SEED + 3))
    for dev in (DEVICE, "cpu"):
        mld = MLD(cfg32, device=dev,
                  generator=torch.Generator().manual_seed(SEED))
        mask = lengths_to_mask([length], mld.max_frames, mld.device)
        out[dev] = mld.generate_joints(mld.tokenize([text]), mask,
                                       init_latents=init).cpu()
        del mld
    scale = out["cpu"].abs().max().item()
    err = (out[DEVICE] - out["cpu"]).abs().max().item()
    log(f"[reference] card vs CPU joints, one prompt: max_abs_err "
        f"{err:.3e} (scale {scale:.3e}, bar {E2E_RTOL:g} x max(scale, 1))")
    if not err <= E2E_RTOL * max(scale, 1.0):
        raise RuntimeError("card joints disagree with the CPU reference")


def main():
    import torch

    smi = phase_device(torch)
    if not os.path.isdir(os.path.join(REPO, "mld_tpu_torch")):
        raise RuntimeError(f"no mld_tpu_torch package beside {__file__}: run "
                           f"chip_smoke.py from a checkout of the repo")
    sys.path.insert(0, REPO)
    phase_build()
    kernel_results, launches, _ = phase_main_path(torch)
    err_f32 = max(v[0] for k, v in kernel_results.items() if k[0] == "f32")
    err_bf16 = max(v[0] for k, v in kernel_results.items() if k[0] == "bf16")
    _, ms, plain_ms = kernel_results[("f32", 2 * B_LARGE)]
    _, ms16, plain16 = kernel_results[("bf16", 2 * B_LARGE)]
    log(json.dumps({"kernels": [{
        "name": "skip_encoder", "route": "cuda",
        "source": "mld_tpu_torch/csrc/skip_encoder.cu",
        "replaces": "mld_tpu/ops/fused_layer.py:202",
        "launches": launches, "max_abs_err": err_f32,
        "ms": ms, "plain_ms": plain_ms,
        "bf16_max_abs_err": err_bf16, "bf16_ms": ms16,
        "bf16_plain_ms": plain16}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
