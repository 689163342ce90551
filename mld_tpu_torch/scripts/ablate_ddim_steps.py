"""DDIM step-count ablation: quality against sampling cost (the twin of
``scripts/ablate_ddim_steps.py``).

On the model a ``python -m mld_tpu_torch.scripts.train_synthetic_e2e``
run trained (its workdir: ``cfg.json``, ``trained_params.npz``,
``t2m_eval_params.npz``, ``data/``), for each step count: the metric
protocol over the test split (``Evaluator.run_split``: FID, R-precision,
Matching, Diversity through the trained evaluator bundle) and the
throughput of ``generate_joints`` at ``--bench-batch`` prompts, timed
between two clock reads each after a synchronisation of the device.

    python -m mld_tpu_torch.scripts.train_synthetic_e2e --workdir /tmp/e2e
    python -m mld_tpu_torch.scripts.ablate_ddim_steps --workdir /tmp/e2e \\
        --out ddim_ablation.json

The report has the JAX report's keys; ``backend`` is the torch device type
and ``device`` the card's name. Runs on the card unless ``--device`` names
another; without a visible CUDA device the default raises.
"""
import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DDIM step-count ablation "
                                            "(PyTorch port)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, nargs="+",
                   default=[5, 10, 20, 50, 100])
    p.add_argument("--bench-batch", type=int, default=128)
    p.add_argument("--bench-iters", type=int, default=10)
    p.add_argument("--guidance", type=float, default=2.5,
                   help="match the e2e protocol's short-budget CFG scale")
    p.add_argument("--out", default="ddim_ablation.json")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def arm_config(workdir: str, n_steps: int, guidance: float):
    """The workdir's resolved protocol config (``cfg.json``; a workdir
    without one takes the small protocol's dims) at `n_steps` DDIM steps
    and CFG scale `guidance`, on the workdir's corpus and bundle."""
    from mld_tpu_torch.config import load_config

    cfg_json = os.path.join(workdir, "cfg.json")
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            base = json.load(f)
    else:
        base = {"model": {"latent_dim": 64, "ff_size": 128,
                          "num_layers": 3, "denoiser_num_layers": 3,
                          "num_heads": 4, "text_encoded_dim": 64,
                          "clip_layers": 2, "clip_heads": 2}}
    t2m_path = os.path.join(workdir, "t2m_eval_params.npz")
    base["debug"] = False
    base.setdefault("model", {})["guidance_scale"] = guidance
    base["model"].setdefault("scheduler", {})[
        "num_inference_timesteps"] = n_steps
    base.setdefault("dataset", {}).update(
        {"root": os.path.join(workdir, "data"), "max_motion_len": 96,
         "min_motion_len": 16})
    base.setdefault("eval", {}).update(
        {"batch_size": 32, "diversity_times": 30, "r_size": 32,
         "t2m_params_path": t2m_path if os.path.exists(t2m_path) else ""})
    return load_config(None, base, preset="mld_humanml3d")


def run_arm(workdir: str, n_steps: int, guidance: float, device,
            bench_batch: int, bench_iters: int) -> dict:
    """One step count: the split's metrics and the timed generation."""
    import torch

    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.eval.pipeline import Evaluator
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.models.mld import MLD, lengths_to_mask
    from mld_tpu_torch.utils.checkpoint import load_pretrained

    cfg = arm_config(workdir, n_steps, guidance)
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    mld = MLD(cfg, mean=dm.mean, std=dm.std, mean_eval=dm.mean_eval,
              std_eval=dm.std_eval, device=device,
              generator=torch.Generator().manual_seed(0))
    load_pretrained(mld, os.path.join(workdir, "trained_params.npz"))
    mld.drop_stacks()
    res = Evaluator(cfg, mld, dm).run_split(
        dm.loader("test", shuffle=False, drop_last=True), stage="diffusion",
        generator=torch.Generator(device=device).manual_seed(7))
    arm = {k: float(v) for k, v in res.items()}

    # the throughput of the e2e model itself: the RELATIVE cost across step
    # counts is the signal
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    B, T = bench_batch, cfg.dataset.max_motion_len
    ids = mld.tokenize(["a person walks forward"] * B)
    lengths = np.random.RandomState(0).randint(32, T + 1, B)
    mask = lengths_to_mask(lengths.tolist(), T, device)

    def call(seed):
        g = torch.Generator(device=device).manual_seed(seed)
        return mld.generate_joints(ids, mask, generator=g)

    call(1)
    sync()
    t0 = time.perf_counter()
    for i in range(bench_iters):
        call(2 + i)
    sync()
    dt = time.perf_counter() - t0
    arm["motions_per_sec"] = round(B * bench_iters / dt, 1)
    arm["aits_ms"] = round(dt / (B * bench_iters) * 1e3, 4)
    return arm


def main(argv=None):
    args = parse_args(argv)
    import torch

    from mld_tpu_torch.models.mld import resolve_device

    device = resolve_device(args.device)
    report = {"backend": device.type,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "guidance": args.guidance, "arms": {}}
    for n_steps in args.steps:
        arm = run_arm(args.workdir, n_steps, args.guidance, device,
                      args.bench_batch, args.bench_iters)
        report["arms"][str(n_steps)] = arm
        print(f"steps={n_steps:4d} FID={arm.get('FID', float('nan')):8.3f} "
              f"R@1={arm.get('R_precision_top_1', float('nan')):6.3f} "
              f"{arm['motions_per_sec']:9.1f} motions/s", flush=True)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
