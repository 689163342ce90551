"""Training-step throughput on the card (the twin of
``scripts/bench_train.py``).

Reference anchor: ~1 day for 2000 epochs of HumanML3D (~24.5k clips) at
batch 64 on one GPU (README.md:207), ``REF_STEPS_PER_SEC`` optimizer steps
a second. ``vs_baseline`` is the samples a second against that anchor's
``REF_STEPS_PER_SEC`` x 64.

    python -m mld_tpu_torch.scripts.bench_train [--stage diffusion|vae] \\
        [--batch 64] [--bf16] [--remat] [--dropout P] [--json out.json]
    python -m mld_tpu_torch.scripts.bench_train --pipeline [--no-prefetch]

Each stage runs ``train/steps.py:train_step`` on a fixed batch (or, with
``--pipeline``, through the loop's real input path: a synthetic corpus on
disk, the data module's loader, its collator, ``batch_to_device``) at the
session's matmul precision; steps a second come from the host's clock
around ``--iters`` steps that end in a synchronisation, after two warm-up
steps (the first counted: its operations through
``utils/flops.py``, the kernels' counters beside FlopCounterMode, a
step's forward, backward and update), with the samples a second and the
share of the bf16 peak those operations reach.

Each stage prints the JAX script's JSON line; ``--json`` writes them all
with the card's name and power limit. Left out, as TPU-only: ``--spd``
(optimizer steps fused per dispatch in one XLA scan), ``--device-data``
(the corpus resident in the TPU's memory with sampling fused into that
scan), ``--fixed-scan`` and ``--ab`` (that scan's A/B arms): the port does
not port the train scans (ROADMAP.md, "Not ported on purpose"). Left out
too: ``--sweep``, a grid of these runs over stage, batch and
``MLD_TPU_MATMUL_PRECISION``, which a loop over this script gives. ``--cfg``
merges a YAML file over ``mld_humanml3d`` and ``--clips`` sizes the pipeline's
corpus (the JAX script's 2,048). Runs on the card unless ``--device cpu``
is given; without a visible CUDA device the default raises.
"""
import argparse
import json
import os
import time

import numpy as np

from mld_tpu_torch.scripts import _bench

REF_STEPS_PER_SEC = 2000 * (24500 // 64) / (24 * 3600)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="training-step throughput "
                                            "(PyTorch port)")
    p.add_argument("--stage", nargs="+", default=["diffusion"],
                   choices=["vae", "diffusion"])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--pipeline", action="store_true",
                   help="drive the real input pipeline (synthetic corpus, "
                        "loader + collate + host->device)")
    p.add_argument("--no-prefetch", action="store_true",
                   help="with --pipeline: the loader without its "
                        "background prefetch")
    p.add_argument("--data-root", default=os.path.join(
        REPO, "build", "bench_train_data"))
    p.add_argument("--clips", type=int, default=2048,
                   help="with --pipeline: clips of the synthetic corpus "
                        "built at --data-root when it has none")
    p.add_argument("--dropout", type=float, default=None,
                   help="override model dropout")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize forwards in the loss")
    p.add_argument("--bf16", action="store_true",
                   help="mixed-precision training (model.dtype=bfloat16)")
    p.add_argument("--cfg", default=None,
                   help="YAML merged over mld_humanml3d")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def _config(args, stage, batch, data_root=None):
    from mld_tpu_torch.config import load_config

    over = {"train": {"stage": stage, "batch_size": batch}}
    if args.dropout is not None:
        over["model"] = {"dropout": args.dropout}
    if args.bf16:
        over.setdefault("model", {})["dtype"] = "bfloat16"
    if args.remat:
        over["train"]["remat"] = True
    if data_root:
        over["dataset"] = {"root": data_root}
    return load_config(args.cfg, over, preset="mld_humanml3d")


def _rate(device, step, n_steps):
    """(steps a second over n_steps after two warm-up steps, the first of
    which is counted, its operations: forward, backward and update, as
    ``utils/flops.py:count`` counts them with the gradient on)."""
    from mld_tpu_torch.utils import flops

    ops = flops.count(step, grad=True)
    step()
    _bench.sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    _bench.sync(device)
    return n_steps / (time.perf_counter() - t0), ops


def _arm(stage, batch, sps, ops, **extra):
    return {"metric": f"{stage}_train_step_throughput", "value": sps,
            "unit": "steps/sec/chip", "batch_size": batch,
            "samples_per_sec": sps * batch,
            "vs_baseline": sps * batch / (REF_STEPS_PER_SEC * 64),
            "gflops_per_step": ops / 1e9,
            "mfu_bf16peak": ops * sps / _bench.PEAK_FLOPS["bf16"], **extra}


def fixed_batch(args, device, stage, batch):
    """steps/s of train_step on one fixed batch (the JAX script's default
    mode)."""
    import torch

    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.train.steps import create_train_state, train_step

    cfg = _config(args, stage, batch)
    mld = MLD(cfg, device=device, generator=torch.Generator().manual_seed(0))
    state = create_train_state(mld, stage)
    T = cfg.dataset.max_motion_len
    rs = np.random.RandomState(0)
    batch_t = {
        "motion": torch.as_tensor(rs.randn(batch, T, cfg.dataset.nfeats),
                                  dtype=torch.float32, device=device),
        "mask": torch.as_tensor(np.arange(T)[None] < rs.randint(
            min(64, T), T + 1, (batch, 1)), device=device),
        "text_ids": mld.tokenize(["a person walks"] * batch),
        "row_valid": torch.ones(batch, dtype=torch.bool, device=device),
    }
    gen = torch.Generator(device=device).manual_seed(1)
    sps, ops = _rate(device, lambda: train_step(state, batch_t, gen),
                     args.iters)
    return _arm(stage, batch, sps, ops)


def pipeline(args, device, stage):
    """steps/s through the loop's input path: corpus on disk -> the data
    module's loader (prefetching unless --no-prefetch) -> collate ->
    batch_to_device -> train_step."""
    import torch

    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.data.synthetic import build_synthetic_dataset
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.train.steps import (batch_to_device,
                                           create_train_state, train_step)

    root = os.path.join(args.data_root, "humanml3d")
    if not os.path.exists(os.path.join(root, "Mean.npy")):
        build_synthetic_dataset(root, n_samples=args.clips, seed=0)
    cfg = _config(args, stage, args.batch, root)
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    mld = MLD(cfg, mean=dm.mean, std=dm.std, device=device,
              generator=torch.Generator().manual_seed(0))
    state = create_train_state(mld, stage)
    prefetch = 0 if args.no_prefetch else 3
    loader = dm.loader("train", drop_last=True, prefetch=prefetch)
    gen = torch.Generator(device=device).manual_seed(1)

    def batches():
        while True:
            n = 0
            for n, batch in enumerate(loader, 1):
                yield batch
            if n == 0:
                raise ValueError(f"the train split of {root} holds less "
                                 f"than one batch of {args.batch}")

    it = batches()
    sps, ops = _rate(device,
                     lambda: train_step(state, batch_to_device(next(it),
                                                               device), gen),
                     args.iters)
    return _arm(stage, args.batch, sps, ops,
                metric=f"{stage}_train_pipeline_throughput",
                prefetch=prefetch, native_collate=dm.use_native)


def main(argv=None):
    args = parse_args(argv)
    device = _bench.resolve_device(args.device)
    report = {**_bench.header(device), "ref_steps_per_sec": REF_STEPS_PER_SEC,
              "stages": []}
    for stage in args.stage:
        arm = (pipeline(args, device, stage) if args.pipeline
               else fixed_batch(args, device, stage, args.batch))
        report["stages"].append(arm)
        print(json.dumps(arm), flush=True)
    if not _bench.finite(report):
        raise AssertionError("a non-finite number in the report")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    return report


if __name__ == "__main__":
    main()
