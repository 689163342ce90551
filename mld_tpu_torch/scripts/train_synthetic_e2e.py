"""End-to-end two-stage training on the synthetic corpus, with the metric
protocol before and after (the twin of ``scripts/train_synthetic_e2e.py``):

    python -m mld_tpu_torch.scripts.train_synthetic_e2e --steps 400 \\
        --out e2e_report.json
    python -m mld_tpu_torch.scripts.train_synthetic_e2e --device cpu ...

Stages, in the JAX script's order: the corpus (built in-process), the
resolved config as ``cfg.json``, the t2m evaluator bundle
(``eval/t2m_train.py``), the CLIP text-tower pretraining
(``train/pretrain.py``), the vae stage, then the diffusion stage
(``train/steps.py``; ``--lr-schedule cosine`` is ``SkipNonFinite(AdamW)``
on a warmup-cosine schedule that a skipped step does not advance, as
``optax.apply_if_finite(adamw(schedule))``), the trained model as
``trained_params.npz`` (the JAX package's tree, which its ``test.py
--checkpoint`` reads), random init (seed 99) against trained through
``Evaluator.run_gt`` and ``run_split``, and a ``train()`` run from the
trained bundle (``train.pretrained``) whose val metrics give the FID curve
(the port's ``metrics.jsonl`` logs them under the split "val-metrics").
Writes the JSON report (the JAX report's keys; ``backend`` is the torch
device type) and prints the JAX script's ``E2E LEARNING CHECK`` rule:
the vae loss fell (or the VAE was reused), the diffusion loss fell, the
trained model's FID is below random init's and the curve has two points.
Exit code 0 on PASS, 1 on FAIL.

Runs on the card unless ``--device`` names another; without a visible CUDA
device the default raises.
"""
import argparse
import copy
import functools
import json
import os
import sys
import tempfile
import time

# the train() section's epochs (the JAX script's 3)
LOOP_EPOCHS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="synthetic end-to-end training (PyTorch port)")
    p.add_argument("--steps", type=int, default=400,
                   help="training steps per MLD stage (vae, diffusion)")
    p.add_argument("--guidance", type=float, default=2.5,
                   help="CFG scale of the eval sampling passes (the "
                        "reference's 7.5 assumes a converged denoiser)")
    p.add_argument("--samples", type=int, default=320,
                   help="clips in the synthetic corpus")
    p.add_argument("--eval-steps", type=int, default=1000,
                   help="contrastive training steps of the t2m evaluator "
                        "bundle (eval/t2m_train.py)")
    p.add_argument("--clip-steps", type=int, default=800,
                   help="CLIP text-tower pretraining steps "
                        "(train/pretrain.py)")
    p.add_argument("--out", default="e2e_report.json")
    p.add_argument("--workdir", default=None)
    p.add_argument("--model-scale", default="small",
                   choices=["small", "large"],
                   help="small: the protocol's dims (latent 1x64, 3-layer "
                        "denoiser, 2x64 text tower); large: latent 2x256, "
                        "ff 1024, 7-layer denoiser, 4x256 tower")
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = the scale's default (16 small / 32 large)")
    p.add_argument("--lr-schedule", default="const",
                   choices=["const", "cosine"],
                   help="cosine: warmup-cosine decay over --steps a stage")
    p.add_argument("--reuse-eval-bundle", action="store_true",
                   help="load workdir/t2m_eval_params.npz instead of "
                        "training it again")
    p.add_argument("--params-name", default="trained_params.npz",
                   help="file name of the trained bundle in --workdir")
    p.add_argument("--reuse-vae", default=None, metavar="BUNDLE_NPZ",
                   help="load the VAE of a trained bundle and skip the vae "
                        "stage")
    p.add_argument("--skip-loop", action="store_true",
                   help="skip the train() val-curve section")
    p.add_argument("--skip-final-eval", action="store_true",
                   help="skip the random-vs-trained evaluation")
    p.add_argument("--preset", default="mld_humanml3d",
                   choices=["mld_humanml3d", "mld_kit"])
    p.add_argument("--device", type=str, default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def protocol_config(args):
    """The protocol's config overrides (the JAX script's)."""
    if args.model_scale == "large":
        model_dims = {"latent_dim": 256, "latent_size": 2, "ff_size": 1024,
                      "num_layers": 5, "denoiser_num_layers": 7,
                      "num_heads": 4, "text_encoded_dim": 256,
                      "clip_layers": 4, "clip_heads": 4}
        default_bs, n_infer = 32, 50
    else:
        model_dims = {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                      "denoiser_num_layers": 3, "num_heads": 4,
                      "text_encoded_dim": 64, "clip_layers": 2,
                      "clip_heads": 2}
        default_bs, n_infer = 16, 10
    overrides = {
        "debug": False,
        "model": {**model_dims, "guidance_scale": args.guidance,
                  "scheduler": {"num_inference_timesteps": n_infer}},
        "dataset": {"root": os.path.join(args.workdir, "data"),
                    "max_motion_len": 96, "min_motion_len": 16},
        "train": {"batch_size": args.batch_size or default_bs, "lr": 3e-4},
        "eval": {"batch_size": 32, "diversity_times": 30,
                 "mm_num_samples": 2, "mm_num_repeats": 4,
                 "mm_num_times": 2},
    }
    if args.preset == "mld_kit":
        overrides["dataset"]["min_motion_len"] = 8
    return overrides


def learned(report, loop_ran: bool) -> bool:
    """The JAX script's E2E LEARNING CHECK: the vae loss fell (or the VAE
    was reused) and the diffusion loss fell; with the evaluation, the
    trained model's FID below random init's; with the train() section, a
    curve of two or more points."""
    ok = (("reused" in report["vae"]
           or report["vae"]["loss_last"] < report["vae"]["loss_first"])
          and report["diffusion"]["loss_last"]
          < report["diffusion"]["loss_first"])
    if "eval_trained" in report:
        ok = ok and (report["eval_trained"]["FID"]
                     < report["eval_random_init"]["FID"])
    if loop_ran:
        ok = ok and len(report["val_fid_curve"]) >= 2
    return ok


def run_stage(state, batches, generator, steps, train_step):
    """`steps` optimizer steps: the first and last step's total loss and the
    stage's seconds."""
    t0 = time.time()
    first = last = None
    for i in range(steps):
        logs = train_step(state, next(batches), generator)
        if i == 0:
            first = logs["total"]
        last = logs["total"]
    first, last = float(first), float(last)
    return {"loss_first": first, "loss_last": last,
            "seconds": time.time() - t0}


def val_fid_curve(folder):
    """The val metrics of every train() run under `folder`."""
    curve = []
    root = os.path.join(folder, "mld")
    for d in sorted(os.listdir(root)):
        path = os.path.join(root, d, "metrics.jsonl")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("split") == "val-metrics" and "FID" in rec:
                    curve.append({"epoch": rec["step"], "FID": rec["FID"],
                                  "R@1": rec.get("R_precision_top_1")})
    return curve


def finish(args, report, loop_ran: bool = False) -> int:
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    ok = learned(report, loop_ran)
    print("E2E LEARNING CHECK:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mld_tpu_torch.config import config_to_dict, load_config
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.data.synthetic import build_synthetic_dataset
    from mld_tpu_torch.eval.pipeline import Evaluator
    from mld_tpu_torch.eval.t2m_train import (save_t2m_params,
                                              train_t2m_evaluator,
                                              warmup_cosine)
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.models.mld import MLD, resolve_device
    from mld_tpu_torch.train.loop import train as train_loop
    from mld_tpu_torch.train.pretrain import pretrain_clip_text
    from mld_tpu_torch.train.steps import (batch_to_device,
                                           create_train_state, train_step)
    from mld_tpu_torch.utils.checkpoint import (load_pretrained,
                                                save_params_npz)

    device = resolve_device(args.device)
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="mld_e2e_")
    data_root = os.path.join(args.workdir, "data")
    if not os.path.exists(os.path.join(data_root, "Mean.npy")):
        # splits sized for discriminative metrics: test must hold >= 3
        # R-precision groups of 32 (tm2t.py:100-137 reference protocol)
        build_synthetic_dataset(
            data_root, n_samples=args.samples, seed=0,
            splits=(0.55, 0.15, 0.3),
            dataset="kit" if args.preset == "mld_kit" else "humanml3d")

    cfg = load_config(None, protocol_config(args), preset=args.preset)
    # the resolved protocol config, so that later studies build the same
    # architecture
    with open(os.path.join(args.workdir, "cfg.json"), "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    stats = dict(mean=dm.mean, std=dm.std, mean_eval=dm.mean_eval,
                 std_eval=dm.std_eval)
    mld = MLD(cfg, **stats, device=device,
              generator=torch.Generator().manual_seed(0))
    generator = torch.Generator(device=device).manual_seed(0)
    report = {"steps": args.steps, "backend": device.type}

    # ---------------------------------------- stage 0: t2m evaluator bundle
    t2m_path = os.path.join(args.workdir, "t2m_eval_params.npz")
    if args.reuse_eval_bundle and os.path.exists(t2m_path):
        report["t2m_evaluator"] = {"reused": t2m_path}
    else:
        bundle, report["t2m_evaluator"] = train_t2m_evaluator(
            cfg, dm, steps=args.eval_steps, device=device)
        save_t2m_params(t2m_path, bundle)
        del bundle
    cfg.eval.t2m_params_path = t2m_path

    # -------------------------------------------- stage 0b: CLIP pretraining
    report["clip_pretrain"] = pretrain_clip_text(cfg, dm, mld,
                                                 steps=args.clip_steps)

    def batches(seed):
        loader = dm.loader("train", seed=seed, drop_last=True)
        while True:
            for b in loader:
                yield batch_to_device(b, device)

    schedule = None
    if args.lr_schedule == "cosine":
        schedule = functools.partial(
            warmup_cosine, steps=args.steps, lr=cfg.train.lr,
            warmup=max(50, args.steps // 20), end=0.02)

    # ---------------------------------------------------------- stage 1: VAE
    if args.reuse_vae:
        load_pretrained(mld, args.reuse_vae, only=("vae",))
        report["vae"] = {"reused": args.reuse_vae}
    else:
        state = create_train_state(mld, "vae", schedule=schedule)
        report["vae"] = run_stage(state, batches(1), generator, args.steps,
                                  train_step)
        del state

    # ----------------------------------------------------- stage 2: diffusion
    state = create_train_state(mld, "diffusion", schedule=schedule)
    report["diffusion"] = run_stage(state, batches(2), generator,
                                    args.steps, train_step)
    del state

    params_path = os.path.join(args.workdir, args.params_name)
    save_params_npz(params_path, mld.params_tree())
    report["params_path"] = params_path
    report["data_root"] = data_root
    if args.skip_final_eval:
        return finish(args, report)

    # -------------------------------------------------- eval: random vs trained
    def test_loader():
        return dm.loader("test", shuffle=False, drop_last=True)

    ev = Evaluator(cfg, mld, dm)
    # the evaluators' own check: GT-vs-GT R-precision far above chance
    report["eval_gt"] = ev.run_gt(test_loader())
    random_mld = MLD(cfg, **stats, device=device,
                     generator=torch.Generator().manual_seed(99))
    report["eval_random_init"] = Evaluator(cfg, random_mld, dm).run_split(
        test_loader(), stage="diffusion",
        generator=torch.Generator(device=device).manual_seed(1))
    del random_mld
    report["eval_trained"] = ev.run_split(
        test_loader(), stage="diffusion",
        generator=torch.Generator(device=device).manual_seed(2))
    del ev
    if args.skip_loop:
        report["val_fid_curve"] = []
        return finish(args, report)

    # ----------- train() with the metric suite on the val split each epoch
    loop_cfg = copy.deepcopy(cfg).replace(name="e2e_loop")
    loop_cfg.train.stage = "diffusion"
    loop_cfg.train.end_epoch = LOOP_EPOCHS
    loop_cfg.train.pretrained = params_path
    loop_cfg.logger.folder = os.path.join(args.workdir, "exp")
    loop_cfg.logger.val_every_epochs = 1
    loop_cfg.logger.save_checkpoint_epoch = 10
    loop_cfg.logger.tensorboard = False
    del mld
    train_loop(loop_cfg, device=device)
    report["val_fid_curve"] = val_fid_curve(loop_cfg.logger.folder)
    return finish(args, report, loop_ran=True)


if __name__ == "__main__":
    sys.exit(main())
