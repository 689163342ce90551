"""End-to-end action-to-motion on the synthetic HumanAct12 archive (the twin
of ``scripts/train_a2m_e2e.py``):

    python -m mld_tpu_torch.scripts.train_a2m_e2e --steps 2000 \\
        --out e2e_a2m_report.json
    python -m mld_tpu_torch.scripts.train_a2m_e2e --device cpu ...

Trains the HumanAct12 GRU classifier (``eval/a2m_train.py``, the stand-in
for the reference's frozen action-recognition checkpoint), then the ACTOR
VAE and the latent diffusion stages on the class-conditioned corpus, writes
the trained model as ``trained_params.npz`` (the JAX package's tree), and
runs the evaluation protocol (``python -m mld_tpu_torch.eval --preset
mld_humanact12``, one subprocess an arm, on ``--device``) for three arms:
trained classifier x trained generator, trained classifier x random-init
generator, random classifier x trained generator. Writes one JSON report
and prints the JAX script's ``A2M E2E LEARNING CHECK`` rule: the classifier
above 3x chance on its training batches and on the ground truth, the
trained generator's FID below random init's and its accuracy not below it.
Exit code 0 on PASS, 1 on FAIL.

Runs on the card unless ``--device`` names another; without a visible CUDA
device the default raises.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="synthetic end-to-end action-to-motion (PyTorch port)")
    p.add_argument("--steps", type=int, default=2000,
                   help="training steps per MLD stage (vae, diffusion)")
    p.add_argument("--cls-steps", type=int, default=600,
                   help="classifier training steps (eval/a2m_train.py)")
    p.add_argument("--replication", type=int, default=2)
    p.add_argument("--guidance", type=float, default=2.5)
    p.add_argument("--out", default="e2e_a2m_report.json")
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def learned(report) -> bool:
    """The JAX script's A2M E2E LEARNING CHECK."""
    tt = report["trained_cls_trained_gen"]
    tr = report["trained_cls_random_gen"]
    chance = report["chance_accuracy"]
    return (report["classifier"]["train_acc_last"] > 3 * chance
            and tt["gt_accuracy"] > 3 * chance      # classifier sees GT
            and tt["FID"] < tr["FID"]               # FID orders training
            and tt["accuracy"] > tr["accuracy"] - 1e-9)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.eval.a2m_train import (save_a2m_params,
                                              train_a2m_classifier)
    from mld_tpu_torch.models.mld import MLD, resolve_device
    from mld_tpu_torch.scripts.train_synthetic_e2e import run_stage
    from mld_tpu_torch.train.steps import (batch_to_device,
                                           create_train_state, train_step)
    from mld_tpu_torch.utils.checkpoint import save_params_npz

    device = resolve_device(args.device)
    workdir = os.path.abspath(args.workdir
                              or tempfile.mkdtemp(prefix="mld_a2m_e2e_"))
    rec_dir = os.path.join(workdir, "actionrec")
    empty_rec = os.path.join(workdir, "actionrec_random")
    os.makedirs(rec_dir, exist_ok=True)
    os.makedirs(empty_rec, exist_ok=True)

    overrides = {
        "debug": False,
        "model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                  "denoiser_num_layers": 3, "num_heads": 4,
                  "guidance_scale": args.guidance,
                  "humanact12_rec_path": rec_dir,
                  "scheduler": {"num_inference_timesteps": 10}},
        "dataset": {"root": os.path.join(workdir, "data")},
        "train": {"batch_size": 16, "lr": 3e-4},
        "eval": {"batch_size": 32, "diversity_times": 30,
                 "mm_num_samples": 0},
        "test": {"replication_times": args.replication},
    }
    cfg = load_config(None, overrides, preset="mld_humanact12")
    dm = get_datamodule(cfg)
    mld = MLD(cfg, mean=dm.mean, std=dm.std, mean_eval=dm.mean_eval,
              std_eval=dm.std_eval, device=device,
              generator=torch.Generator().manual_seed(0))
    report = {"steps": args.steps, "backend": device.type,
              "chance_accuracy": 1.0 / cfg.model.nclasses}

    # --------------------------------------------- stage 0: GRU classifier
    cls_params, report["classifier"] = train_a2m_classifier(
        cfg, dm, mld, steps=args.cls_steps)
    save_a2m_params(os.path.join(rec_dir, "humanact12_gru_params.npz"),
                    cls_params)

    def batches(seed):
        loader = dm.loader("train", seed=seed)
        while True:
            for b in loader:
                yield batch_to_device(b, device)

    # ---------------------------------- stage 1: ACTOR VAE, 2: diffusion
    generator = torch.Generator(device=device).manual_seed(0)
    for stage, seed in (("vae", 1), ("diffusion", 2)):
        state = create_train_state(mld, stage)
        report[stage] = run_stage(state, batches(seed), generator,
                                  args.steps, train_step)
        del state
    ckpt_path = os.path.join(workdir, "trained_params.npz")
    save_params_npz(ckpt_path, mld.params_tree())
    report["params_path"] = ckpt_path
    del mld

    # ------------------- the evaluation protocol, one subprocess an arm
    # the config of each arm as a file (JSON, which YAML reads)
    cfg_path = os.path.join(workdir, "a2m_e2e.yaml")
    with open(cfg_path, "w") as f:
        json.dump(overrides, f, indent=1)
    cfg_randcls = os.path.join(workdir, "a2m_e2e_randcls.yaml")
    rand_over = json.loads(json.dumps(overrides))
    rand_over["model"]["humanact12_rec_path"] = empty_rec
    with open(cfg_randcls, "w") as f:
        json.dump(rand_over, f, indent=1)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])

    def run_test(tag, path, checkpoint=None):
        out = os.path.join(workdir, f"metrics_{tag}.json")
        cmd = [sys.executable, "-m", "mld_tpu_torch.eval", "--cfg", path,
               "--preset", "mld_humanact12", "--replication",
               str(args.replication), "--no_mm", "--out", out,
               "--device", args.device]
        if checkpoint:
            cmd += ["--checkpoint", checkpoint]
        t0 = time.time()
        r = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True,
                           text=True, timeout=3600)
        if r.returncode != 0:
            print(r.stdout[-4000:], file=sys.stderr)
            print(r.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"evaluation arm {tag} failed")
        print(f"arm {tag}: {time.time() - t0:.1f} s", flush=True)
        with open(out) as f:
            return json.load(f)

    report["trained_cls_trained_gen"] = run_test("trained_trained", cfg_path,
                                                 ckpt_path)
    report["trained_cls_random_gen"] = run_test("trained_random", cfg_path)
    report["random_cls_trained_gen"] = run_test("random_trained",
                                                cfg_randcls, ckpt_path)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    ok = learned(report)
    print("A2M E2E LEARNING CHECK:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
