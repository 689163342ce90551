"""Training matmul-precision study (the twin of
``scripts/train_precision_study.py``): does training at a cheaper session
precision stay on the f32 curve?

Retrains the two-stage protocol (CLIP pretraining -> VAE -> diffusion,
``python -m mld_tpu_torch.scripts.train_synthetic_e2e``) under each session
precision (``MLD_TPU_MATMUL_PRECISION``: "highest" IEEE f32, "high" TF32,
"default" bf16 operands; ``utils/precision.py``) with the same corpus,
seeds and step budget, then evaluates every arm with the same measuring
stick: the workdir's trained t2m evaluator bundle, serving pinned at
"highest", so that the deltas belong to the training precision alone.
Reports each stage's first and last loss and the FID delta against the
f32-trained arm.

    python -m mld_tpu_torch.scripts.train_synthetic_e2e --workdir /tmp/e2e
    python -m mld_tpu_torch.scripts.train_precision_study \\
        --workdir /tmp/e2e --steps 400 --out train_precision.json

``--jobs`` trains (then evaluates) that many arms at once; the losses do
not depend on it. Runs on the card unless ``--device`` names another.
"""
import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

from mld_tpu_torch.scripts.precision_study import (REPO, device_record,
                                                   run_eval)

ARMS = ("highest", "high", "default")


def train_arm(workdir: str, arm: str, steps: int, clip_steps: int,
              device: str = "cuda") -> dict:
    """Retrain both stages (and the tower) at session precision `arm`;
    returns the loss report."""
    out = os.path.join(workdir, f"train_report_{arm}.json")
    env = dict(os.environ)
    env["MLD_TPU_MATMUL_PRECISION"] = arm
    env.pop("MLD_TPU_STAGE_PRECISION", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    r = subprocess.run(
        [sys.executable, "-m", "mld_tpu_torch.scripts.train_synthetic_e2e",
         "--workdir", workdir, "--steps", str(steps),
         "--clip-steps", str(clip_steps),
         "--reuse-eval-bundle", "--skip-loop", "--skip-final-eval",
         "--params-name", f"trained_params_{arm}.npz", "--out", out,
         "--device", device],
        env=env, capture_output=True, text=True, timeout=5400)
    if r.returncode != 0:
        raise RuntimeError(f"arm {arm} training failed:\n" + r.stderr[-2000:])
    with open(out) as f:
        rep = json.load(f)
    return {k: rep[k] for k in ("t2m_evaluator", "clip_pretrain", "vae",
                                "diffusion") if k in rep}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="training matmul-precision "
                                            "study (PyTorch port)")
    p.add_argument("--workdir", required=True,
                   help="an existing train_synthetic_e2e workdir (its data "
                        "and t2m evaluator bundle are REUSED so every arm "
                        "sees the same corpus and measuring stick)")
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--clip-steps", type=int, default=800)
    p.add_argument("--arms", nargs="+", default=list(ARMS), choices=ARMS)
    p.add_argument("--reuse-highest", default="",
                   help="params filename of an already-trained f32 arm "
                        "inside --workdir (e.g. trained_params.npz from the "
                        "e2e run) to skip retraining 'highest'")
    p.add_argument("--out", default="train_precision_report.json")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    p.add_argument("--jobs", type=int, default=1,
                   help="arms trained (then evaluated) at once")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    t2m = os.path.join(args.workdir, "t2m_eval_params.npz")
    if not os.path.exists(t2m):
        raise SystemExit(f"missing {t2m}: run train_synthetic_e2e first")

    report = {"steps": args.steps, "_device": device_record(args.device),
              "arms": {}}
    names = {}
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        trained = {}
        for arm in args.arms:
            names[arm] = f"trained_params_{arm}.npz"
            if arm == "highest" and args.reuse_highest:
                names[arm] = args.reuse_highest
                report["arms"][arm] = {"reused_params": names[arm]}
            else:
                trained[arm] = pool.submit(train_arm, args.workdir, arm,
                                           args.steps, args.clip_steps,
                                           args.device)
        for arm, fut in trained.items():
            report["arms"][arm] = fut.result()
        # eval parity: serving pinned f32 for EVERY arm, so that only the
        # training precision differs between arms
        evals = {arm: pool.submit(run_eval, args.workdir, "highest",
                                  params_name=names[arm],
                                  device=args.device)
                 for arm in args.arms}
        for arm in args.arms:
            res = report["arms"][arm]["eval_f32_serving"] = \
                evals[arm].result()
            print(f"{arm}: FID={res['FID']:.4f} "
                  f"R@1={res['R_precision_top_1']:.4f} "
                  f"Matching={res['Matching_score']:.4f}", flush=True)

    if "highest" in report["arms"]:
        base = report["arms"]["highest"]["eval_f32_serving"]
        denom = max(abs(base["FID"]), 1e-6)
        for arm, rec in report["arms"].items():
            if arm == "highest":
                continue
            rec["fid_rel_delta_vs_f32_train"] = (
                abs(rec["eval_f32_serving"]["FID"] - base["FID"]) / denom)
            print(f"FID relative delta ({arm}-trained vs f32-trained): "
                  f"{rec['fid_rel_delta_vs_f32_train']*100:.2f}%")
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
