"""Matmul-precision study with trained weights (the twin of
``scripts/precision_study.py``): does a cheaper matmul precision on a
serving stage shift the evaluator metrics against IEEE f32 ("highest")?

Runs the metric protocol on the model a ``train_synthetic_e2e`` run trained
(its workdir: ``cfg.json``, ``trained_params.npz``,
``t2m_eval_params.npz``, ``data/``) once for each arm, each in its own
process with ``MLD_TPU_MATMUL_PRECISION`` and ``MLD_TPU_STAGE_PRECISION``
set (``utils/precision.py``), and reports each arm's metrics, its FID delta
against "highest", and whether the delta exceeds the sampling-noise floor
of the seed re-rolls. The evaluator networks stay at "highest" in every
arm, so the deltas belong to the generation stages alone.

    python -m mld_tpu_torch.scripts.train_synthetic_e2e --workdir /tmp/e2e
    python -m mld_tpu_torch.scripts.precision_study --workdir /tmp/e2e \\
        --out docs/precision_report_torch_h100.json
    python -m mld_tpu_torch.scripts.precision_decide

The report has the JAX report's keys, and ``_device``: the card's name and
power limit (``nvidia-smi``), or the CPU. ``--jobs`` runs that many arms at
once (the metrics do not depend on it). Runs on the card unless
``--device`` names another; without a visible CUDA device the default
raises.
"""
import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# arm -> (session precision, per-stage overlay), JAX's arms. The *_bf16
# arms put one serving stage in bf16; gen_bf16 every generation stage,
# with the evaluators at "highest" as in every arm. "high" is TF32 here.
ARMS = {
    "highest": ("highest", ""),
    "default": ("default", ""),
    "clip_bf16": ("highest", "clip=default"),
    "scan_bf16": ("highest", "scan=default"),
    "decode_bf16": ("highest", "decode=default"),
    "scan_high": ("highest", "scan=high"),
    "decode_high": ("highest", "decode=high"),
    "gen_bf16": ("highest", "clip=default,scan=default,decode=default"),
    "gen_mixed_high": ("highest", "clip=default,scan=high,decode=high"),
    "gen_fast": ("highest", "clip=default,scan=default,decode=high"),
    "serving_mixed": ("default", "scan=highest,decode=highest"),
    # the sampling-noise floor: "highest"'s numerics under another eval
    # seed; an arm whose |FID delta| is within their spread carries no
    # quality signal
    "noise_seed8": ("highest", ""),
    "noise_seed9": ("highest", ""),
    "noise_seed10": ("highest", ""),
}

ARM_SEEDS = {"noise_seed8": 8, "noise_seed9": 9, "noise_seed10": 10}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="matmul-precision study "
                                            "(PyTorch port)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--arms", nargs="+", default=list(ARMS),
                   choices=list(ARMS))
    p.add_argument("--out", default="precision_report.json")
    p.add_argument("--allow-random-eval", action="store_true",
                   help="proceed without the trained evaluator bundle "
                        "(the report will not detect precision shifts)")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    p.add_argument("--jobs", type=int, default=1,
                   help="arms evaluated at once")
    return p.parse_args(argv)


def eval_config(workdir: str, t2m_path: str):
    """The workdir's resolved protocol config (``cfg.json``; a workdir
    without one takes the small protocol's dims) on its corpus, with the
    reference protocol's eval shape and the evaluator bundle `t2m_path`
    ("" for random evaluators)."""
    from mld_tpu_torch.config import load_config

    cfg_json = os.path.join(workdir, "cfg.json")
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            base = json.load(f)
    else:
        base = {"model": {"latent_dim": 64, "ff_size": 128, "num_layers": 3,
                          "denoiser_num_layers": 3, "num_heads": 4,
                          "text_encoded_dim": 64, "clip_layers": 2,
                          "clip_heads": 2,
                          "scheduler": {"num_inference_timesteps": 10}}}
    base["debug"] = False
    base.setdefault("dataset", {}).update(
        {"root": os.path.join(workdir, "data"), "max_motion_len": 96,
         "min_motion_len": 16})
    base.setdefault("eval", {}).update(
        {"batch_size": 32, "diversity_times": 30, "r_size": 32,
         "t2m_params_path": t2m_path})
    return load_config(None, base, preset="mld_humanml3d")


def evaluate(workdir: str, params_name: str, seed: int, device) -> dict:
    """The metric protocol over the test split on the trained bundle
    `params_name`, at the matmul precision of this process's
    environment."""
    import torch

    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.eval.pipeline import Evaluator
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.models.mld import MLD, resolve_device
    from mld_tpu_torch.utils.checkpoint import load_pretrained

    device = resolve_device(device)
    t2m = os.path.join(workdir, "t2m_eval_params.npz")
    cfg = eval_config(workdir, t2m if os.path.exists(t2m) else "")
    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    mld = MLD(cfg, mean=dm.mean, std=dm.std, mean_eval=dm.mean_eval,
              std_eval=dm.std_eval, device=device,
              generator=torch.Generator().manual_seed(0))
    load_pretrained(mld, os.path.join(workdir, params_name))
    res = Evaluator(cfg, mld, dm).run_split(
        dm.loader("test", shuffle=False, drop_last=True), stage="diffusion",
        generator=torch.Generator(device=device).manual_seed(seed))
    return {k: float(v) for k, v in res.items()}


def run_eval(workdir: str, precision: str, stage_spec: str = "",
             allow_random_eval: bool = False,
             params_name: str = "trained_params.npz", seed: int = 7,
             device: str = "cuda") -> dict:
    """One arm: ``evaluate`` in a process of its own with the two
    variables set. Without the trained evaluator bundle it refuses, unless
    `allow_random_eval`: random evaluators pin R-precision at chance and
    hide any precision shift."""
    env = dict(os.environ)
    env["MLD_TPU_MATMUL_PRECISION"] = precision
    if stage_spec:
        env["MLD_TPU_STAGE_PRECISION"] = stage_spec
    else:
        env.pop("MLD_TPU_STAGE_PRECISION", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    t2m = os.path.join(workdir, "t2m_eval_params.npz")
    if not os.path.exists(t2m):
        if not allow_random_eval:
            raise SystemExit(
                f"trained evaluator bundle not found: {t2m}\n"
                "run python -m mld_tpu_torch.scripts.train_synthetic_e2e "
                "with this --workdir first, or pass --allow-random-eval to "
                "proceed anyway (the report will NOT be able to detect "
                "precision shifts)")
        print(f"WARNING: {t2m} missing: random-init evaluators; the report "
              "cannot detect precision shifts", file=sys.stderr)
    code = ("import json\n"
            "from mld_tpu_torch.scripts.precision_study import evaluate\n"
            f"res = evaluate({workdir!r}, {params_name!r}, {seed}, "
            f"{device!r})\n"
            "print('RESULT_JSON:' + json.dumps(res))\n")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=1700)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-2000:])
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("RESULT_JSON:")][-1]
    return json.loads(line[len("RESULT_JSON:"):])


def device_record(device: str) -> dict:
    """The device a report's numbers come from: the card's name and power
    limit as nvidia-smi reads them, or the CPU."""
    if not device.startswith("cuda"):
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return {"device": "cuda", "nvidia_smi": smi.stdout.strip()}


def add_deltas(report: dict, arms) -> None:
    """Each arm's FID delta against "highest" and, with noise arms, the
    floor and each precision arm's verdict against it (the JAX script's
    rule)."""
    if "highest" not in report:
        return
    f32 = report["highest"]
    denom = max(abs(f32["FID"]), 1e-6)
    for arm in arms:
        if arm == "highest":
            continue
        delta = abs(report[arm]["FID"] - f32["FID"]) / denom
        report[arm]["fid_rel_delta_vs_f32"] = delta
        print(f"FID relative delta ({arm} vs f32): {delta*100:.2f}%")
    if "default" in report:  # backwards-compat field
        report["fid_rel_delta"] = report["default"]["fid_rel_delta_vs_f32"]
    noise = [report[a]["fid_rel_delta_vs_f32"] for a in arms
             if a in ARM_SEEDS and a in report]
    if noise:
        floor = max(noise)
        report["fid_noise_floor"] = floor
        for arm in arms:
            if arm == "highest" or arm in ARM_SEEDS:
                continue
            report[arm]["exceeds_noise_floor"] = bool(
                report[arm]["fid_rel_delta_vs_f32"] > floor)
        print(f"FID sampling-noise floor (seed re-rolls): {floor*100:.2f}%")


def main(argv=None) -> dict:
    args = parse_args(argv)
    report = {"_device": device_record(args.device)}
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        futures = {arm: pool.submit(
            run_eval, args.workdir, *ARMS[arm],
            allow_random_eval=args.allow_random_eval,
            seed=ARM_SEEDS.get(arm, 7), device=args.device)
            for arm in args.arms}
        for arm in args.arms:
            prec, spec = ARMS[arm]
            report[arm] = futures[arm].result()
            report[arm]["_env"] = {"MLD_TPU_MATMUL_PRECISION": prec,
                                   "MLD_TPU_STAGE_PRECISION": spec}
            print(f"{arm}: FID={report[arm]['FID']:.4f} "
                  f"Matching={report[arm]['Matching_score']:.4f}",
                  flush=True)
            with open(args.out, "w") as f:  # incremental: survive timeouts
                json.dump(report, f, indent=2)
    add_deltas(report, args.arms)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
