"""The released-checkpoint parity drill (the twin of
``scripts/parity_drill.py``).

Given the reference release assets at their canonical paths, it runs the
pipeline convert -> shape-validate -> hydrate CLIP -> replicated metric
evaluation -> timing, and diffs the result against the published numbers
(HumanML3D FID 0.473, R@1 0.481, R@3 0.772, MM-Dist 3.196, Diversity 9.724,
AITS 0.217 s) with a pass / fail verdict at the 5% budget.

Canonical asset layout (reference prepare/*.sh targets):
    models/mld_humanml3d_checkpoint/1222_mld_humanml3d_FID041.ckpt
    deps/clip-vit-large-patch14/            (HF clone)
    deps/glove/                             (our_vab GloVe + POS)
    deps/t2m/t2m/text_mot_match/model/finest.tar
    deps/t2m/t2m/Comp_v6_KLD01/meta/{mean,std}.npy
    datasets/humanml3d/                     (HumanML3D release)

    python -m mld_tpu_torch.scripts.parity_drill [--assets-root .] \\
        [--replications 20] [--out drill_report.json] [--device cuda]

The flags, report schema, steps, verdict rule and exit codes are the JAX
script's: 2 when the checkpoint or the dataset is missing, 1 on a failed
conversion or verdict, 0 on a pass. ``--trust-checkpoint`` unpickles a
checkpoint whose hyper-parameters are more than tensors (the released one
may be; the port loads weights only otherwise). AITS is the mean of 20
``generate_joints`` calls at B = 1 after one warm call, between two clock
reads each after ``torch.cuda.synchronize()``. Without ``transformers``
(the card's machine has none) the tokenizer is the hash fallback and the
report says so. Runs on the card unless ``--device`` names another;
without a visible CUDA device the default raises.
"""
import argparse
import json
import os
import sys
import time

PAPER_TARGETS = {
    "FID": 0.473,
    "R_precision_top_1": 0.481,
    "R_precision_top_3": 0.772,
    "Matching_score": 3.196,
    "Diversity": 9.724,
}
PAPER_AITS = 0.217  # s/motion, V100 (arXiv 2212.04048 Tab. 6)
AITS_TEXT = "a person walks forward"
AITS_ITERS = 20


def asset_paths(root: str, ckpt=None) -> dict:
    j = os.path.join
    return {
        "ckpt": ckpt or j(root, "models", "mld_humanml3d_checkpoint",
                          "1222_mld_humanml3d_FID041.ckpt"),
        "clip": j(root, "deps", "clip-vit-large-patch14"),
        "glove": j(root, "deps", "glove"),
        "t2m_tar": j(root, "deps", "t2m", "t2m", "text_mot_match", "model",
                     "finest.tar"),
        "t2m_meta": j(root, "deps", "t2m", "t2m", "Comp_v6_KLD01", "meta"),
        "data": j(root, "datasets", "humanml3d"),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="released-checkpoint parity drill (PyTorch port)")
    p.add_argument("--assets-root", default=".")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--cfg", default=None,
                   help="config overrides yaml (CI uses tiny dims)")
    p.add_argument("--replications", type=int, default=20)
    p.add_argument("--budget", type=float, default=0.05)
    p.add_argument("--no-mm", action="store_true")
    p.add_argument("--skip-timing", action="store_true")
    p.add_argument("--out", default="drill_report.json")
    p.add_argument("--trust-checkpoint", action="store_true",
                   help="unpickle a checkpoint that holds more than tensors "
                        "(runs the code it names): only for a file you "
                        "trust")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def drill_config(root: str, paths: dict, replications: int, cfg_yaml=None):
    """mld_humanml3d with the assets' paths (the JAX drill's overrides) and
    the overrides of `cfg_yaml`."""
    from mld_tpu_torch.config import load_config, merge_dicts

    overrides = {
        "debug": False,
        "dataset": {"root": paths["data"],
                    "word_vectorizer_path": paths["glove"]},
        "model": {"clip_path": paths["clip"],
                  "t2m_path": os.path.join(root, "deps", "t2m")},
        "test": {"replication_times": replications},
    }
    if cfg_yaml:
        import yaml
        with open(cfg_yaml) as f:
            overrides = merge_dicts(overrides, yaml.safe_load(f) or {})
    return load_config(None, overrides, preset="mld_humanml3d")


class Report(dict):
    """The drill's report (the JAX drill's keys), with its steps printed
    as they are recorded."""

    def step(self, name, ok, detail=""):
        self["steps"].append({"step": name, "ok": bool(ok),
                              "detail": detail})
        print(f"  [{'ok' if ok else 'FAIL'}] {name} {detail}")

    def write(self, path):
        with open(path, "w") as f:
            json.dump(self, f, indent=2)


def build(cfg, paths: dict, present: dict, device, report: Report,
          trust: bool = False):
    """The data module and the model with the checkpoint converted in and
    the tower hydrated, each step recorded. Returns (dm, mld), or None when
    the conversion failed (the report's verdict then says so)."""
    import torch

    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.models.clip_text import (ClipTokenizer,
                                                load_hf_clip_weights)
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.utils.checkpoint import load_pretrained

    dm = get_datamodule(cfg, tokenizer=ClipTokenizer(cfg.model.clip_path))
    mld = MLD(cfg, mean=dm.mean, std=dm.std, mean_eval=dm.mean_eval,
              std_eval=dm.std_eval, device=device,
              generator=torch.Generator().manual_seed(0))
    report.step("tokenizer", True,
                "exact HF tokenizer" if mld.tokenizer.is_exact
                else "HASH FALLBACK (verdict not release-grade)")
    try:
        load_pretrained(mld, paths["ckpt"], trust=trust)
        mld.drop_stacks()
        report.step("convert+shape-validate", True, paths["ckpt"])
    except Exception as e:
        report.step("convert+shape-validate", False, str(e))
        report["verdict"] = f"fail: checkpoint conversion — {e}"
        return None
    # the released checkpoints hold no CLIP tower (modeltype/base.py:96-127)
    if present["clip"]:
        try:
            load_hf_clip_weights(paths["clip"], tower=mld.clip)
            report.step("clip-hydrate", True)
        except Exception as e:
            report.step("clip-hydrate", False, str(e))
    else:
        report.step("clip-hydrate", False, "clip clone missing — random CLIP")
    report.step("t2m-eval-stats", present["t2m_meta"],
                "evaluator-space mean/std" if present["t2m_meta"]
                else "falling back to model stats")
    return dm, mld


def evaluate(cfg, mld, dm, replications: int, with_mm: bool, draws=None):
    """The replicated protocol (``Evaluator.run``) at the diffusion stage,
    its generator seeded with cfg.seed on the model's device; `draws` (one
    iterable of batch draws a replication) replaces the main passes'.
    Returns (the metrics, the evaluator)."""
    import torch

    from mld_tpu_torch.eval.pipeline import Evaluator

    evaluator = Evaluator(cfg, mld, dm)
    generator = torch.Generator(device=mld.device).manual_seed(cfg.seed)
    results = evaluator.run(generator, replication_times=replications,
                            stage="diffusion", with_mm=with_mm, draws=draws)
    return results, evaluator


def time_aits(mld, iters: int = AITS_ITERS, B: int = 1) -> float:
    """Seconds a motion of ``generate_joints`` at B prompts of 196 frames
    (the AITS protocol: B = 1): one warm call, then `iters` calls between
    two clock reads, each after a synchronisation of the device."""
    import torch

    from mld_tpu_torch.models.mld import lengths_to_mask

    def sync():
        if mld.device.type == "cuda":
            torch.cuda.synchronize(mld.device)

    ids = mld.tokenize([AITS_TEXT] * B)
    mask = lengths_to_mask([196] * B, mld.max_frames, mld.device)

    def call(seed):
        g = torch.Generator(device=mld.device).manual_seed(seed)
        return mld.generate_joints(ids, mask, generator=g)

    call(0)
    sync()
    start = time.perf_counter()
    for i in range(iters):
        call(i)
    sync()
    return (time.perf_counter() - start) / iters / B


def verdict(results: dict, budget: float, exact_tokenizer: bool):
    """(comparisons, verdict) of `results` against PAPER_TARGETS at the
    relative `budget`: "pass", or "fail: " and the metrics outside it, with
    the hash tokenizer's caveat appended."""
    failures = []
    comparisons = {}
    for key, target in PAPER_TARGETS.items():
        ours = results.get(key)
        if ours is None:
            continue
        rel = abs(ours - target) / abs(target)
        ok = rel <= budget
        comparisons[key] = {"ours": float(ours), "target": target,
                            "rel_diff": round(rel, 4), "ok": ok}
        print(f"  {key:22s} ours={ours:.4f} target={target:.4f} "
              f"rel={rel * 100:.1f}% [{'ok' if ok else 'FAIL'}]")
        if not ok:
            failures.append(key)
    text = "pass" if not failures else f"fail: {', '.join(failures)}"
    if not exact_tokenizer:
        text += " (hash-tokenizer fallback — not release-grade)"
    return comparisons, text


def run(args):
    """The drill; returns (exit code, report, what it built: {"mld",
    "evaluator"} where it got that far)."""
    from mld_tpu_torch.models.mld import resolve_device

    device = resolve_device(args.device)
    root = args.assets_root
    paths = asset_paths(root, args.ckpt)
    present = {k: os.path.exists(v) for k, v in paths.items()}
    print("== asset check ==")
    for k, v in paths.items():
        print(f"  [{'ok' if present[k] else 'MISSING'}] {k}: {v}")
    report = Report(assets={k: {"path": paths[k], "present": present[k]}
                            for k in paths},
                    budget=args.budget, targets=PAPER_TARGETS, steps=[])
    built = {}
    if not present["ckpt"] or not present["data"]:
        report["verdict"] = "blocked: missing checkpoint or dataset"
        report.write(args.out)
        print(f"\nBLOCKED — fetch the release assets first "
              f"(see docstring). Report: {args.out}")
        return 2, report, built

    cfg = drill_config(root, paths, args.replications, args.cfg)
    print(f"== build + convert ({device}) ==")
    out = build(cfg, paths, present, device, report, args.trust_checkpoint)
    if out is None:
        report.write(args.out)
        return 1, report, built
    dm, mld = out
    built["mld"] = mld

    print(f"== evaluation ({args.replications} replications) ==")
    results, built["evaluator"] = evaluate(cfg, mld, dm, args.replications,
                                           not args.no_mm)
    report["results"] = {k: float(v) for k, v in results.items()}

    if not args.skip_timing:
        aits = time_aits(mld)
        report["aits_sec"] = aits
        report["aits_vs_paper"] = PAPER_AITS / aits
        print(f"  AITS {aits * 1e3:.1f} ms/motion "
              f"({PAPER_AITS / aits:.1f}x paper V100)")

    print("== verdict ==")
    report["comparisons"], report["verdict"] = verdict(
        results, args.budget, mld.tokenizer.is_exact)
    report.write(args.out)
    print(f"\nverdict: {report['verdict']}\nreport: {args.out}")
    return (0 if report["verdict"].startswith("pass") else 1), report, built


def main(argv=None):
    code, _, _ = run(parse_args(argv))
    sys.exit(code)


if __name__ == "__main__":
    main()
