"""Evaluation CLI of the port (the twin of the repository's ``test.py``): the
metric suite ``--replication`` times (default ``test.replication_times``),
reported as mean +- 1.96 std / sqrt(n), written as ``metrics_test.json`` and
printed as a table.

    python -m mld_tpu_torch.eval --preset mld_humanml3d --checkpoint CKPT
    python -m mld_tpu_torch.eval --device cpu --replication 1 --no_mm

Runs on the card unless ``--device`` names another; without a visible CUDA
device the default raises. ``--checkpoint`` reads a port checkpoint (a
``.pt`` file or a checkpoints directory) or a JAX ``save_params_npz`` export.
Missing datasets build the synthetic corpus; the evaluator networks load from
``eval.t2m_params_path``, the reference's ``finest.tar`` or random weights
(``eval/pipeline.py:T2MEvaluatorBundle``). The action presets
(``mld_humanact12``, ``mld_uestc``) take no tokenizer and evaluate through
their classifiers (``Evaluator.make_a2m_accumulator``); ``--gt`` is a
text-protocol pass and is ignored for them, as ``test.py`` ignores it.
"""
import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluate MLD (PyTorch port)")
    p.add_argument("--cfg", type=str, default=None, help="config yaml")
    p.add_argument("--preset", type=str, default="mld_humanml3d")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--replication", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--stage", type=str, default=None,
                   choices=["vae", "diffusion"])
    p.add_argument("--no_mm", action="store_true")
    p.add_argument("--gt", action="store_true",
                   help="also run the ground-truth-only metric pass")
    p.add_argument("--save_predictions", action="store_true",
                   help="dump the evaluated joints as npys")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from mld_tpu_torch.config import load_config, merge_dicts
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.eval.pipeline import Evaluator
    from mld_tpu_torch.models.clip_text import ClipTokenizer
    from mld_tpu_torch.models.mld import MLD, resolve_device
    from mld_tpu_torch.utils.checkpoint import load_pretrained

    device = resolve_device(args.device)
    overrides = {"debug": False}
    if args.batch_size:
        overrides = merge_dicts(overrides,
                                {"eval": {"batch_size": args.batch_size}})
    if args.replication:
        overrides = merge_dicts(
            overrides, {"test": {"replication_times": args.replication}})
    cfg = load_config(args.cfg, overrides, preset=args.preset)
    stage = args.stage or cfg.train.stage
    if stage not in ("vae", "diffusion"):
        stage = "diffusion"

    # the action presets have no text tokenizer (test.py:56)
    dm = get_datamodule(cfg, tokenizer=(
        None if cfg.model.condition == "action"
        else ClipTokenizer(cfg.model.clip_path)))
    mld = MLD(cfg, mean=dm.mean, std=dm.std, mean_eval=dm.mean_eval,
              std_eval=dm.std_eval, device=device,
              generator=torch.Generator().manual_seed(0))
    ckpt = args.checkpoint or cfg.test.checkpoints
    if ckpt:
        tops = load_pretrained(mld, ckpt)
        mld.drop_stacks()
        print(f"loaded {tops} from {ckpt}")

    exp_dir = os.path.join(cfg.logger.folder, "mld", cfg.name)
    prediction_sink, counter = None, {"n": 0}
    if args.save_predictions or cfg.test.save_predictions:
        # the motions the metrics are computed on (reference base.py:184)
        pred_dir = os.path.join(exp_dir, "predictions")
        os.makedirs(pred_dir, exist_ok=True)

        def prediction_sink(joints, lengths):
            for i, n in enumerate(np.asarray(lengths)):
                np.save(os.path.join(pred_dir,
                                     f"pred_{counter['n']:05d}.npy"),
                        joints[i, : int(n)])
                counter["n"] += 1

    evaluator = Evaluator(cfg, mld, dm)
    results = evaluator.run(
        torch.Generator(device=device).manual_seed(cfg.seed),
        replication_times=cfg.test.replication_times, stage=stage,
        with_mm=not args.no_mm, prediction_sink=prediction_sink)
    if args.gt and not evaluator.is_a2m:
        gt = evaluator.run_gt(dm.loader("test", shuffle=False))
        results.update({f"gt_only/{k}": float(v) for k, v in gt.items()})
    elif args.gt:
        print("--gt: separate GT-only pass is a t2m-protocol feature; "
              "the a2m protocol already folds GT statistics into the "
              "accumulator (gt_accuracy/FID columns above) — flag ignored")
    if prediction_sink is not None:
        print(f"saved {counter['n']} evaluated-prediction npys")
    for name, secs in sorted(evaluator.times.items()):
        print(f"{name}: {len(secs)} x, {1e3 * np.mean(secs):.1f} ms each")

    os.makedirs(exp_dir, exist_ok=True)
    out_path = args.out or os.path.join(exp_dir, "metrics_test.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    width = max(len(k) for k in results)
    print(f"\n{'metric'.ljust(width)}  value")
    for k in sorted(results):
        if k.endswith("/conf95"):
            continue
        conf = results.get(f"{k}/conf95", 0.0)
        print(f"{k.ljust(width)}  {results[k]:.4f} ± {conf:.4f}")
    print(f"\nresults written to {out_path}")


if __name__ == "__main__":
    main()
