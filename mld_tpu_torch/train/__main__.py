"""Training CLI of the port (the flags of the repository's ``train.py``
that apply to one card):

    python -m mld_tpu_torch.train --preset mld_humanml3d --stage vae
    python -m mld_tpu_torch.train --stage diffusion --device cpu --max_steps 2
    python -m mld_tpu_torch.train --preset mld_humanact12 --stage vae

bf16 mixed precision and rematerialisation come through ``--cfg``, as with
the repository's ``train.py``: ``model: {dtype: bfloat16}``,
``train: {remat: true}``.

Trains on the card unless ``--device`` names another; without a visible
CUDA device the default raises.
"""
import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train MLD (PyTorch port)")
    p.add_argument("--cfg", type=str, default=None, help="config yaml")
    p.add_argument("--preset", type=str, default="mld_humanml3d",
                   help="capability preset (mld_tpu_torch.config.presets)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    p.add_argument("--nodebug", action="store_true")
    p.add_argument("--resume", type=str, default=None,
                   help="experiment dir to resume")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--stage", type=str, default=None,
                   choices=["vae", "diffusion", "vae_diffusion"])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from mld_tpu_torch.config import load_config, merge_dicts
    from mld_tpu_torch.train.loop import train

    overrides = {}
    if args.batch_size:
        overrides = merge_dicts(overrides,
                                {"train": {"batch_size": args.batch_size}})
    if args.stage:
        overrides = merge_dicts(overrides, {"train": {"stage": args.stage}})
    overrides["debug"] = not args.nodebug
    cfg = load_config(args.cfg, overrides, preset=args.preset)
    if args.resume:
        cfg = cfg.replace(name=os.path.basename(args.resume.rstrip("/")))
    train(cfg, max_steps=args.max_steps, resume=bool(args.resume),
          device=args.device)


if __name__ == "__main__":
    main()
