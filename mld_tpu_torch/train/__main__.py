"""Training CLI of the port (the flags of the repository's ``train.py``):

    python -m mld_tpu_torch.train --preset mld_humanml3d --stage vae
    python -m mld_tpu_torch.train --stage diffusion --device cpu --max_steps 2
    python -m mld_tpu_torch.train --device 0 1 2 3 --cfg_assets assets.yaml
    torchrun --nproc_per_node 4 -m mld_tpu_torch.train --device cuda

bf16 mixed precision and rematerialisation come through ``--cfg``, as with
the repository's ``train.py``: ``model: {dtype: bfloat16}``,
``train: {remat: true}``. ``--cfg_assets`` is a YAML overlay merged over
the config's overrides (paths: ``train.pretrained_vae``, ``dataset.root``),
as ``train.py`` merges it.

``--device`` places the ranks of data-parallel training, one a device
(``parallel/ddp.py``; ``train.batch_size`` is the global batch):

  cuda (default)  ``train.data_parallel`` cards, or every visible card
  0 1 2 3         these card ordinals; sets ``train.data_parallel`` to
                  their number, as ``train.py --device 0 1 2 3`` does
  cuda:N          one rank on card N
  cpu             ``train.data_parallel`` gloo ranks (default one)

More CUDA ranks than visible cards raise. The ranks are started here, each
a process, on a free rendezvous port of this host; one rank runs in this
process, in a process group of one. Under ``torchrun`` (``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` set) this process is one rank of its
group, on ``cuda:LOCAL_RANK`` (or the CPU with ``--device cpu``).
"""
import argparse
import os
from typing import List, Sequence


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train MLD (PyTorch port)")
    p.add_argument("--cfg", type=str, default=None, help="config yaml")
    p.add_argument("--preset", type=str, default="mld_humanml3d",
                   help="capability preset (mld_tpu_torch.config.presets)")
    p.add_argument("--cfg_assets", type=str, default=None,
                   help="assets yaml overlay (paths)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="the global batch, over every rank")
    p.add_argument("--device", type=str, nargs="+", default=["cuda"],
                   help='"cuda" (default), "cuda:N", "cpu", or card '
                        'ordinals (--device 0 1 2 3: a rank each)')
    p.add_argument("--nodebug", action="store_true")
    p.add_argument("--resume", type=str, default=None,
                   help="experiment dir to resume")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--stage", type=str, default=None,
                   choices=["vae", "diffusion", "vae_diffusion"])
    return p.parse_args(argv)


def _ordinals(device: Sequence[str]) -> bool:
    return all(d.isdigit() for d in device)


def rank_devices(device: Sequence[str], data_parallel: int) -> List[str]:
    """The device of each rank, from ``--device`` and
    ``train.data_parallel``."""
    import torch

    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if _ordinals(device):
        ids = [int(d) for d in device]
        if len(set(ids)) != len(ids) or max(ids) >= visible:
            raise RuntimeError(
                f"--device {' '.join(device)}: {visible} CUDA device(s) "
                f"visible; each rank needs a card of its own")
        return [f"cuda:{i}" for i in ids]
    if len(device) != 1:
        raise ValueError(f"--device {' '.join(device)}: give one of cuda, "
                         f"cuda:N, cpu, or card ordinals")
    dev = torch.device(device[0])
    if dev.type == "cpu":
        return ["cpu"] * max(data_parallel, 1)
    if dev.type != "cuda":
        raise ValueError(f"--device {device[0]}: not a CUDA or CPU device")
    if dev.index is not None:
        if data_parallel > 1:
            raise ValueError(f"--device {dev} is one rank, but "
                             f"train.data_parallel={data_parallel}")
        return [str(dev)]
    world = data_parallel if data_parallel > 0 else visible
    if world == 0 or world > visible:
        raise RuntimeError(f"{world or 'no'} CUDA rank(s) asked for, "
                           f"{visible} CUDA device(s) visible")
    return [f"cuda:{i}" for i in range(world)]


def main(argv=None):
    """Train; returns the trained model when this process ran the (only,
    or torchrun's) rank, else None."""
    args = parse_args(argv)
    from mld_tpu_torch.config import load_config, merge_dicts
    from mld_tpu_torch.parallel import ddp
    from mld_tpu_torch.train.loop import train

    overrides = {}
    if args.cfg_assets:
        import yaml
        with open(args.cfg_assets) as f:
            overrides = merge_dicts(overrides, yaml.safe_load(f) or {})
    if args.batch_size:
        overrides = merge_dicts(overrides,
                                {"train": {"batch_size": args.batch_size}})
    if args.stage:
        overrides = merge_dicts(overrides, {"train": {"stage": args.stage}})
    if _ordinals(args.device):
        overrides = merge_dicts(
            overrides, {"train": {"data_parallel": len(args.device)}})
    overrides["debug"] = not args.nodebug
    cfg = load_config(args.cfg, overrides, preset=args.preset)
    if args.resume:
        cfg = cfg.replace(name=os.path.basename(args.resume.rstrip("/")))
    kw = dict(max_steps=args.max_steps, resume=bool(args.resume))

    if ddp.torchrun_env():
        device = ddp.init_from_env(
            "cuda" if _ordinals(args.device)
            or args.device[0].startswith("cuda") else "cpu")
        try:
            return train(cfg, device=device, **kw)
        finally:
            ddp.teardown()
    devices = rank_devices(args.device, cfg.train.data_parallel)
    if len(devices) > 1:
        ddp.spawn(train, devices, cfg, **kw)
        return None
    ddp.init(0, 1, devices[0])
    try:
        return train(cfg, device=devices[0], **kw)
    finally:
        ddp.teardown()


if __name__ == "__main__":
    main()
