"""Trace one serving stage with ``torch.profiler`` and print the top device
ops by self time (the twin of ``scripts/profile_serving.py``).

Builds ``mld_humanml3d`` at full width with random weights, runs the stage
once to warm it, traces ``--iters`` calls, writes the Chrome trace and
aggregates the CUDA lane's events (kernels, copies, sets) by name: where
the time goes inside the stage. The matmul precision is the session's
(``MLD_TPU_MATMUL_PRECISION``, "default" when unset, as the JAX script
sets) with any ``MLD_TPU_STAGE_PRECISION`` overlay.

    python -m mld_tpu_torch.scripts.profile_serving --stage scan --batch 128
    python -m mld_tpu_torch.scripts.profile_serving --stage decode
    python -m mld_tpu_torch.scripts.profile_serving --stage total --top 10

Runs on the card unless ``--device`` names another; on the CPU the lane
read is the host's operators (their self time).
"""
import argparse
import collections
import glob
import gzip
import json
import os
import tempfile

import numpy as np

# the CUDA lane's event categories in a torch.profiler Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)


def parse_trace(trace_dir, top=30, cats=DEVICE_CATS):
    """Aggregate the complete events of categories `cats` by name, by self
    time (an event's duration less that of the events nested in it on its
    lane), from the newest trace under trace_dir. Returns (the `top` rows
    (name, us, count), the total us, the lanes read)."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no Chrome trace under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    lanes = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats:
            lanes[(e.get("pid"), e.get("tid"))].append(e)
    self_us = collections.Counter()
    count = collections.Counter()
    for lane in lanes.values():
        lane.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack = []   # [end, name] of the open events
        for e in lane:
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                self_us[stack[-1][1]] -= dur
            self_us[e["name"]] += dur
            count[e["name"]] += 1
            stack.append([ts + dur, e["name"]])
    rows = [(name, us, count[name]) for name, us in self_us.most_common(top)]
    return rows, sum(self_us.values()), sorted(lanes)


def stage_call(mld, stage: str, B: int, seed: int = 0):
    """The stage's call at batch B on random inputs, as the JAX script
    builds them."""
    import torch

    from mld_tpu_torch.models.mld import lengths_to_mask

    T = mld.max_frames
    rs = np.random.RandomState(seed)
    lengths = rs.randint(40, T + 1, B)
    mask = lengths_to_mask(lengths.tolist(), T, mld.device)
    ids = mld.tokenize(["a person walks forward and waves both hands"] * B)
    gen = torch.Generator(device=mld.device).manual_seed(7)

    def randn(*shape):
        return torch.as_tensor(rs.randn(*shape), dtype=torch.float32,
                               device=mld.device)

    if stage == "decode":
        z = randn(B, mld.latent_size, mld.latent_dim)
        return lambda: mld.decode_latent(z, mask)
    if stage == "ric":
        feats = randn(B, T, mld.nfeats)
        return lambda: mld.feats2joints(feats) * mask[..., None, None]
    if stage == "clip":
        return lambda: mld.encode_text_tokens(ids)
    if stage == "scan":
        cond = randn(2 * B, 1, mld.cfg.model.text_encoded_dim)
        return lambda: mld.diffusion_reverse(cond, gen)
    return lambda: mld.generate_joints(ids, mask, generator=gen)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="torch.profiler trace of a "
                                            "serving stage (PyTorch port)")
    p.add_argument("--stage", default="decode",
                   choices=["decode", "ric", "clip", "scan", "total"])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--keep", default=None,
                   help="keep the trace under this dir (default: tmp)")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from mld_tpu_torch.models.mld import resolve_device
    from mld_tpu_torch.utils import precision

    device = resolve_device(args.device)
    session = os.environ.get(precision.SESSION_VAR) or "default"
    with precision.matmul_precision(session):
        return _profile(args, device, session)


def _profile(args, device, session):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.utils import precision

    cuda = device.type == "cuda"
    mld = MLD(load_config(preset="mld_humanml3d"), device=device,
              generator=torch.Generator().manual_seed(0))
    fn = stage_call(mld, args.stage, args.batch)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    fn()   # warm: the kernels' first launch, the bf16 stacks
    sync()
    trace_dir = args.keep or tempfile.mkdtemp(prefix="mld_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(args.iters):
            fn()
        sync()
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"{args.stage}.trace.json"))

    rows, total, lanes = parse_trace(trace_dir, args.top,
                                     DEVICE_CATS if cuda else HOST_CATS)
    summary = {"stage": args.stage, "batch": args.batch,
               "iters": args.iters,
               "device": (torch.cuda.get_device_name(device) if cuda
                          else "cpu"),
               "lane": "cuda" if cuda else "host",
               "precision": session,
               "stage_precision": precision.stage_spec(),
               "device_total_ms": round(total / 1e3, 3),
               "per_iter_ms": round(total / 1e3 / args.iters, 3),
               "lanes": len(lanes)}
    print(json.dumps(summary, indent=2))
    print(f"{'us_total':>12}  {'us/iter':>10}  {'count':>6}  op")
    for name, us, n in rows:
        print(f"{us:12.0f}  {us / args.iters:10.1f}  {n:6d}  {name[:110]}")
    if not args.keep:
        print(f"(trace kept at {trace_dir})")
    return summary, rows


if __name__ == "__main__":
    main()
