"""Trace one serving stage with ``torch.profiler`` and print the top device
ops by self time (the twin of ``scripts/profile_serving.py``), and the
program's spans.

Builds ``--preset`` (default ``mld_humanml3d``; ``novae_humanml3d`` for
the raw-motion loop, whose decoder layers and ancestral draws have spans
of their own, with ``--train-timesteps`` to cut its DDPM-1000) at full
width with random weights, runs the stage
once to warm it, traces ``--iters`` calls with the program's spans on
(``utils/trace.py``), writes the Chrome trace and aggregates the CUDA
lane's events (kernels, copies, sets) by name: where the time goes inside
the stage. Beside it, each ``mld.*`` span with its count, its host self
time (its duration less its child spans') and the device idle time that
opens inside it (the gaps between device events whose start finds it the
innermost span open on the host). The matmul precision is the session's
(``MLD_TPU_MATMUL_PRECISION``, "default" when unset, as the JAX script
sets) with any ``MLD_TPU_STAGE_PRECISION`` overlay.

    python -m mld_tpu_torch.scripts.profile_serving --stage scan --batch 128
    python -m mld_tpu_torch.scripts.profile_serving --stage decode
    python -m mld_tpu_torch.scripts.profile_serving --stage total --top 10
    python -m mld_tpu_torch.scripts.profile_serving --preset \
        novae_humanml3d --train-timesteps 10 --stage total --batch 32

Runs on the card unless ``--device`` names another; on the CPU the lane
read is the host's operators (their self time).
"""
import argparse
import bisect
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


def _load_events(trace_dir):
    """The events of the newest Chrome trace under trace_dir."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no Chrome trace under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def parse_trace(trace_dir, top=30, cats=DEVICE_CATS):
    """Aggregate the complete events of categories `cats` by name, by self
    time (an event's duration less that of the events nested in it on its
    lane), from the newest trace under trace_dir. Returns (the `top` rows
    (name, us, count), the total us, the lanes read)."""
    events = _load_events(trace_dir)
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


def device_intervals(events, windows) -> list:
    """The device's events as sorted [(start, end)] us on the host's
    clock. A device event cannot start before the runtime call that issued
    it (same ``correlation``, timed on the host), so the largest lead of an
    event over its call, among the events issued in a window (sorted
    window starts, us), is how early the device's clock reads there, and
    the window's events move by it (by nothing where none leads); on the
    card the device's times drifted early by up to a few ms within a
    profiler session."""
    issued = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    device = [(float(e["ts"]), float(e.get("dur", 0)),
               issued.get(e.get("args", {}).get("correlation")))
              for e in events if e.get("cat") in DEVICE_CATS]
    shifts = [0.0] * max(len(windows), 1)
    for ts, _, launch in device:
        if launch is not None:
            w = _window(windows, launch)
            shifts[w] = max(shifts[w], launch - ts)
    out = []
    for ts, dur, launch in device:
        shift = shifts[_window(windows, ts if launch is None else launch)]
        out.append((ts + shift, ts + dur + shift))
    return sorted(out)


def _window(starts, t) -> int:
    return max(bisect.bisect_right(starts, t) - 1, 0)


def span_table(trace_dir):
    """The program's spans in the newest trace under trace_dir: [(name,
    count, host self us, device idle us or None)], in the order they first
    open. Self time is a span's duration less that of the ``mld.*`` spans
    directly inside it on its lane; the idle time is that of the gaps
    between the device's events, over the spans' extent, whose start finds
    the span the innermost one open on the host (None without a device
    lane). The device's times are moved onto the host's clock window by
    window, a window from one outermost span to the next
    (``device_intervals``)."""
    events = [e for e in _load_events(trace_dir) if e.get("ph") == "X"]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][len("mld."):], (e.get("pid"), e.get("tid")))
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("mld.")),
                   key=lambda x: (x[0], -x[1]))
    count, self_us, order = collections.Counter(), collections.Counter(), {}
    stacks = collections.defaultdict(list)     # lane -> [end, name] open
    roots = []                                 # starts of outermost spans
    for start, end, name, lane in spans:
        stack = stacks[lane]
        while stack and stack[-1][0] <= start:
            stack.pop()
        if stack:
            self_us[stack[-1][1]] -= end - start
        else:
            roots.append(start)
        self_us[name] += end - start
        count[name] += 1
        order.setdefault(name, len(order))
        stack.append([end, name])
    device = device_intervals(events, roots)
    idle = None
    if device and spans:
        idle = collections.Counter()
        t0, t1 = spans[0][0], max(s[1] for s in spans)
        edge = t0
        for start, end in device + [(t1, t1)]:
            if start > edge and t0 <= edge < t1:
                inside = [s for s in spans if s[0] <= edge < s[1]]
                if inside:
                    inner = min(inside, key=lambda s: s[1] - s[0])
                    idle[inner[2]] += min(start, t1) - edge
            edge = max(edge, end)
    return [(name, count[name], self_us[name],
             None if idle is None else idle[name])
            for name in sorted(order, key=order.get)]


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
        return lambda: mld.diffusion_reverse(cond, gen, mask=mask)
    return lambda: mld.generate_joints(ids, mask, generator=gen)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="torch.profiler trace of a "
                                            "serving stage (PyTorch port)")
    p.add_argument("--stage", default="decode",
                   choices=["decode", "ric", "clip", "scan", "total"])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--preset", default="mld_humanml3d")
    p.add_argument("--train-timesteps", type=int, default=None,
                   help="cut the schedule's train timesteps (the steps of "
                        "ancestral DDPM)")
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
    from mld_tpu_torch.utils import precision, trace

    cuda = device.type == "cuda"
    overrides = ({} if args.train_timesteps is None else
                 {"model": {"scheduler": {
                     "num_train_timesteps": args.train_timesteps}}})
    mld = MLD(load_config(preset=args.preset, overrides=overrides),
              device=device, generator=torch.Generator().manual_seed(0))
    fn = stage_call(mld, args.stage, args.batch)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    fn()   # warm: the kernels' first launch, the bf16 stacks
    sync()
    trace_dir = args.keep or tempfile.mkdtemp(prefix="mld_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    was = trace.enabled()
    trace.enable(True)
    try:
        with profile(activities=acts) as prof:
            for _ in range(args.iters):
                fn()
            sync()
    finally:
        trace.enable(was)
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"{args.stage}.trace.json"))

    rows, total, lanes = parse_trace(trace_dir, args.top,
                                     DEVICE_CATS if cuda else HOST_CATS)
    summary = {"preset": args.preset, "stage": args.stage,
               "batch": args.batch,
               "iters": args.iters,
               "device": (torch.cuda.get_device_name(device) if cuda
                          else "cpu"),
               "lane": "cuda" if cuda else "host",
               "precision": session,
               "stage_precision": precision.stage_spec(),
               "device_total_ms": round(total / 1e3, 3),
               "per_iter_ms": round(total / 1e3 / args.iters, 3),
               "lanes": len(lanes)}
    spans = span_table(trace_dir)
    summary["spans"] = [{"span": name, "count": n, "host_self_us": us,
                         "device_idle_us": idle}
                        for name, n, us, idle in spans]
    print(json.dumps({k: v for k, v in summary.items() if k != "spans"},
                     indent=2))
    print(f"{'us_total':>12}  {'us/iter':>10}  {'count':>6}  op")
    for name, us, n in rows:
        print(f"{us:12.0f}  {us / args.iters:10.1f}  {n:6d}  {name[:110]}")
    print(f"{'count/iter':>10}  {'host self us/iter':>17}  "
          f"{'device idle us/iter':>19}  span")
    for name, n, us, idle in spans:
        idle_s = "-" if idle is None else f"{idle / args.iters:.1f}"
        print(f"{n / args.iters:10.1f}  {us / args.iters:17.1f}  "
              f"{idle_s:>19}  mld.{name}")
    if not args.keep:
        print(f"(trace kept at {trace_dir})")
    return summary, rows


if __name__ == "__main__":
    main()
