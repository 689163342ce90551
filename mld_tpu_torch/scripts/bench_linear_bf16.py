"""The bf16 linear kernel (``ops/linear_bf16.py``) at the served shapes,
beside its bound and its plain version.

Each shape of SHAPES (the raw-motion denoiser's, the t2m plain decode's,
the ACTOR decode's, then edges the kernel must take) is run as
``linear_bf16`` (event ms and device ms) and as its plain version,
``precision.linear_plain`` in bf16: on the card that is the path the kernel
replaced, the yardstick (``x.bfloat16()``, ``w.bfloat16()``,
``torch.mm(..., out_dtype=float32)`` and ``y + b``, four launches). The
bound is the larger of the operations over the bf16 peak and x read once
plus y written once (f32) over the memory rate; weights and bias are
counted once as well. The kernel's whole result is held against the plain
version on the CPU within RTOL of scale (``chip_smoke.py``'s
PREC_GEMM_RTOL), and its one call must count one launch.

    python -m mld_tpu_torch.scripts.bench_linear_bf16 [--json out.json]

Runs on the card; ``--device cpu`` runs the plain version alone (no
kernel: its times are "not measured").
"""
import argparse
import json

from mld_tpu_torch.scripts import _bench

# (label, M, K, N, bias): raw_b32's denoiser (64 rows after CFG x 196
# frames; the time embedding's 64 rows, the memory's 64 x 2), the t2m plain
# decode at B=128 and B=512, the ACTOR decode at B=128, then edges: no
# bias, one row, a K too deep for one block's shared memory (segments), rows
# of neither 16 nor 8 bytes
SHAPES = (
    ("raw pose_embd", 12544, 263, 512, True),
    ("raw qkv", 12544, 512, 1536, True), ("raw out", 12544, 512, 512, True),
    ("raw ffn1", 12544, 512, 1024, True), ("raw ffn2", 12544, 1024, 512, True),
    ("raw pose_proj", 12544, 512, 263, True),
    ("raw time", 64, 768, 512, True), ("raw memory", 128, 512, 512, True),
    ("t2m qkv b128", 25088, 256, 768, True),
    ("t2m out b128", 25088, 256, 256, True),
    ("t2m ffn1 b128", 25088, 256, 1024, True),
    ("t2m ffn2 b128", 25088, 1024, 256, True),
    ("t2m skip b128", 25088, 512, 256, True),
    ("t2m final b128", 25088, 256, 263, True),
    ("t2m qkv b512", 100352, 256, 768, True),
    ("t2m ffn2 b512", 100352, 1024, 256, True),
    ("a2m ffn1", 7680, 256, 1024, True), ("a2m ffn2", 7680, 1024, 256, True),
    ("a2m final", 7680, 256, 150, True),
    ("edge no bias", 64, 768, 768, False), ("edge one row", 1, 768, 768, False),
    ("edge segments", 300, 3072, 768, True),
    ("edge odd rows", 129, 37, 70, False),
)
RTOL = 1e-5


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the bf16 linear kernel")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--shapes", nargs="*", default=None,
                   help="labels of SHAPES to run (default: all)")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def operands(torch, M, K, N, bias, seed=0):
    """x [M, K], w [N, K] (scaled by K^-1/2) and b [N] or None on the CPU,
    from `seed`."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    w = torch.randn(N, K, generator=g) * K ** -0.5
    return x, w, torch.randn(N, generator=g) if bias else None


def run_shape(torch, device, label, M, K, N, bias, iters):
    """One shape: the kernel's times, launches and error of scale against
    the plain version on the CPU (None on the CPU), the plain version's
    times on `device` and the bound."""
    from mld_tpu_torch.ops.linear_bf16 import linear_bf16
    from mld_tpu_torch.utils import precision, trace

    x, w, b = operands(torch, M, K, N, bias)
    cx, cw = x.to(device), w.to(device)
    cb = None if b is None else b.to(device)
    nbytes = 4 * (M * K + M * N + N * K + (N if bias else 0))
    row = {"label": label, "M": M, "K": K, "N": N, "bias": bias,
           **_bench.bound_ms(2 * M * K * N, nbytes, "bf16")}

    def plain():
        return precision.linear_plain(cx, cw, cb, "bf16")

    row["plain_ms"] = _bench.time_ms(plain, device, iters)
    row["plain_device_ms"] = _bench.device_ms(plain, device)
    if device.type != "cuda":
        row.update(ms=None, device_ms=None, share=None, launches=None,
                   rel_err=None)
        return row
    before = trace.COUNTS["launch.lin.bf16"]
    got = linear_bf16(cx, cw, cb).cpu()
    row["launches"] = trace.COUNTS["launch.lin.bf16"] - before
    want = precision.linear_plain(x, w, b, "bf16")
    row["rel_err"] = ((got - want).abs().max() / want.abs().max()).item()

    def kernel():
        return linear_bf16(cx, cw, cb)

    row["ms"] = _bench.time_ms(kernel, device, iters, 3)
    row["device_ms"] = _bench.device_ms(kernel, device)
    row["share"] = row["bound_ms"] / (row["device_ms"] or row["ms"])
    return row


def main(argv=None):
    import torch

    args = parse_args(argv)
    device = _bench.resolve_device(args.device)
    report = {**_bench.header(device), "rows": []}
    for label, M, K, N, bias in SHAPES:
        if args.shapes and label not in args.shapes:
            continue
        r = run_shape(torch, device, label, M, K, N, bias, args.iters)
        report["rows"].append(r)
        share = "-" if r["share"] is None else f"{100 * r['share']:.1f}%"
        print(f"{label:16s} [{M}, {K}] x [{K}, {N}]: kernel "
              f"{_text(r['ms'])} ms (device {_text(r['device_ms'])}), bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), share {share}; plain "
              f"{_text(r['plain_ms'])} ms (device "
              f"{_text(r['plain_device_ms'])}); err {r['rel_err']}",
              flush=True)
        if r["rel_err"] is not None and not (r["rel_err"] <= RTOL
                                             and r["launches"] == 1):
            raise RuntimeError(f"{label}: the kernel is {r['rel_err']:.3e} "
                               f"of scale from its plain version, "
                               f"{r['launches']} launches counted")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


def _text(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


if __name__ == "__main__":
    main()
