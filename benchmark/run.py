"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics. The last line of standard output
is the result (JSON); the numbers that decided ``correct`` end standard
error, each beside its limit. Without a visible CUDA device, or with fewer
than the cell asks for, it exits with 2 and prints no result; if a JAX
module was loaded in this process it exits with 3.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import core  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: {args.workload} needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = core.execute(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", bench=bench, chips=chips)
    bad = core.forbidden_modules()
    if bad:
        print(f"no result: modules {', '.join(bad)} were loaded",
              file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
