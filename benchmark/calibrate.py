"""The readings the limits of ``correct`` are set from, for one cell, in
one process: the program on many seeds (each seed's weights loaded into
one built program, its first calls judged, one for each set of sizes the
mix cycles through), and the control, the reference one arithmetic below
the one the cell states, put in the program's place on the same calls, on
a few seeds.

    python benchmark/calibrate.py --workload t2m_b128 \
        --seeds 1,2,3,... --control-seeds 7,8,9 [--out readings.json]

Prints one JSON line a seed and the summary: for each number the largest
program reading (lower) and the smallest control reading (upper). The
file given to ``--out`` keeps every judged row's loop gap as well, by side
and seed, from which the bar of ``loop_rows_over`` is chosen.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import core  # noqa: E402
from benchmark.reference import weights as wts  # noqa: E402


def calibrate(cell_name: str, seeds, control_seeds, device="cuda",
              env=None, home=core.HERE, log=print) -> dict:
    cell = core.Cell(cell_name, home=home)
    run = core.Run(cell, seeds[0], 0.0, False, device, env)
    run.setup()
    torch = run.torch
    fam = cell.family
    shapes = {k: tuple(v.shape) for k, v in run.program.state_dict().items()}
    out = {"program": {}, "control": {}, "rows": {"program": {},
                                                  "control": {}}}
    n_calls = cell.spec["pool"]

    def reseed(seed):
        run.seed = seed
        run.weights = wts.make(shapes, seed, device)
        run.program.load_state_dict(run.weights, strict=True)
        run.inputs = fam.Inputs(cell.conf, cell.spec, seed, device)

    def judged(side, seed, recs, t0):
        rows = []
        nums = fam.judge(run.weights, recs, cell.conf, cell.spec, seed,
                         device, cell.bars, rows)
        out[side][seed] = nums
        out["rows"][side][seed] = [float("%.4g" % g) for r in rows
                                   for g in r]
        log(json.dumps({"seed": seed, "side": side, **nums,
                        "seconds": time.perf_counter() - t0}))

    for seed in seeds:
        t0 = time.perf_counter()
        reseed(seed)
        recs = []
        for n in range(n_calls):
            run.cap.record = {}
            with torch.no_grad():
                run.one_call(run.inputs.call(n))
            recs.append((n, run.cap.record))
        run.cap.record = None
        judged("program", seed, recs, t0)
    for seed in control_seeds:
        t0 = time.perf_counter()
        reseed(seed)
        recs = [(n, fam.control(run.weights, run.inputs.call(n), cell.conf,
                                run.env)) for n in range(n_calls)]
        judged("control", seed, recs, t0)
    keys = list(next(iter(out["program"].values())))
    out["lower"] = {k: max(v[k] for v in out["program"].values())
                    for k in keys}
    if out["control"]:
        out["upper"] = {k: min(v[k] for v in out["control"].values())
                        for k in keys}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    ints = [int(s) for s in a.seeds.split(",") if s]
    ctl = [int(s) for s in a.control_seeds.split(",") if s]
    res = calibrate(a.workload, ints, ctl)
    res["device"] = torch.cuda.get_device_name(0)
    res["power_limit"] = core.nvidia_smi_limit()
    line = json.dumps({"workload": a.workload, "lower": res["lower"],
                       "upper": res.get("upper"),
                       "device": res["device"],
                       "power_limit": res["power_limit"]})
    print(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, **res}, f, indent=1,
                      default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
