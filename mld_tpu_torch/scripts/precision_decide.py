"""Turn the per-stage precision study into an auditable serving-config
decision (a copy of ``scripts/precision_decide.py``, which needs no
framework; a test holds the two equal).

Reads the port's study on the card, ``docs/precision_report_torch_h100.json``
(``python -m mld_tpu_torch.scripts.precision_study``; its base="highest"
arms are the f32 measuring stick), and decides the first serving
precision config, in the original's order of cost, whose quality deltas
stay inside the budget.

Method
------
1. Noise floor: the noise_seed* arms re-run the IDENTICAL numerics as
   "highest" with a different eval seed. For every metric, the max
   |relative delta| across those arms is the sampling-noise floor: a
   precision arm below that floor carries no quality signal (the DDIM
   iteration is chaotic with respect to any perturbation).
2. Budget: BASELINE.json's parity budget is 5% on FID/R-precision. An
   arm passes if, for each gating metric, |rel delta| <= max(noise
   floor, budget).
3. Ranking: candidate serving configs in the original's order of cost,
   cheapest first (bf16 "default", then TF32 "high", then IEEE f32
   "highest"), an order measured on the TPU. On the H100 it is not
   measured end to end: the port's f32 linear layers cast their operands
   on every call, and one GEMM at bf16 has read slower than at TF32 in one
   run and faster in another (PERF.md). The decision is the first passing
   candidate in that order.

The decision JSON (``docs/precision_decision_torch_h100.json``) records
every arm's deltas, the floor, the verdict and the study's device, so that
a serving default traces to committed evidence.
"""
import argparse
import json
import os

GATING = ["FID", "Matching_score", "R_precision_top_1",
          "R_precision_top_2", "R_precision_top_3"]
# physical-unit secondary metrics (reported, not gating: they gate the
# reconstruction path, which serving precision also perturbs)
SECONDARY = ["APE_root", "APE_mean_joints", "AVE_root", "AVE_mean_joints"]
BUDGET = 0.05  # BASELINE.json: FID / R-precision within 5%

# candidate serving configs, cheapest first on the TPU. (global precision,
# per-stage overlay) exactly as bench.py would ship them; `arm` is the
# study arm that measured the config with an f32 evaluator.
CANDIDATES = [
    ("gen_bf16", "default", ""),
    ("gen_fast", "default", "decode=high"),
    ("gen_mixed_high", "default", "scan=high,decode=high"),
    ("serving_mixed", "default", "scan=highest,decode=highest"),
    ("highest", "highest", ""),
]


def rel_deltas(arm: dict, base: dict, keys) -> dict:
    out = {}
    for k in keys:
        if k in arm and k in base:
            denom = max(abs(base[k]), 1e-6)
            out[k] = abs(arm[k] - base[k]) / denom
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--report",
                   default="docs/precision_report_torch_h100.json")
    p.add_argument("--out",
                   default="docs/precision_decision_torch_h100.json")
    p.add_argument("--budget", type=float, default=BUDGET)
    args = p.parse_args(argv)

    with open(args.report) as f:
        report = json.load(f)
    base = report["highest"]
    noise_arms = sorted(k for k in report if k.startswith("noise_seed"))
    if not noise_arms:
        raise SystemExit("no noise_seed* arms in the report — the floor "
                         "is undefined; re-run the precision study "
                         "with the noise arms included")

    floor = {}
    for k in GATING + SECONDARY:
        ds = [rel_deltas(report[a], base, [k]).get(k) for a in noise_arms]
        ds = [d for d in ds if d is not None]
        if ds:
            floor[k] = max(ds)

    decision = {"report": os.path.abspath(args.report),
                "device": report.get("_device"),
                "budget": args.budget,
                "noise_arms": noise_arms,
                "noise_floor": floor,
                "arms": {}, "chosen": None}

    chosen = None
    for arm, prec, spec in CANDIDATES:
        if arm not in report:
            continue
        deltas = rel_deltas(report[arm], base, GATING + SECONDARY)
        gates = {}
        for k in GATING:
            if k in deltas:
                allowed = max(floor.get(k, 0.0), args.budget)
                gates[k] = {"delta": deltas[k], "allowed": allowed,
                            "pass": deltas[k] <= allowed}
        ok = all(g["pass"] for g in gates.values())
        decision["arms"][arm] = {
            "serving_env": {"MLD_TPU_MATMUL_PRECISION": prec,
                            "MLD_TPU_STAGE_PRECISION": spec},
            "gates": gates,
            "secondary_deltas": {k: deltas[k] for k in SECONDARY
                                 if k in deltas},
            "passes": ok,
        }
        if ok and chosen is None:
            chosen = (arm, prec, spec)
        line = "PASS" if ok else "fail"
        worst = max((g["delta"] for g in gates.values()), default=0.0)
        print(f"{arm:16s} {line}  worst gating delta {worst*100:6.2f}%  "
              f"env: precision={prec} stage='{spec}'")

    if chosen is None:
        # nothing cheaper than all-f32 passes: ship "highest"
        chosen = ("highest", "highest", "")
    decision["chosen"] = {"arm": chosen[0],
                          "MLD_TPU_MATMUL_PRECISION": chosen[1],
                          "MLD_TPU_STAGE_PRECISION": chosen[2]}
    print(f"\nchosen: {chosen[0]} -> MLD_TPU_MATMUL_PRECISION={chosen[1]} "
          f"MLD_TPU_STAGE_PRECISION='{chosen[2]}'")
    with open(args.out, "w") as f:
        json.dump(decision, f, indent=2)
    print(f"wrote {args.out}")
    return decision


if __name__ == "__main__":
    main()
