"""MLD's raw-motion family (``novae_humanml3d``: no VAE, the trans_dec
denoiser over the motion frames, ancestral DDPM): the port's ``MLD`` built
from the configuration file, a call as ``MLD.generate`` makes it (with the
call's own seeded noise generator), its three stages
(``condition_embedding``, ``diffusion_reverse``, ``masked_joints``), their
work, and the judge.

The judge follows the program stage by stage, as ``mld_latent``'s does:
the ids against the reference tokenizer, the condition against the
reference text tower, the reference DDPM loop from the program's condition,
the seed's initial frames and the call's generator seed (every step's noise
drawn again, in the program's order, on the program's device), the joints
from the program's features. The glue is checked exactly: each stage's
input is bitwise the previous stage's output (the features the joints get
are the loop's output times the frame mask), the seed's frames and mask, and
a generator seeded with the call's noise seed.
"""
from __future__ import annotations

import torch

from benchmark.families.mld_latent import (ARITH, DTYPE_ARITH, LOOP_Q,
                                           _gap, _rows, _same, _wrong)
from benchmark.reference import arith, joints, raw, text
from benchmark.reference.weights import subseed
from benchmark.traffic import generator

# the program's methods a call passes through, by the stage each begins
HOOKS = {"condition_embedding": "text", "diffusion_reverse": "scan",
         "masked_joints": "joints"}
NUMBERS = ("tokens_wrong", "chain_breaks", "text_gap", "loop_gap",
           "loop_rows_over", "joints_gap")


def constants(conf: dict) -> dict:
    """What the reference and the counts read from the configuration file;
    raises for what the reference does not compute."""
    m, d, s = conf["model"], conf["dataset"], conf["served"]
    sc = m["scheduler"]
    want = {"kind": "ddpm", "beta_schedule": "scaled_linear",
            "clip_sample": False, "variance_type": "fixed_small",
            "prediction_type": "epsilon"}
    bad = {k: sc[k] for k, v in want.items() if sc[k] != v}
    if bad or m["vae"] or m["denoiser_arch"] != "trans_dec" \
            or m["condition"] != "text" or m["normalize_before"] \
            or m["clip_last_hidden"] or m["position_embedding"] != "learned" \
            or m["activation"] != "gelu":
        raise NotImplementedError(f"the reference computes the post-norm "
                                  f"trans_dec raw-motion denoiser under "
                                  f"DDPM: {bad}")
    return dict(
        heads=m["num_heads"], denoiser_layers=m["denoiser_num_layers"],
        latent_dim=m["latent_dim"], ff=m["ff_size"],
        guidance_scale=m["guidance_scale"],
        time_proj_dim=m["text_encoded_dim"],
        train_steps=sc["num_train_timesteps"], beta_start=sc["beta_start"],
        beta_end=sc["beta_end"], clip_layers=m["clip_layers"],
        clip_heads=m["clip_heads"], clip_width=m["text_encoded_dim"],
        clip_arith=DTYPE_ARITH[m["clip_compute_dtype"]],
        n_joints=d["njoints"], nfeats=d["nfeats"],
        frames=d["max_motion_len"], **s)


def numbers(conf: dict) -> tuple:
    return NUMBERS


def build(conf: dict, device):
    """The port's MLD of the configuration, on `device`."""
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.models.mld import MLD
    cfg = load_config(preset=conf["preset"],
                      overrides={"model": conf["model"],
                                 "dataset": conf["dataset"]})
    return MLD(cfg, device=device)


class Inputs:
    """The calls of a run on the device, drawn from the seed: call n of the
    window, the warm-up calls (one for each text bucket the sets reach),
    and each call's bucket. A call's mask comes from its lengths, its
    initial frames [B, T, nfeats] from the seed and n, and its noise
    generator (``generator``, on the device) is seeded with ``noise_seed``,
    drawn from the seed and n."""

    def __init__(self, conf: dict, spec: dict, seed: int, device):
        self.c = c = constants(conf)
        self.seed, self.device = seed, device
        self.mix = generator.Mix(spec, seed)
        self.steps = torch.arange(c["frames"], device=device)
        self.g = torch.Generator(device=device)
        warm = [self.mix.call(p, generator.WARM) for p in range(spec["pool"])]
        self.buckets = [text.tokenize(b["texts"], c["text_buckets"]).shape[1]
                        for b in warm]
        self.top = max(self.buckets)
        firsts = {}
        for p, bucket in enumerate(self.buckets):
            firsts.setdefault(bucket, warm[p])
        self._warm = [firsts[k] for k in sorted(firsts)]

    def longest(self, n: int) -> bool:
        """Whether call n is at the longest text bucket the sets reach."""
        return self.buckets[self.mix.set_of(n)] == self.top

    def warm_calls(self) -> list:
        return [self._device(dict(b), "warm:%d" % b["set"])
                for b in self._warm]

    def call(self, n: int) -> dict:
        return self._device(self.mix.call(n), str(n))

    def _device(self, b: dict, tag: str) -> dict:
        c = self.c
        b["B"] = len(b["lengths"])
        b["bucket"] = self.buckets[b["set"]]
        lengths = torch.as_tensor(b["lengths"], device=self.device)
        b["mask"] = self.steps[None] < lengths[:, None]
        self.g.manual_seed(subseed(self.seed, "latents:" + tag))
        b["init"] = torch.randn((b["B"], c["frames"], c["nfeats"]),
                                generator=self.g, device=self.device)
        b["noise_seed"] = subseed(self.seed, "noise:" + tag)
        b["generator"] = torch.Generator(device=self.device)
        b["generator"].manual_seed(b["noise_seed"])
        return b


def call(mld, b: dict, cap) -> torch.Tensor:
    """One call as ``MLD.generate`` makes it, with the call's generator,
    up to the joints on the device (the harness copies them to the
    host)."""
    with cap.span("tokenize"):
        ids = mld.tokenize(b["texts"])
    cap.note("ids", ids)
    return mld.generate_joints(ids, b["mask"], generator=b["generator"],
                               init_latents=b["init"])


# ------------------------------------------------------------------ judge
def _stages(w, c, mode_text, mode):
    """The reference's stages at the given arithmetic."""
    def condition(ids):
        uncond = torch.as_tensor(text.tokenize([""], None)[:, :8],
                                 device=ids.device)
        return text.condition(w, ids, uncond, c["clip_layers"],
                              c["clip_heads"], c["clip_ln_eps"], mode_text)

    def loop(cond, init, mask, noise_seed):
        return raw.sample(w, cond, init, mask, noise_seed, c, mode)

    def to_joints(feats, mask):
        return joints.ric_joints(feats, mask, c["n_joints"], c["mean"],
                                 c["std"], mode)

    return condition, loop, to_joints


def _seeded(g, seed: int) -> bool:
    return isinstance(g, torch.Generator) and g.initial_seed() == seed


def judge_one(w: dict, rec: dict, b: dict, c: dict) -> tuple:
    """The numbers of one recorded call against the f32 reference, and its
    rows' loop gaps over the valid frames (None where the loop was not
    observed)."""
    condition, loop, to_joints = _stages(w, c, "f32", "f32")
    inf = float("inf")
    n = {"tokens_wrong": 0, "chain_breaks": 0, "text_gap": inf,
         "loop_gap": inf, "joints_gap": inf}
    mask = b["mask"]
    loop_rows = None
    n["chain_breaks"] += sum(h not in rec for h in HOOKS)
    ce, dr, mj = (rec.get(h) for h in HOOKS)
    ids_ref = torch.as_tensor(text.tokenize(b["texts"], c["text_buckets"]),
                              device=mask.device)
    n["tokens_wrong"] += _wrong(rec.get("ids"), ids_ref)
    if ce:
        n["chain_breaks"] += not _same(ce[0]["cond"], rec.get("ids"))
        n["text_gap"] = _gap(ce[1], condition(ids_ref))
    if dr:
        args = dr[0]
        n["chain_breaks"] += not (ce and _same(args["cond_emb"], ce[1]))
        n["chain_breaks"] += not _same(args["init_latents"], b["init"])
        n["chain_breaks"] += not _same(args["mask"], mask)
        n["chain_breaks"] += not _seeded(args["generator"], b["noise_seed"])
        ref = loop(args["cond_emb"], args["init_latents"], mask,
                   b["noise_seed"])
        out = dr[1]
        if torch.is_tensor(out) and out.shape == ref.shape:
            out = out.to(ref.device) * mask[..., None]
        loop_rows = _rows(out, ref * mask[..., None])
        n["loop_gap"] = float(torch.quantile(loop_rows, LOOP_Q)) \
            if torch.isfinite(loop_rows).all() else inf
    if mj:
        args = mj[0]
        n["chain_breaks"] += not (dr and torch.is_tensor(dr[1]) and _same(
            args["feats"], dr[1].to(mask.device) * mask[..., None]))
        n["chain_breaks"] += not _same(args["mask"], mask)
        n["chain_breaks"] += not _same(rec.get("joints"), mj[1])
        n["joints_gap"] = _gap(rec.get("joints"),
                               to_joints(args["feats"], args["mask"]))
    return n, loop_rows


def judge(w: dict, recs: list, conf: dict, spec: dict, seed: int,
          device, bars: dict, rows: list = None) -> dict:
    """The worst of each number over the recorded calls [(call index,
    record)], each call's inputs drawn again from the seed; the loop's
    rows over the bar counted per thousand rows judged (every row counts
    over where the loop went unobserved). `rows`, if given, gets each
    call's loop gaps."""
    c = constants(conf)
    inputs = Inputs(conf, spec, seed, device)
    worst = dict.fromkeys(NUMBERS, 0.0)
    if not recs:
        worst["chain_breaks"] = float(len(HOOKS))
        worst["loop_rows_over"] = 1000.0
    over = judged = 0
    with torch.no_grad(), arith.strict_f32():
        for i, rec in recs:
            b = inputs.call(i)
            nums, loop_rows = judge_one(w, rec, b, c)
            for k, v in nums.items():
                worst[k] = max(worst[k], v)
            judged += b["B"]
            if loop_rows is None:
                over += b["B"]
                continue
            over += int((~(loop_rows <= bars["loop_row"])).sum())
            if rows is not None:
                rows.append(loop_rows.tolist())
    if judged:
        worst["loop_rows_over"] = 1000.0 * over / judged
    return worst


def control(w: dict, b: dict, conf: dict, env: dict) -> dict:
    """The record the reference makes in the program's place, each stage
    one arithmetic below the one the configuration and the cell state."""
    c = constants(conf)
    below = arith.BELOW
    served = ARITH[env["MLD_TPU_MATMUL_PRECISION"]]
    condition, loop, to_joints = _stages(w, c, below[c["clip_arith"]],
                                         below[served])
    with torch.no_grad(), arith.strict_f32():
        mask = b["mask"]
        ids = torch.as_tensor(text.tokenize(b["texts"], c["text_buckets"]),
                              device=mask.device)
        cond = condition(ids)
        z = loop(cond, b["init"], mask, b["noise_seed"])
        g = torch.Generator(device=mask.device)
        g.manual_seed(b["noise_seed"])
        feats = z * mask[..., None]
        j = to_joints(feats, mask).cpu()
        return {"ids": ids,
                "condition_embedding": ({"cond": ids}, cond),
                "diffusion_reverse": ({"cond_emb": cond,
                                       "init_latents": b["init"],
                                       "mask": mask, "generator": g}, z),
                "masked_joints": ({"feats": feats, "mask": mask}, j),
                "joints": j}


# ------------------------------------------------------------------ work
def launches(conf: dict, b: dict, env: dict) -> dict:
    """The hand-written kernels' launches of one call, by kernel module,
    from the call's shapes: the text tower's K4 (12 layers over the prompts
    at their bucket, 12 over the empty prompt at 8); at every DDPM step and
    decoder layer, K3's self-attention over all T frames of the doubled
    batch (no key mask) and its cross-attention to the 2 memory tokens,
    under ``raw_k3`` (K3's counts, read by this cell's own metric)."""
    c = constants(conf)
    arith_ = ARITH[env["MLD_TPU_MATMUL_PRECISION"]]
    N, T, H = 2 * b["B"], c["frames"], c["heads"]
    dh = c["clip_width"] // c["clip_heads"]
    k4 = ([dict(BH=b["B"] * c["clip_heads"], S=b["bucket"], Dh=dh, elem=2,
                arith="bf16")] * c["clip_layers"]
          + [dict(BH=c["clip_heads"], S=8, Dh=dh, elem=2,
                  arith="bf16")] * c["clip_layers"])
    dh = c["latent_dim"] // H
    self_ = dict(B=N, H=H, Sq=T, Sk=T, Dh=dh, keys=N * T, elem=4, mask=False,
                 arith=arith_)
    cross = dict(B=N, H=H, Sq=T, Sk=2, Dh=dh, keys=N * 2, elem=4, mask=False,
                 arith=arith_)
    return {"k4": k4,
            "raw_k3": [self_, cross] * (c["denoiser_layers"]
                                        * c["train_steps"])}


def flops(conf: dict, b: dict) -> int:
    """Operations of one call, from its shapes: the text tower over the
    prompts at their bucket and the empty prompt at 8 (causal attention
    over the keys each query reads), its projection, and the condition's
    projection once; at each DDPM step the time embedding once and the
    guided denoiser over every frame of the doubled batch (the frame
    embedding, each layer's self-attention projections and products over
    all T frames, the cross-attention's query and output projections a
    frame, its keys and values for the 2 memory tokens a sequence and its
    products over them, the FFN, the output projection). The CFG combine,
    the DDPM update and the joints are left out (under a thousandth of the
    call)."""
    c = constants(conf)
    B, d, ff, T = b["B"], c["latent_dim"], c["ff"], c["frames"]
    D = c["clip_width"]
    total = 0
    for rows, L in ((B, b["bucket"]), (1, 8)):
        gemm = c["clip_layers"] * 2 * rows * L * (4 * D * D + 8 * D * D)
        attn = c["clip_layers"] * 4 * rows * D * L * (L + 1) // 2
        total += gemm + attn + 2 * rows * D * D
    N = 2 * B
    rows = N * T
    total += 2 * N * D * d                               # the condition
    layer = (2 * rows * (4 * d * d + 2 * d * d + 2 * d * ff)
             + 2 * N * 2 * 2 * d * d                     # cross k, v
             + 4 * rows * T * d + 4 * rows * 2 * d)      # attention
    step = (2 * (c["time_proj_dim"] * d + d * d)
            + 2 * 2 * rows * c["nfeats"] * d
            + c["denoiser_layers"] * layer)
    return int(total + c["train_steps"] * step)
