"""MLD's latent family, text or action condition (``mld_humanml3d``,
``mld_humanact12``): the port's ``MLD`` built from the configuration file,
a call as ``MLD.generate`` / ``generate_action`` make it, its four stages
(``condition_embedding``, ``diffusion_reverse``, ``decode_latent``,
``masked_joints``), their work, and the judge.

The judge follows the program stage by stage: each stage's reference runs
from the input the program's stage received, and the chain between stages
is checked exactly, so that a fault in any stage shows in its own number
and none is hidden or blown up by the stages before it (the reference's
DDIM loop from the program's condition, its decoder from the program's
latents, its joints from the program's features). The start is checked by
itself: the ids against the reference tokenizer, the latents against the
seed's draw.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import arith, decoders, joints, latent, text
from benchmark.reference.weights import subseed
from benchmark.traffic import generator

# JAX's precision names -> the arithmetic the port serves them in
ARITH = {"default": "bf16", "bfloat16": "bf16", "fastest": "bf16",
         "high": "tf32", "tensorfloat32": "tf32",
         "highest": "f32", "float32": "f32"}
DTYPE_ARITH = {"bfloat16": "bf16", "float32": "f32"}
# the program's methods a call passes through, by the stage each begins
HOOKS = {"condition_embedding": "text", "diffusion_reverse": "scan",
         "decode_latent": "decode", "masked_joints": "joints"}
# the loop is judged at the 90th percentile of its rows, since one motion
# in a thousand or so follows a trajectory that magnifies rounding 30-100
# times, and by the rows, per thousand judged, whose gap passes the cell's
# bar ("loop_row" under "bars" in its workloads file), so that a fault in
# a few rows shows too (PERF.md, "How correct is decided")
LOOP_Q = 0.9
NUMBERS_TEXT = ("tokens_wrong", "chain_breaks", "text_gap", "loop_gap",
                "loop_rows_over", "decode_gap", "joints_gap")
NUMBERS_ACTION = ("tokens_wrong", "chain_breaks", "loop_gap",
                  "loop_rows_over", "decode_gap", "joints_gap")


def constants(conf: dict) -> dict:
    """What the reference and the counts read from the configuration file;
    raises for what the reference does not compute."""
    m, d, s = conf["model"], conf["dataset"], conf["served"]
    sc = m["scheduler"]
    want = {"kind": "ddim", "eta": 0.0, "beta_schedule": "scaled_linear",
            "clip_sample": False, "set_alpha_to_one": False}
    bad = {k: sc[k] for k, v in want.items() if sc[k] != v}
    if bad or m["vae_type"] not in ("mld", "actor") \
            or m["denoiser_arch"] != "trans_enc" or not m["skip_connect"] \
            or m["normalize_before"] or m["clip_last_hidden"]:
        raise NotImplementedError(f"the reference computes the post-norm "
                                  f"skip trans_enc under DDIM: {bad}")
    is_text = m["condition"] == "text"
    return dict(
        text=is_text, vae_type=m["vae_type"], heads=m["num_heads"],
        denoiser_layers=m["denoiser_num_layers"], vae_layers=m["num_layers"],
        latent_size=m["latent_size"], latent_dim=m["latent_dim"],
        ff=m["ff_size"], guidance_scale=m["guidance_scale"],
        time_proj_dim=m["text_encoded_dim"] if is_text else m["latent_dim"],
        train_steps=sc["num_train_timesteps"],
        steps=sc["num_inference_timesteps"], beta_start=sc["beta_start"],
        beta_end=sc["beta_end"], steps_offset=sc["steps_offset"],
        clip_layers=m["clip_layers"], clip_heads=m["clip_heads"],
        clip_width=m["text_encoded_dim"],
        clip_arith=DTYPE_ARITH[m["clip_compute_dtype"]],
        n_joints=d["njoints"], nfeats=d["nfeats"],
        frames=d["max_motion_len"] if is_text else d["num_frames"],
        n_classes=m.get("nclasses", 0), **s)


def numbers(conf: dict) -> tuple:
    return NUMBERS_TEXT if conf["model"]["condition"] == "text" \
        else NUMBERS_ACTION


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
    initial latents from the seed and n (DDIM with eta 0 draws nothing
    else)."""

    def __init__(self, conf: dict, spec: dict, seed: int, device):
        self.c = c = constants(conf)
        self.seed, self.device = seed, device
        self.mix = generator.Mix(spec, seed, c["n_classes"])
        self.steps = torch.arange(c["frames"], device=device)
        self.g = torch.Generator(device=device)
        warm = [self.mix.call(p, generator.WARM) for p in range(spec["pool"])]
        self.buckets = [text.tokenize(b["texts"], c["text_buckets"]).shape[1]
                        if c["text"] else 0 for b in warm]
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
        b["init"] = torch.randn((b["B"], c["latent_size"], c["latent_dim"]),
                                generator=self.g, device=self.device)
        if not c["text"]:
            b["classes_dev"] = torch.as_tensor(b["classes"],
                                               device=self.device)
        return b


def call(mld, b: dict, cap) -> torch.Tensor:
    """One call as ``MLD.generate`` / ``generate_action`` make it, up to
    the joints on the device (the harness copies them to the host)."""
    if "texts" in b:
        with cap.span("tokenize"):
            ids = mld.tokenize(b["texts"])
        cap.note("ids", ids)
        cond = ids
    else:
        cond = b["classes_dev"]
    return mld.generate_joints(cond, b["mask"], init_latents=b["init"])


# ------------------------------------------------------------------ judge
def _rows(out, ref) -> torch.Tensor:
    """Each row's (one motion's) gap, |out - ref| / |ref|; every row inf
    where `out` has another shape or a value that is not finite."""
    if not torch.is_tensor(out) or tuple(out.shape) != tuple(ref.shape):
        return torch.full((ref.shape[0],), float("inf"))
    out = out.to(ref.device, torch.float32)
    if not torch.isfinite(out).all():
        return torch.full((ref.shape[0],), float("inf"))
    diff = (out - ref).flatten(1).norm(dim=1)
    return (diff / ref.flatten(1).norm(dim=1).clamp_min(1e-30)).cpu()


def _gap(out, ref) -> float:
    """The widest row's gap."""
    return float(_rows(out, ref).max())


def _same(a, b) -> bool:
    if not (torch.is_tensor(a) and torch.is_tensor(b)):
        return False
    return a.shape == b.shape and bool(torch.equal(a.to(b.device), b))


def _wrong(a, ref) -> int:
    """Entries of `a` that differ from `ref`; all of them for another
    shape or nothing."""
    if not torch.is_tensor(a) or tuple(a.shape) != tuple(ref.shape):
        return int(ref.numel())
    return int((a.to(ref.device).long() != ref.long()).sum())


def _stages(w, c, mode_text, mode):
    """The reference's stages at the given arithmetic."""
    def decode(z, mask):
        f = decoders.mld_decode if c["vae_type"] == "mld" \
            else decoders.actor_decode
        return f(w, z, mask, c, mode)

    def to_joints(feats, mask):
        if c["text"]:
            return joints.ric_joints(feats, mask, c["n_joints"],
                                     c["mean"], c["std"], mode)
        return joints.fk_joints(feats, mask, mode)

    def condition(ids):
        uncond = torch.as_tensor(text.tokenize([""], None)[:, :8],
                                 device=ids.device)
        return text.condition(w, ids, uncond, c["clip_layers"],
                              c["clip_heads"], c["clip_ln_eps"], mode_text)

    def loop(cond, init):
        return latent.sample(w, cond, init, c, mode)

    return condition, loop, decode, to_joints


def judge_one(w: dict, rec: dict, b: dict, c: dict) -> tuple:
    """The numbers of one recorded call against the f32 reference, and its
    rows' loop gaps (None where the loop was not observed)."""
    condition, loop, decode, to_joints = _stages(w, c, "f32", "f32")
    inf = float("inf")
    n = {"tokens_wrong": 0, "chain_breaks": 0, "loop_gap": inf,
         "decode_gap": inf, "joints_gap": inf}
    dev = b["mask"].device
    loop_rows = None
    n["chain_breaks"] += sum(h not in rec for h in HOOKS)
    ce, dr = rec.get("condition_embedding"), rec.get("diffusion_reverse")
    dl, mj = rec.get("decode_latent"), rec.get("masked_joints")
    if c["text"]:
        n["text_gap"] = inf
        ids_ref = torch.as_tensor(text.tokenize(b["texts"],
                                                c["text_buckets"]),
                                  device=dev)
        n["tokens_wrong"] += _wrong(rec.get("ids"), ids_ref)
        if ce:
            n["chain_breaks"] += not _same(ce[0]["cond"], rec.get("ids"))
            n["text_gap"] = _gap(ce[1], condition(ids_ref))
    else:
        classes = b["classes_dev"]
        if ce:
            n["chain_breaks"] += not _same(ce[0]["cond"], classes)
            want = torch.cat([torch.zeros_like(classes), classes])
            n["tokens_wrong"] += _wrong(ce[1], want)
    if dr:
        args = dr[0]
        n["chain_breaks"] += not (ce and _same(args["cond_emb"], ce[1]))
        n["chain_breaks"] += not _same(args["init_latents"], b["init"])
        loop_rows = _rows(dr[1], loop(args["cond_emb"],
                                      args["init_latents"]))
        n["loop_gap"] = float(torch.quantile(loop_rows, LOOP_Q)) \
            if torch.isfinite(loop_rows).all() else inf
    if dl:
        args = dl[0]
        n["chain_breaks"] += not (dr and _same(args["z"], dr[1]))
        n["chain_breaks"] += not _same(args["mask"], b["mask"])
        n["decode_gap"] = _gap(dl[1], decode(args["z"], args["mask"]))
    if mj:
        args = mj[0]
        n["chain_breaks"] += not (dl and _same(args["feats"], dl[1]))
        n["chain_breaks"] += not _same(args["mask"], b["mask"])
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
    worst = dict.fromkeys(numbers(conf), 0.0)
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
    condition, loop, decode, to_joints = _stages(
        w, c, below[c["clip_arith"]], below[served])
    with torch.no_grad(), arith.strict_f32():
        mask = b["mask"]
        rec = {}
        if c["text"]:
            ids = torch.as_tensor(text.tokenize(b["texts"],
                                                c["text_buckets"]),
                                  device=mask.device)
            rec["ids"] = ids
            cond = condition(ids)
        else:
            ids = b["classes_dev"]
            cond = torch.cat([torch.zeros_like(ids), ids])
        rec["condition_embedding"] = ({"cond": ids}, cond)
        z = loop(cond, b["init"])
        rec["diffusion_reverse"] = ({"cond_emb": cond,
                                     "init_latents": b["init"]}, z)
        feats = decode(z, mask)
        rec["decode_latent"] = ({"z": z, "mask": mask}, feats)
        j = to_joints(feats, mask).cpu()
        rec["masked_joints"] = ({"feats": feats, "mask": mask}, j)
        rec["joints"] = j
    return rec


# ------------------------------------------------------------------ work
def launches(conf: dict, b: dict, env: dict) -> dict:
    """The hand-written kernels' launches of one call, by kernel module,
    from the call's shapes: 50 K1 steps over the doubled batch; the text
    tower's K4 (12 layers over the prompts at their bucket, 12 over the
    empty prompt at 8); the decode's K3 (a self- and a cross-attention a
    layer), or under MLD_TPU_FUSED_DECODE=1 (text) one K5 entry whose
    self-attention launches K3."""
    c = constants(conf)
    arith_ = ARITH[env["MLD_TPU_MATMUL_PRECISION"]]
    B, d, T = b["B"], c["latent_dim"], c["frames"]
    H = c["heads"]
    valid = int(np.sum(b["lengths"]))
    wbytes = 2 if arith_ == "bf16" else 4
    k1 = dict(n_seq=2 * B, s=c["latent_size"] + 2, d=d, f=c["ff"],
              n_block=(c["denoiser_layers"] - 1) // 2, wbytes=wbytes,
              arith=arith_)
    out = {"k1": [k1] * c["steps"]}
    if c["text"]:
        dh = c["clip_width"] // c["clip_heads"]
        out["k4"] = ([dict(BH=B * c["clip_heads"], S=b["bucket"], Dh=dh,
                           elem=2, arith="bf16")] * c["clip_layers"]
                     + [dict(BH=c["clip_heads"], S=8, Dh=dh, elem=2,
                             arith="bf16")] * c["clip_layers"])
    dh = d // H
    self_ = dict(B=B, H=H, Sq=T, Sk=T, Dh=dh, keys=valid, elem=4, mask=True,
                 arith=arith_)
    cross = dict(B=B, H=H, Sq=T, Sk=c["latent_size"], Dh=dh,
                 keys=B * c["latent_size"], elem=4, mask=False, arith=arith_)
    if c["text"] and env.get("MLD_TPU_FUSED_DECODE") == "1":
        out["k3"] = [dict(self_, arith="f32")] * c["vae_layers"]
        out["k5"] = [dict(B=B, T=T, M=c["latent_size"], D=d, F=c["ff"],
                          n_block=(c["vae_layers"] - 1) // 2, wbytes=wbytes,
                          arith=arith_)]
    else:
        out["k3"] = [self_, cross] * c["vae_layers"]
    return out


def flops(conf: dict, b: dict) -> int:
    """Operations of one call, from its shapes: the text tower over the
    prompts at their bucket and the empty prompt at 8 (causal attention
    over the keys each query reads), the projections; 50 guided denoiser
    steps over the doubled batch with their time embedding and condition
    projection; the decoder over every frame (attention over the valid
    frames); the output layer. The joints' arithmetic is left out (under
    a thousandth of the call)."""
    c = constants(conf)
    B, d, ff, T = b["B"], c["latent_dim"], c["ff"], c["frames"]
    total = 0
    if c["text"]:
        D = c["clip_width"]
        for rows, L in ((B, b["bucket"]), (1, 8)):
            gemm = c["clip_layers"] * 2 * rows * L * (4 * D * D + 8 * D * D)
            attn = c["clip_layers"] * 4 * rows * D * L * (L + 1) // 2
            total += gemm + attn + 2 * rows * D * D
        total += 2 * 2 * B * D * d                    # the condition's Linear
    nb = (c["denoiser_layers"] - 1) // 2
    s = c["latent_size"] + 2
    enc = (2 * 2 * B * s * (c["denoiser_layers"] * (4 * d * d + 2 * d * ff)
                            + nb * 2 * d * d)
           + 4 * 2 * B * s * s * d * c["denoiser_layers"])
    tproj = c["time_proj_dim"]
    total += c["steps"] * (enc + 2 * (tproj * d + d * d))
    L = c["vae_layers"]
    rows = B * T
    valid = int(np.sum(b["lengths"]))
    dec = L * (2 * rows * (4 * d * d + 2 * d * d + 2 * d * ff)
               + 2 * B * 2 * d * d + 4 * T * valid * d + 4 * rows * d)
    if c["vae_type"] == "mld":
        dec += nb * 2 * rows * 2 * d * d
    return total + dec + 2 * rows * d * c["nfeats"]
