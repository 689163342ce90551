"""Operation counts of the MLD pipeline (the twin of
``scripts/flops.py``), with the JAX report's keys:

    python -m mld_tpu_torch.scripts.flops [--preset mld_humanml3d] \\
        [--batch 1] [--device cuda]

Each stage is run once on seeded random weights and counted as it executes
(``utils/flops.py``: aten ops through ``FlopCounterMode`` plus the kernels'
counters): ``generate_feats`` (text -> features, the sampler's 50 steps
counted each), ``denoiser_step`` (one ``MLD.denoise`` call at t = 500 over
the CFG batch), ``vae_encode``, ``vae_decode``, ``clip_text`` (the tower on
the B prompts) and ``param_count``. ``bytes_accessed`` (XLA's bytes of its
fused program) has no torch counterpart and is null. ``generate_parts``
breaks ``generate_feats`` into its parts, whose sum it equals. Runs on the
card unless ``--device`` names another; without a visible CUDA device the
default raises.
"""
import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MLD operation counts "
                                            "(PyTorch port)")
    p.add_argument("--preset", default="mld_humanml3d")
    p.add_argument("--cfg", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--length", type=int, default=196)
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def stage(flops: int) -> dict:
    return {"flops": float(flops), "bytes_accessed": None}


def analyze(mld, B: int, length: int) -> dict:
    """The report for `mld` at B prompts of `length` frames."""
    import torch

    from mld_tpu_torch.models.mld import lengths_to_mask
    from mld_tpu_torch.utils.flops import count, generate_parts, parts_total

    dev = mld.device
    T = mld.max_frames
    token_ids = torch.zeros((B, 77), dtype=torch.long, device=dev)
    mask = lengths_to_mask([min(length, T)] * B, T, dev)
    g = torch.Generator(device=dev).manual_seed(0)

    parts = generate_parts(mld, token_ids, mask, g)
    if parts["whole"] != parts_total(parts):
        raise RuntimeError(f"generate_feats counts {parts['whole']} "
                           f"operations, its parts {parts_total(parts)}")
    report = {"generate_feats": stage(parts["whole"])}

    sample = torch.zeros((B, mld.latent_size, mld.latent_dim), device=dev)
    model_in = torch.cat([sample, sample]) if mld.do_cfg else sample
    cond = torch.zeros((2 * B if mld.do_cfg else B, 1,
                        mld.cfg.model.text_encoded_dim), device=dev)
    report["denoiser_step"] = stage(count(
        lambda: mld.denoise(model_in, 500, cond)))
    if mld.vae is not None:
        feats = torch.zeros((B, T, mld.nfeats), device=dev)
        report["vae_encode"] = stage(count(
            lambda: mld.encode_motion(feats, mask)))
        z = torch.zeros((B, mld.latent_size, mld.latent_dim), device=dev)
        report["vae_decode"] = stage(count(lambda: mld.decode_latent(z,
                                                                     mask)))
    if mld.clip is not None:
        report["clip_text"] = stage(count(
            lambda: mld.encode_text_tokens(token_ids)))
    report["param_count"] = sum(p.numel() for p in mld.parameters())
    report["generate_parts"] = parts
    return report


def main(argv=None):
    args = parse_args(argv)
    import torch

    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.models.mld import MLD, resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.cfg, None, preset=args.preset)
    mld = MLD(cfg, device=device, generator=torch.Generator().manual_seed(0))
    report = analyze(mld, args.batch, args.length)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
