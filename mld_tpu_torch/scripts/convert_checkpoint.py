"""Convert a released reference checkpoint (Lightning ``.ckpt``) to a
flax-layout npz (the twin of ``scripts/convert_checkpoint.py``):

    python -m mld_tpu_torch.scripts.convert_checkpoint \\
        --ckpt models/mld_humanml3d_checkpoint/1222_mld_humanml3d_FID041.ckpt \\
        --preset mld_humanml3d --out converted_params.npz

The file is read through ``utils/checkpoint.py:load_pretrained`` (the
reference's ``vae.*`` / ``denoiser.*`` keys, every parameter present and
of the model's shape), and its modules are written as the JAX package's
``save_params_npz`` tree (``utils/convert.py:state_dict_to_flax``), which
``--checkpoint`` of either package's CLIs reads. Only the modules the file
holds are written: no ``clip`` subtree (the JAX script writes the random
tower of its ``PRNGKey(0)`` init there, which no one wants as weights; the
tower comes from an HF clone, ``models/clip_text.py:load_hf_clip_weights``).
The model is built on the card unless ``--device`` names another; without
a visible CUDA device the default raises.
"""
import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="released checkpoint -> flax-layout npz (PyTorch port)")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--preset", default="mld_humanml3d")
    p.add_argument("--cfg", default=None)
    p.add_argument("--out", default="converted_params.npz")
    p.add_argument("--trust_checkpoint", action="store_true",
                   help="unpickle a checkpoint that holds more than tensors "
                        "(runs the code it names): only for a file you "
                        "trust")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def convert(ckpt: str, cfg, device, out: str, trust: bool = False):
    """Load `ckpt` into an MLD of `cfg` on `device` and write its modules as
    a flax-layout npz at `out`; returns (the modules written, the model)."""
    import torch

    from mld_tpu_torch.models.mld import MLD
    from mld_tpu_torch.utils.checkpoint import load_pretrained, save_params_npz
    from mld_tpu_torch.utils.convert import state_dict_to_flax

    mld = MLD(cfg, device=device, generator=torch.Generator().manual_seed(0))
    tops = list(load_pretrained(mld, ckpt, trust=trust))
    mld.drop_stacks()
    state = {k: v.detach().cpu() for k, v in mld.state_dict().items()
             if k.split(".", 1)[0] in tops}
    save_params_npz(out, state_dict_to_flax(state))
    return tops, mld


def main(argv=None):
    args = parse_args(argv)
    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.models.mld import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.cfg, None, preset=args.preset)
    tops, _ = convert(args.ckpt, cfg, device, args.out,
                      args.trust_checkpoint)
    print(f"converted {args.ckpt} -> {args.out} (subtrees: {tops}; no clip "
          "subtree: hydrate the tower from a local HF clone)")
    return tops


if __name__ == "__main__":
    main()
