"""Demo CLI of the port (the twin of the repository's ``demo.py``): text
prompts (or action classes, latent-prior draws, a VAE reconstruction) ->
motion npy files.

Reference surface (demo.py:23-333): --example file of "length text" lines,
--replication, --allinone; outputs [nframes, 22, 3] npy + the prompt txt.

    python -m mld_tpu_torch.demo --example demo/example.txt --out results/demo
    python -m mld_tpu_torch.demo --text "a person walks" --length 120
    python -m mld_tpu_torch.demo --task action --action 3 7
    python -m mld_tpu_torch.demo --device cpu --cfg tiny.yaml --example demo/example.txt

Weights: seeded random (generator seed 0, as the JAX demo's PRNGKey(0)),
or ``--checkpoint``: a JAX ``save_params_npz`` export, a port checkpoint
file or directory, or a released reference Lightning ``.ckpt``
(``utils/checkpoint.py``; a file holding more than tensors only with
``--trust_checkpoint``). Replication ``rep`` draws from
``torch.Generator(device).manual_seed(rep)`` where the JAX demo takes
``PRNGKey(rep)``. Runs on the card unless ``--device`` names another;
without a visible CUDA device the default raises.
"""
import argparse
import os
import sys
import time

import numpy as np


def load_example_input(txt_path):
    """Parse "length text" lines (demo_utils.py:6-21 semantics)."""
    texts, lens = [], []
    with open(txt_path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            head = s.split(" ")[0]
            lens.append(int(head))
            texts.append(s[len(head) + 1:])
    return texts, lens


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MLD demo (PyTorch port)")
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--preset", type=str, default="mld_humanml3d")
    p.add_argument("--example", type=str, default=None,
                   help='file of "length text" lines')
    p.add_argument("--text", type=str, nargs="*", default=None)
    p.add_argument("--length", type=int, nargs="*", default=None)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="JAX .npz / port checkpoint / reference .ckpt")
    p.add_argument("--trust_checkpoint", action="store_true",
                   help="unpickle a --checkpoint that holds more than "
                        "tensors (runs the code it names): only for a "
                        "file you trust")
    p.add_argument("--out", type=str, default="results/demo")
    p.add_argument("--task", type=str, default="text_motion",
                   choices=["text_motion", "action", "random_sampling",
                            "reconstruction"],
                   help="text->motion, action->motion, latent-prior "
                        "sampling, or VAE reconstruction of a feature npy")
    p.add_argument("--action", type=int, nargs="*", default=None,
                   help="action class ids for --task action "
                        "(e.g. --action 3 7; use an action preset)")
    p.add_argument("--motion", type=str, default=None,
                   help="[T, nfeats] feature npy for --task reconstruction")
    p.add_argument("--replication", type=int, default=1)
    p.add_argument("--allinone", action="store_true")
    p.add_argument("--render", action="store_true",
                   help="write skeleton mp4/gif per sample")
    p.add_argument("--interactive", action="store_true",
                   help='read "length text" lines from stdin '
                        '(reference keyboard-input mode)')
    p.add_argument("--device", type=str, default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def main(argv=None):
    """Run the task; returns {"files": [npy paths written], "times":
    [seconds of each text replication's generate call]}."""
    args = parse_args(argv)
    import torch

    from mld_tpu_torch.config import load_config
    from mld_tpu_torch.data.datamodule import get_datamodule
    from mld_tpu_torch.models.mld import MLD, resolve_device
    from mld_tpu_torch.utils.checkpoint import load_pretrained

    device = resolve_device(args.device)
    if args.task == "action" and args.preset == "mld_humanml3d":
        args.preset = "mld_humanact12"  # action task needs an a2m preset
    cfg = load_config(args.cfg, None, preset=args.preset)
    dm = get_datamodule(cfg)
    mld = MLD(cfg, mean=dm.mean, std=dm.std, device=device,
              generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        load_pretrained(mld, args.checkpoint, trust=args.trust_checkpoint)
        mld.drop_stacks()
        print(f"loaded checkpoint {args.checkpoint}")

    if args.task == "action":
        return run_action_task(args, cfg, mld)
    if args.task in ("random_sampling", "reconstruction"):
        return run_latent_tasks(args, cfg, mld, dm)

    if args.interactive:
        texts, lengths = [], []
        print('enter "length text" lines (empty line to finish):')
        for line in sys.stdin:
            s = line.strip()
            if not s:
                break
            head = s.split(" ")[0]
            lengths.append(int(head))
            texts.append(s[len(head) + 1:])
        if not texts:
            return {"files": [], "times": []}
    elif args.example:
        texts, lengths = load_example_input(args.example)
    elif args.text:
        texts = args.text
        lengths = args.length or [cfg.dataset.max_motion_len] * len(texts)
    else:
        texts = ["a person walks forward and waves"]
        lengths = [96]
    lengths = [min(l, cfg.dataset.max_motion_len) for l in lengths]

    os.makedirs(args.out, exist_ok=True)
    all_reps, times, files = [], [], []
    for rep in range(args.replication):
        t0 = time.perf_counter()
        joints_list = mld.generate(
            texts, lengths, generator=torch.Generator(
                device=device).manual_seed(rep))
        times.append(time.perf_counter() - t0)
        all_reps.append(joints_list)
        for i, joints in enumerate(joints_list):
            stem = f"{args.task}_{lengths[i]}_batch0_{i}"
            if args.replication > 1:
                stem += f"_{rep}"
            files.append(os.path.join(args.out, stem + ".npy"))
            np.save(files[-1], joints)
            with open(os.path.join(args.out, stem + ".txt"), "w") as f:
                f.write(texts[i])
            print(f"saved {stem}.npy  [{joints.shape}]  '{texts[i]}'")
            if args.render:
                from mld_tpu_torch.render.skeleton import \
                    save_skeleton_animation
                save_skeleton_animation(
                    joints, os.path.join(args.out, stem + ".gif"),
                    title=texts[i])

    # timing stats (demo.py:293-313 COUNT_TIME parity; first rep = warm-up)
    if len(times) > 1:
        steady = times[1:]
        per_motion = sum(steady) / (len(steady) * len(texts))
        total_frames = sum(lengths) * len(steady)
        fps = total_frames / sum(steady)
        print(f"timing: {per_motion * 1e3:.1f} ms/motion  {fps:.0f} frames/s "
              f"(over {len(steady)} post-compile replications)")

    if args.allinone:
        T = max(lengths)
        stacked = np.zeros((len(texts), args.replication, T, 22, 3),
                           np.float32)
        for r, joints_list in enumerate(all_reps):
            for i, j in enumerate(joints_list):
                stacked[i, r, : len(j)] = j
        np.save(os.path.join(args.out, f"{args.task}_allinone.npy"), stacked)
        print(f"saved allinone {stacked.shape}")
    return {"files": files, "times": times}


def run_action_task(args, cfg, mld):
    """action class ids -> [len, 24, 3] npy (+optional render) per sample,
    matching the t2m demo ergonomics (one-command a2m sampling)."""
    import torch

    from mld_tpu_torch.data.a2m import HUMANACT12_ACTIONS

    actions = args.action if args.action else [0, 1]
    bad = [a for a in actions if not 0 <= a < cfg.model.nclasses]
    if bad:
        raise ValueError(f"action ids {bad} out of range "
                         f"[0, {cfg.model.nclasses})")
    lengths = args.length or [cfg.dataset.num_frames] * len(actions)
    os.makedirs(args.out, exist_ok=True)
    names = (HUMANACT12_ACTIONS if cfg.dataset.name == "humanact12"
             else {})
    files = []
    for rep in range(args.replication):
        joints_list = mld.generate_action(
            actions, lengths, generator=torch.Generator(
                device=mld.device).manual_seed(rep))
        for i, joints in enumerate(joints_list):
            label = names.get(actions[i], f"class{actions[i]}")
            stem = f"action_{actions[i]}_{label}_batch0_{i}"
            if args.replication > 1:
                stem += f"_{rep}"
            files.append(os.path.join(args.out, stem + ".npy"))
            np.save(files[-1], joints)
            print(f"saved {stem}.npy  [{joints.shape}]")
            if args.render:
                from mld_tpu_torch.render.skeleton import \
                    save_skeleton_animation
                save_skeleton_animation(
                    joints, os.path.join(args.out, stem + ".gif"),
                    title=label)
    return {"files": files, "times": []}


def run_latent_tasks(args, cfg, mld, dm):
    """random_sampling / reconstruction tasks (demo.py:223-289 surface)."""
    import torch

    from mld_tpu_torch.models.mld import lengths_to_mask

    os.makedirs(args.out, exist_ok=True)
    T = cfg.dataset.max_motion_len
    files = []
    if args.task == "random_sampling":
        n = max(cfg.test.num_samples, len(args.length or [])) or 4
        lengths = args.length or [T] * n
        mask = lengths_to_mask(list(lengths), T, mld.device)
        for rep in range(args.replication):
            z = torch.randn(
                len(lengths), mld.latent_size, mld.latent_dim,
                device=mld.device,
                generator=torch.Generator(device=mld.device).manual_seed(rep))
            joints = mld.gen_from_latent(z, mask).cpu().numpy()
            for i, L in enumerate(lengths):
                stem = f"random_sampling_{L}_batch0_{i}_{rep}"
                files.append(os.path.join(args.out, stem + ".npy"))
                np.save(files[-1], joints[i, :L])
                print(f"saved {stem}.npy")
    else:  # reconstruction
        if not args.motion:
            raise ValueError("--task reconstruction needs --motion feats npy")
        feats = np.load(args.motion).astype(np.float32)
        L = min(len(feats), T)
        motion = np.zeros((1, T, feats.shape[-1]), np.float32)
        motion[0, :L] = (feats[:L] - dm.mean) / dm.std
        mask = lengths_to_mask([L], T, mld.device)
        joints, joints_ref = mld.recon_from_motion(
            torch.from_numpy(motion), mask,
            generator=torch.Generator(device=mld.device).manual_seed(0))
        stem = os.path.join(args.out, f"reconstruction_{L}")
        files += [stem + ".npy", stem + "_ref.npy"]
        np.save(stem + ".npy", joints.cpu().numpy()[0, :L])
        np.save(stem + "_ref.npy", joints_ref.cpu().numpy()[0, :L])
        print(f"saved {stem}.npy and reference joints")
    return {"files": files, "times": []}


if __name__ == "__main__":
    main()
