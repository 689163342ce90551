"""Export generated motions to binary FBX (the port's twin of
``scripts/fbx_export.py``; reference surface: scripts/fbx_output.py, bpy
keyframing of a licensed SMPL rig; here the dependency-free binary FBX 7.4
writer ``mld_tpu_torch/export/fbx.py``).

Inputs, in the formats the port's CLIs produce:

  --npy results/demo/*.npy      python -m mld_tpu_torch.demo joints
                                [T, 22, 3] -> skeleton with translation
                                animation
  --npz results/*_fit.npz       python -m mld_tpu_torch.fit output (rot6d +
                                trans) -> SMPL rig with rotation animation
  --pkl-dir results/.../        the fit's --ply per-frame motion_%04d.pkl
                                tree ({pose, cam}, reference schema) ->
                                SMPL rig with rotation animation

    python -m mld_tpu_torch.scripts.fbx_export --npy results/demo/walk_120_batch0_0.npy

Host-only work (numpy, struct, zlib): no device is touched.
"""
import argparse
import glob
import os
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--npy", nargs="*", default=[],
                   help="joints npy files [T, J, 3]")
    p.add_argument("--npz", nargs="*", default=[],
                   help="fit npz files (rot6d + trans)")
    p.add_argument("--pkl-dir", nargs="*", default=[],
                   help="fit --ply dirs of per-frame motion_%%04d.pkl")
    p.add_argument("--fps", type=float, default=20.0)
    p.add_argument("--out", default=None,
                   help="output dir (default: alongside input)")
    return p.parse_args(argv)


def main(argv=None):
    """Write one FBX an input; returns the paths written."""
    args = parse_args(argv)
    import torch

    from mld_tpu_torch.data.humanml.param_util import (KIT_KINEMATIC_CHAIN,
                                                       T2M_KINEMATIC_CHAIN,
                                                       parents_from_chains)
    from mld_tpu_torch.export import export_skeleton_fbx, export_smpl_fbx
    from mld_tpu_torch.ops.rotation import rotation_6d_to_axis_angle

    def out_path(src, suffix=".fbx"):
        base = os.path.splitext(os.path.basename(src.rstrip("/")))[0]
        d = args.out or os.path.dirname(src.rstrip("/")) or "."
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, base + suffix)

    written = []
    for f in args.npy:
        joints = np.load(f)
        if joints.ndim != 3 or joints.shape[-1] != 3:
            print(f"skip {f}: expected [T, J, 3], got {joints.shape}")
            continue
        J = joints.shape[1]
        chains = T2M_KINEMATIC_CHAIN if J == 22 else KIT_KINEMATIC_CHAIN
        parents = parents_from_chains(J, chains)
        dst = out_path(f)
        export_skeleton_fbx(dst, joints, parents, fps=args.fps)
        written.append(dst)
        print(f"{f} -> {dst} ({joints.shape[0]} frames, {J} joints)")

    for f in args.npz:
        data = np.load(f)
        poses = rotation_6d_to_axis_angle(
            torch.from_numpy(np.asarray(data["rot6d"], np.float32))).numpy()
        dst = out_path(f)
        export_smpl_fbx(dst, poses, data.get("trans"), fps=args.fps)
        written.append(dst)
        print(f"{f} -> {dst} ({poses.shape[0]} frames, SMPL rig)")

    for d in args.pkl_dir:
        pkls = sorted(glob.glob(os.path.join(d, "motion_*.pkl")))
        if not pkls:
            print(f"skip {d}: no motion_*.pkl")
            continue
        poses, trans = [], []
        for pk in pkls:
            with open(pk, "rb") as fh:
                item = pickle.load(fh)
            poses.append(np.asarray(item["pose"]).reshape(-1, 3))
            trans.append(np.asarray(item["cam"]).reshape(3))
        dst = out_path(d)
        export_smpl_fbx(dst, np.stack(poses), np.stack(trans),
                        fps=args.fps)
        written.append(dst)
        print(f"{d} -> {dst} ({len(pkls)} frames, SMPL rig)")
    return written


if __name__ == "__main__":
    main()
