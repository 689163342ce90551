"""Joints -> SMPL pose / mesh fitting CLI of the port (the twin of the
repository's ``fit.py``): demo joint npys in, fitted poses out (+ the mesh
when the SMPL asset exists), every frame of a motion in one batched fit
(``transforms/fitting.py``).

    python -m mld_tpu_torch.fit --dir results/demo
    python -m mld_tpu_torch.fit --files a.npy --smpl deps/smpl_models/smpl/SMPL_NEUTRAL.pkl --ply
    python -m mld_tpu_torch.fit --dir results/demo --device cpu

Writes ``<stem>_fit.npz`` (rot6d, trans, joints_fit), with ``--mesh`` or
``--ply`` ``<stem>_mesh.npy`` [T, V, 3], and with ``--ply`` the reference's
per-frame tree ``results_smplfitting/SMPLFit_<stem>/motion_%04d.{ply,pkl}``.
Runs on the card unless ``--device`` names another; without a visible CUDA
device the default raises.
"""
import argparse
import glob
import os
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", type=str, default=None,
                   help="directory of [T, J, 3] joint npys")
    p.add_argument("--files", type=str, nargs="*", default=None)
    p.add_argument("--smpl", type=str,
                   default="deps/smpl_models/smpl/SMPL_NEUTRAL.pkl")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--out_suffix", type=str, default="_fit")
    p.add_argument("--mesh", action="store_true",
                   help="also export vertices (needs SMPL asset)")
    p.add_argument("--ply", action="store_true",
                   help="reference-format per-frame ply + pkl export "
                        "(fit.py:246-280 layout, needs SMPL asset)")
    p.add_argument("--save_folder", type=str, default=None,
                   help="root for the ply/pkl tree (default: input dir)")
    p.add_argument("--device", type=str, default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def main(argv=None):
    """Fit every input npy; returns one summary a fitted file (frames,
    MPJPE of the fit against the 22 target joints, each phase's seconds,
    ms a frame)."""
    args = parse_args(argv)
    from mld_tpu_torch.transforms.fitting import BatchedSMPLFitter

    files = list(args.files or [])
    if args.dir:
        files += sorted(glob.glob(os.path.join(args.dir, "*.npy")))
    files = [f for f in files if not f.endswith(
        (args.out_suffix + ".npy", "_mesh.npy"))]
    if not files:
        print("no input npys found")
        return []

    fitter = BatchedSMPLFitter(args.smpl, num_steps=args.steps,
                               device=args.device)
    if args.mesh and not fitter.smpl.has_asset:
        print("warning: SMPL asset missing — mesh export disabled")
        args.mesh = False

    rows = []
    for f in files:
        joints = np.load(f)
        if joints.ndim != 3 or joints.shape[-1] != 3:
            print(f"skip {f}: not a joints array {joints.shape}")
            continue
        res = fitter.fit(joints)
        stem = f[: -len(".npy")]
        np.savez(stem + args.out_suffix + ".npz", rot6d=res["rot6d"],
                 trans=res["trans"], joints_fit=res["joints_fit"])
        err = float(np.sqrt(res["loss_curve"][-1]))
        print(f"{os.path.basename(f)}: frames={len(joints)} "
              f"final_rmse~{err:.4f} -> {stem}{args.out_suffix}.npz")
        seconds = res["adam_s"] + res["polish_s"]
        row = {"file": f, "frames": len(joints),
               "mpjpe": float(np.linalg.norm(
                   res["joints_fit"][:, :22] - joints[:, :22],
                   axis=-1).mean()),
               "adam_s": res["adam_s"], "polish_s": res["polish_s"],
               "ms_per_frame": 1e3 * seconds / len(joints)}
        rows.append(row)
        print(f"  MPJPE {row['mpjpe']:.5f} m, adam {row['adam_s']:.3f} s, "
              f"polish {row['polish_s']:.3f} s, "
              f"{row['ms_per_frame']:.2f} ms/frame on {fitter.device}")
        if args.mesh or args.ply:
            verts = fitter.vertices(res["rot6d"], res["trans"])
            np.save(stem + "_mesh.npy", verts)
            print(f"  mesh: {verts.shape} -> {stem}_mesh.npy")
            if args.ply:
                out_root = args.save_folder or os.path.dirname(f) or "."
                dir_save = os.path.join(
                    out_root, "results_smplfitting",
                    "SMPLFit_" + os.path.basename(stem))
                export_ply_pkl(dir_save, verts, res,
                               getattr(fitter.smpl, "faces", None))
                print(f"  ply/pkl: {len(verts)} frames -> {dir_save}")
    return rows


def export_ply_pkl(dir_save, verts, res, faces):
    """Reference-layout per-frame export (fit.py:194,246-280):
    motion_%04d.ply mesh + motion_%04d.pkl {beta, pose, cam}."""
    import torch

    from mld_tpu_torch.ops.rotation import rotation_6d_to_axis_angle

    os.makedirs(dir_save, exist_ok=True)
    pose_aa = rotation_6d_to_axis_angle(
        torch.from_numpy(np.asarray(res["rot6d"], np.float32))).numpy()
    for idx in range(len(verts)):
        base = os.path.join(dir_save, f"motion_{idx:04d}")
        write_ply(base + ".ply", verts[idx], faces)
        with open(base + ".pkl", "wb") as fh:
            pickle.dump({"beta": np.zeros((1, 10), np.float32),
                         "pose": pose_aa[idx].reshape(1, 72),
                         "cam": res["trans"][idx][None]}, fh)


def write_ply(path, verts, faces=None):
    """Minimal ascii PLY writer (trimesh-free)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if faces is not None:
            for tri in faces:
                f.write(f"3 {int(tri[0])} {int(tri[1])} {int(tri[2])}\n")


if __name__ == "__main__":
    main()
