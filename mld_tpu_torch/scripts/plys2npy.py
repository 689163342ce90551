"""Merge per-frame fit plys into one [T, V, 3] _mesh.npy (a copy of
``scripts/plys2npy.py``).

Reference equivalent: scripts/plys2npy.py (trimesh load loop). The port's
fit CLI already writes _mesh.npy directly; this tool exists for interop with
externally-produced SMPLFit_* ply directories.

    python -m mld_tpu_torch.scripts.plys2npy --dir results_smplfitting/SMPLFit_walk \
        --out walk_mesh.npy
"""
import argparse
import glob
import os

import numpy as np


def read_ply_vertices(path: str) -> np.ndarray:
    """Minimal ascii/binary-free PLY vertex reader (ascii only)."""
    with open(path) as f:
        line = f.readline().strip()
        assert line == "ply", f"{path}: not a ply"
        n_verts = 0
        while True:
            line = f.readline().strip()
            if line.startswith("element vertex"):
                n_verts = int(line.split()[-1])
            if line == "end_header":
                break
        verts = np.loadtxt(f, max_rows=n_verts, dtype=np.float32)
    return verts[:, :3]


def plys2npy(ply_dir: str, out_path: str) -> str:
    paths = sorted(glob.glob(os.path.join(ply_dir, "motion_*.ply")))
    if not paths:
        raise FileNotFoundError(f"no motion_*.ply under {ply_dir}")
    verts = np.stack([read_ply_vertices(p) for p in paths])
    np.save(out_path, verts)
    print(f"merged {len(paths)} plys -> {out_path} {verts.shape}")
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True, help="SMPLFit_* ply directory")
    p.add_argument("--out", default=None,
                   help="output npy (default: <dir>_mesh.npy)")
    args = p.parse_args(argv)
    out = args.out or args.dir.rstrip("/") + "_mesh.npy"
    return plys2npy(args.dir, out)


if __name__ == "__main__":
    main()
