"""Rendering CLI of the port (the twin of the repository's ``render.py``):
joints / mesh npys -> mp4/gif videos, sequence strips or single frames,
Blender-free.

Reference surface: render.py:39-151 (npy/dir inputs, video/sequence/frame
modes, mesh auto-detection, mesh npys first, skip-if-rendered). The bpy
backend is replaced by the matplotlib renderers of this package
(``render/skeleton.py``, ``render/mesh.py``); the ``*_mesh.npy`` vertex
sequences that ``python -m mld_tpu_torch.fit --mesh`` writes render as
shaded SMPL meshes, joint npys as stick skeletons. Needs matplotlib (a host
package; no device is touched).

    python -m mld_tpu_torch.render --dir results/demo --mode video
    python -m mld_tpu_torch.render --npy results/demo/walk_196_mesh.npy \
        --mode frame --exact_frame 0.5
"""
import argparse
import glob
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="render motion npys")
    p.add_argument("--npy", type=str, default=None, help="single npy input")
    p.add_argument("--dir", type=str, default=None, help="directory of npys")
    p.add_argument("--mode", type=str, default="video",
                   choices=["video", "sequence", "frame"])
    p.add_argument("--fps", type=float, default=20.0)
    p.add_argument("--num", type=int, default=8,
                   help="keyframes in sequence mode")
    p.add_argument("--exact_frame", type=float, default=0.5,
                   help="relative frame for frame mode (0..1)")
    p.add_argument("--res", type=str, default="low",
                   choices=["low", "high"])
    p.add_argument("--gt", action="store_true",
                   help="ground-truth color scheme")
    p.add_argument("--downsample", type=int, default=2,
                   help="temporal downsample for video mode")
    p.add_argument("--faces", type=str, default=None,
                   help="faces npy for mesh rendering (default: SMPL asset)")
    p.add_argument("--smpl", type=str,
                   default="deps/smpl_models/smpl/SMPL_NEUTRAL.pkl")
    p.add_argument("--overwrite", action="store_true")
    return p.parse_args(argv)


def collect_paths(args):
    if args.npy:
        return [args.npy]
    if not args.dir:
        print("pass --npy or --dir")
        return []
    paths = sorted(glob.glob(os.path.join(args.dir, "*.npy")))
    # render mesh npys first, as the reference does (render.py:60-70)
    return ([p for p in paths if p.endswith("_mesh.npy")]
            + [p for p in paths if not p.endswith("_mesh.npy")])


def load_faces(args):
    if args.faces and os.path.exists(args.faces):
        return np.load(args.faces)
    if os.path.exists(args.smpl):
        from mld_tpu_torch.models.smpl import SMPLLayer
        smpl = SMPLLayer(args.smpl)
        return getattr(smpl, "faces", None)
    return None


def main(argv=None):
    """Render every input; returns the (input, output) pairs rendered."""
    args = parse_args(argv)
    from mld_tpu_torch.render.mesh import (mesh_detect, save_mesh_animation,
                                           save_mesh_frame,
                                           save_mesh_sequence)
    from mld_tpu_torch.render.skeleton import (save_skeleton_animation,
                                               save_skeleton_frame,
                                               save_skeleton_sequence)

    paths = collect_paths(args)
    if not paths:
        return []
    faces = load_faces(args)
    ext = {"video": ".mp4", "sequence": ".png", "frame": ".png"}[args.mode]

    rendered = []
    for path in paths:
        out = path[: -len(".npy")] + ("_gt" if args.gt else "") + ext
        alt = os.path.splitext(out)[0] + ".gif"
        if not args.overwrite and (os.path.exists(out)
                                   or os.path.exists(alt)):
            print(f"already rendered: {out}")
            continue
        try:
            data = np.load(path)
        except (OSError, ValueError) as e:
            print(f"skip {path}: {e}")
            continue
        if data.ndim != 3 or data.shape[-1] != 3:
            print(f"skip {path}: shape {data.shape} is not [T, N, 3]")
            continue

        if mesh_detect(data):
            if args.mode == "video":
                out = save_mesh_animation(data, out, faces, fps=args.fps,
                                          res=args.res, gt=args.gt,
                                          downsample=args.downsample)
            elif args.mode == "sequence":
                out = save_mesh_sequence(data, out, faces, num=args.num,
                                         res=args.res, gt=args.gt)
            else:
                out = save_mesh_frame(data, out, faces,
                                      exact_frame=args.exact_frame,
                                      res=args.res, gt=args.gt)
        else:
            if args.mode == "video":
                out = save_skeleton_animation(data, out, fps=args.fps)
            elif args.mode == "sequence":
                out = save_skeleton_sequence(data, out, num=args.num)
            else:
                t = int(np.clip(args.exact_frame, 0, 1) * (len(data) - 1))
                out = save_skeleton_frame(data[t], out)
        rendered.append((path, out))
        print(f"rendered {path} -> {out}")
    return rendered


if __name__ == "__main__":
    main()
