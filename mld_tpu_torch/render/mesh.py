"""Software SMPL-mesh rendering (matplotlib, no Blender/bpy; a copy of
``mld_tpu/render/mesh.py``).

In-repo replacement for the reference Blender mesh pipeline
(mld/render/blender/render.py:29-140 + meshes.py): shaded
Poly3DCollection frames, sequence strips with temporal alpha, and
mp4/gif animation — covering the video/sequence/frame modes of the
reference `render.py` CLI. bpy stays optional external tooling.

Shading: per-face Lambertian from a fixed light direction with painter's
z-sorting; the floor plane is drawn at the sequence's min height, like the
reference scene floor (blender/floor.py).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def mesh_detect(data: np.ndarray) -> bool:
    """A [T, N, 3] npy is a mesh when N is vertex-scale (blender/tools.py
    semantics: joints are ~22-24 points, meshes thousands)."""
    return data.ndim == 3 and data.shape[1] > 1000


_LIGHT = np.asarray([0.4, -0.35, 0.85])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)
_MESH_COLOR = np.asarray([0.65, 0.74, 0.86])  # reference-ish blue-grey
_GT_COLOR = np.asarray([0.60, 0.80, 0.60])


def _face_shade(verts: np.ndarray, faces: np.ndarray,
                base: np.ndarray) -> np.ndarray:
    tri = verts[faces]                               # [F, 3, 3]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    lam = np.abs(n @ _LIGHT)                         # double-sided
    shade = 0.35 + 0.65 * lam
    return np.clip(shade[:, None] * base[None], 0.0, 1.0)


def _decimate(verts: np.ndarray, faces: np.ndarray, max_faces: int):
    """Uniform face subsample — keeps silhouettes readable while bounding
    matplotlib's per-frame cost for video mode."""
    if max_faces and len(faces) > max_faces:
        idx = np.linspace(0, len(faces) - 1, max_faces).astype(int)
        faces = faces[idx]
    return verts, faces


def _setup_axes(ax, data: np.ndarray, radius: Optional[float] = None):
    center = data.reshape(-1, 3).mean(0)
    if radius is None:
        radius = float(np.abs(data.reshape(-1, 3) - center).max()) * 1.15
    ax.set_xlim(center[0] - radius, center[0] + radius)
    ax.set_ylim(center[1] - radius, center[1] + radius)
    ax.set_zlim(center[2] - radius, center[2] + radius)
    ax.set_axis_off()
    ax.view_init(elev=12, azim=-90)
    return center, radius


def _draw_floor(ax, data: np.ndarray, center, radius):
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    z0 = float(data.reshape(-1, 3)[:, 2].min())
    x0, x1 = center[0] - radius, center[0] + radius
    y0, y1 = center[1] - radius, center[1] + radius
    quad = [[(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0)]]
    ax.add_collection3d(Poly3DCollection(
        quad, facecolors=[[0.93, 0.93, 0.93, 0.5]], zorder=-1))


def _draw_mesh(ax, verts: np.ndarray, faces: np.ndarray,
               color: np.ndarray, alpha: float = 1.0):
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if faces is None:  # vertex cloud fallback (no faces available)
        step = max(1, len(verts) // 4000)
        ax.scatter(verts[::step, 0], verts[::step, 1], verts[::step, 2],
                   s=1.0, c=[color], alpha=alpha)
        return
    shades = _face_shade(verts, faces, color)
    coll = Poly3DCollection(verts[faces], facecolors=shades, alpha=alpha,
                            linewidths=0.0)
    coll.set_zsort("average")
    ax.add_collection3d(coll)


def _fig(res: str = "low"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    size, dpi = ((6, 100) if res == "low" else (10, 160))
    fig = plt.figure(figsize=(size, size), dpi=dpi)
    ax = fig.add_subplot(111, projection="3d")
    try:
        ax.set_box_aspect((1, 1, 1))
    except Exception:
        pass
    return plt, fig, ax


def save_mesh_frame(verts_seq: np.ndarray, path: str, faces=None,
                    exact_frame: float = 0.5, res: str = "low",
                    gt: bool = False, max_faces: int = 0) -> str:
    """One frame at relative position `exact_frame` in [0, 1]
    (reference frame mode, blender/render.py exact_frame)."""
    t = int(np.clip(exact_frame, 0, 1) * (len(verts_seq) - 1))
    plt, fig, ax = _fig(res)
    center, radius = _setup_axes(ax, verts_seq)
    _draw_floor(ax, verts_seq, center, radius)
    color = _GT_COLOR if gt else _MESH_COLOR
    v, f = _decimate(verts_seq[t], faces, max_faces)
    _draw_mesh(ax, v, f, color)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def save_mesh_sequence(verts_seq: np.ndarray, path: str, faces=None,
                       num: int = 8, res: str = "low", gt: bool = False,
                       max_faces: int = 0) -> str:
    """Overlaid keyframes with temporal alpha ramp (reference sequence
    mode, blender/render.py num frames)."""
    plt, fig, ax = _fig(res)
    center, radius = _setup_axes(ax, verts_seq)
    _draw_floor(ax, verts_seq, center, radius)
    color = _GT_COLOR if gt else _MESH_COLOR
    idx = np.linspace(0, len(verts_seq) - 1, num).astype(int)
    for rank, t in enumerate(idx):
        alpha = 0.25 + 0.75 * rank / max(len(idx) - 1, 1)
        v, f = _decimate(verts_seq[t], faces, max_faces)
        _draw_mesh(ax, v, f, color, alpha=alpha)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def save_mesh_animation(verts_seq: np.ndarray, path: str, faces=None,
                        fps: float = 20.0, res: str = "low",
                        gt: bool = False, downsample: int = 1,
                        max_faces: int = 4000) -> str:
    """mp4 (ffmpeg) or gif (pillow fallback) of the full motion
    (reference video mode)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    seq = verts_seq[:: max(1, downsample)]
    plt_, fig, ax = _fig(res)
    center, radius = _setup_axes(ax, seq)
    color = _GT_COLOR if gt else _MESH_COLOR

    def update(t):
        ax.clear()
        _setup_axes(ax, seq, radius)
        _draw_floor(ax, seq, center, radius)
        v, f = _decimate(seq[t], faces, max_faces)
        _draw_mesh(ax, v, f, color)
        return []

    anim = animation.FuncAnimation(fig, update, frames=len(seq),
                                   interval=1000.0 / fps)
    try:
        if path.endswith(".mp4"):
            anim.save(path, writer=animation.FFMpegWriter(fps=fps))
        else:
            anim.save(path, writer=animation.PillowWriter(fps=fps))
    except Exception:
        alt = os.path.splitext(path)[0] + ".gif"
        anim.save(alt, writer=animation.PillowWriter(fps=fps))
        path = alt
    plt.close(fig)
    return path
