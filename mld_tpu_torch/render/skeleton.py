"""Matplotlib skeleton visualization (3D stick-figure videos; a copy of
``mld_tpu/render/skeleton.py`` with its imports redirected to the port).

In-scope equivalent of the reference's plot_3d_motion pipeline
(mld/render/visualize.py:51-190); the Blender/bpy renderer remains optional
external tooling. matplotlib is imported when a render is made.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mld_tpu_torch.data.humanml.param_util import (
    KIT_KINEMATIC_CHAIN,
    T2M_KINEMATIC_CHAIN,
)

_COLORS = ["#DD5A37", "#D69E00", "#B75A39", "#FF6D00", "#DDB50E"]


def _chains_for(njoints: int):
    if njoints == 22:
        return T2M_KINEMATIC_CHAIN
    if njoints == 21:
        return KIT_KINEMATIC_CHAIN
    if njoints == 24:  # SMPL topology (a2m joints)
        from mld_tpu_torch.models.smpl import SMPL_PARENTS
        return [[p, j] for j, p in enumerate(SMPL_PARENTS) if p >= 0]
    # fallback: star from root
    return [[0, j] for j in range(1, njoints)]


def save_skeleton_frame(joints: np.ndarray, path: str,
                        title: str = "", radius: float = 3.0):
    """Render one pose [J, 3] to an image file."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")
    _draw_pose(ax, np.asarray(joints), radius)
    ax.set_title(title, fontsize=8)
    fig.savefig(path, dpi=96)
    plt.close(fig)


def _draw_pose(ax, pose, radius):
    chains = _chains_for(pose.shape[0])
    for ci, chain in enumerate(chains):
        xs = pose[chain, 0]
        ys = pose[chain, 1]
        zs = pose[chain, 2]
        ax.plot3D(xs, zs, ys, color=_COLORS[ci % len(_COLORS)],
                  linewidth=2.0)
    root = pose[0]
    ax.set_xlim3d(root[0] - radius / 2, root[0] + radius / 2)
    ax.set_ylim3d(root[2] - radius / 2, root[2] + radius / 2)
    ax.set_zlim3d(0, radius)
    ax.grid(False)
    ax.set_axis_off()
    ax.view_init(elev=120, azim=-90, roll=0)


def save_skeleton_sequence(joints: np.ndarray, path: str, num: int = 7,
                           title: str = "", radius: float = 3.0):
    """Strip of `num` evenly-spaced poses (the reference's "sequence"
    render mode, RENDER.MODE=sequence)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    joints = np.asarray(joints)
    idxs = np.linspace(0, len(joints) - 1, num).astype(int)
    fig = plt.figure(figsize=(2.2 * num, 2.6))
    for col, t in enumerate(idxs):
        ax = fig.add_subplot(1, num, col + 1, projection="3d")
        _draw_pose(ax, joints[t], radius)
        ax.set_title(f"t={t}", fontsize=7)
    fig.suptitle(title, fontsize=9)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def save_skeleton_animation(joints: np.ndarray, path: str,
                            fps: float = 20.0, title: str = "",
                            radius: float = 3.0,
                            downsample: Optional[int] = None):
    """Render a motion [T, J, 3] to an animated gif/mp4."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    joints = np.asarray(joints)
    if downsample:
        joints = joints[::downsample]
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")

    def update(t):
        ax.clear()
        _draw_pose(ax, joints[t], radius)
        ax.set_title(f"{title} [{t}]", fontsize=8)

    anim = FuncAnimation(fig, update, frames=len(joints),
                         interval=1000.0 / fps)
    if path.endswith(".gif"):
        anim.save(path, writer=PillowWriter(fps=int(fps)))
    else:
        try:
            anim.save(path, fps=int(fps))
        except Exception:
            path = path.rsplit(".", 1)[0] + ".gif"
            anim.save(path, writer=PillowWriter(fps=int(fps)))
    plt.close(fig)
    return path
