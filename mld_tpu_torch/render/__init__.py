from .skeleton import save_skeleton_animation, save_skeleton_frame
from .mesh import (
    mesh_detect,
    save_mesh_animation,
    save_mesh_frame,
    save_mesh_sequence,
)

__all__ = ["save_skeleton_animation", "save_skeleton_frame",
           "mesh_detect", "save_mesh_animation", "save_mesh_frame",
           "save_mesh_sequence"]
