from .fbx import (SMPL_BONE_NAMES, SMPL_PARENTS, export_skeleton_fbx,
                  export_smpl_fbx, read_fbx, write_fbx)

__all__ = ["export_skeleton_fbx", "export_smpl_fbx", "read_fbx",
           "write_fbx", "SMPL_BONE_NAMES", "SMPL_PARENTS"]
