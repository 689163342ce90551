"""Skeleton topology constants for HumanML3D (SMPL 22-joint) and KIT-ML
(carried copy of ``mld_tpu/data/humanml/param_util.py``, held equal to the
original by ``tests/test_torch_train_data.py``).

These are public dataset constants (kinematic chains and unit offset
directions); numerically identical by necessity to the reference
(mld/data/humanml/utils/paramUtil.py:1-60).
"""
import numpy as np

# HumanML3D / Text2Motion (SMPL body, 22 joints)
T2M_RAW_OFFSETS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, -1, 0],
        [0, 1, 0], [0, -1, 0], [0, -1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1],
        [0, 1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, -1, 0], [0, -1, 0],
        [0, -1, 0], [0, -1, 0], [0, -1, 0], [0, -1, 0],
    ],
    dtype=np.float32,
)

T2M_KINEMATIC_CHAIN = [
    [0, 2, 5, 8, 11],
    [0, 1, 4, 7, 10],
    [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21],
    [9, 13, 16, 18, 20],
]

# HumanML3D preprocessing indices (motion_process.py __main__ block)
T2M_LOWER_LEG_IDX = (5, 8)
T2M_FID_R, T2M_FID_L = [8, 11], [7, 10]
T2M_FACE_JOINT_IDX = [2, 1, 17, 16]  # r_hip, l_hip, sdr_r, sdr_l

# KIT-ML (21 joints)
KIT_RAW_OFFSETS = np.array(
    [
        [0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0], [1, 0, 0],
        [0, -1, 0], [0, -1, 0], [-1, 0, 0], [0, -1, 0], [0, -1, 0], [1, 0, 0],
        [0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
        [0, -1, 0], [0, 0, 1], [0, 0, 1],
    ],
    dtype=np.float32,
)

KIT_KINEMATIC_CHAIN = [
    [0, 11, 12, 13, 14, 15],
    [0, 16, 17, 18, 19, 20],
    [0, 1, 2, 3, 4],
    [3, 5, 6, 7],
    [3, 8, 9, 10],
]

KIT_LOWER_LEG_IDX = (17, 18)
KIT_FID_R, KIT_FID_L = [14, 15], [19, 20]
KIT_FACE_JOINT_IDX = [11, 16, 5, 8]


def parents_from_chains(num_joints, chains):
    """Parent index per joint from kinematic chains (-1 for root)."""
    parents = [0] * num_joints
    parents[0] = -1
    for chain in chains:
        for j in range(1, len(chain)):
            parents[chain[j]] = chain[j - 1]
    return parents
