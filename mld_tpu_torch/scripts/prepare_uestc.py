"""Offline UESTC raw->pkl preprocessing (a carried copy of
``scripts/prepare_uestc.py``, framework-free: numpy, scipy and pickle; a
test holds it equal to the original), with the reference's
mld/data/a2m/uestc.py semantics.

Consumes the raw UESTC release layout:
    <datapath>/info/names.txt              25600 video names
    <datapath>/info/num_frames_min.txt     per-video frame counts
    <datapath>/info/action_classes.txt     40 action names
    <datapath>/vibe_cache_refined.pkl      VIBE estimates {pose, joints3d,
                                           orig_cam}

and reproduces the reference's in-loader preprocessing as an offline pass:
  * camera depth solve + global translation from VIBE orig_cam
    (uestc.py:15-55 get_z/get_trans_from_vibe),
  * rotation of side-2 videos to front view about the y axis by
    -view*pi/4, applied to global pose, joints and translation
    (uestc.py:146-185),
  * action2motion 18-joint subset + translation add (uestc.py:216-225),
  * train/test split by the fixed 51/67 subject partition (uestc.py:78-88),
  * train-side minimum-frame filtering at 3/4 * num_frames
    (uestc.py:197-207).

Output: <out>/uestc_poses.pkl with
    {"poses": [ [T,72] rotvec ], "joints3D": [ [T,18,3] ], "y": labels,
     "split": {"train": [...], "test": [...]}, "action_classes": [...]}
— the schema mld_tpu_torch/data/a2m.py:UestcDataset consumes.

    python -m mld_tpu_torch.scripts.prepare_uestc \
        --datapath datasets/uestc_raw --out datasets/uestc
    python -m mld_tpu_torch.scripts.prepare_uestc --selftest   # fabricated

No torch and no device: the preprocessing runs on the host.
"""
import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

ACTION2MOTION_JOINTS = [8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14,
                        21, 24, 38]
TRAIN_SUBJECTS = [
    1, 2, 6, 12, 13, 16, 21, 24, 28, 29, 30, 31, 33, 35, 39, 41, 42,
    45, 47, 50, 52, 54, 55, 57, 59, 61, 63, 64, 67, 69, 70, 71, 73, 77,
    81, 84, 86, 87, 88, 90, 91, 93, 96, 99, 102, 103, 104, 107, 108,
    112, 113,
]


def parse_name(video: str):
    """'a0_d1_p001_c1_color.avi' -> (action, view, subject, side)."""
    spl = video.split("_")
    return (int(spl[0][1:]), int(spl[1][1:]), int(spl[2][1:]),
            int(spl[3][1:]))


def get_z(cam_s, cam_pos, joints, img_size=540, flength=500):
    """Depth offset mapping the orthographic VIBE camera to perspective
    (uestc.py:15-28)."""
    joints_orth_target = (cam_s * (joints[:, :2] + cam_pos) + 1) \
        * 0.5 * img_size
    height3d = np.linalg.norm(np.max(joints[:, :2], axis=0)
                              - np.min(joints[:, :2], axis=0))
    height2d = np.linalg.norm(np.max(joints_orth_target, axis=0)
                              - np.min(joints_orth_target, axis=0))
    return float(flength * (height3d / height2d))


def trans_from_vibe(vibe, index, use_z=True):
    """Per-frame global translation, zeroed at frame 0 (uestc.py:31-55)."""
    alltrans = []
    for t in range(vibe["joints3d"][index].shape[0]):
        cam = vibe["orig_cam"][index][t]
        x, y = cam[2], cam[3]
        z = (get_z(cam[0], cam[2:4], vibe["joints3d"][index][t])
             if use_z else 0.0)
        alltrans.append([x, y, z])
    alltrans = np.asarray(alltrans)
    return alltrans - alltrans[0]


def y_rotation(view: int) -> np.ndarray:
    """Rotation about +y by -view*pi/4 (uestc.py:146-157)."""
    theta = -view * np.pi / 4
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _aa_to_matrix(aa: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(aa).as_matrix()


def _matrix_to_aa(m: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(m).as_rotvec()


def preprocess(datapath: str, out_dir: str, use_z: bool = True) -> str:
    info = os.path.join(datapath, "info")
    with open(os.path.join(info, "names.txt")) as f:
        videos = f.read().splitlines()
    with open(os.path.join(info, "num_frames_min.txt")) as f:
        num_frames_video = np.asarray([int(s) for s in f.read().splitlines()])
    with open(os.path.join(info, "action_classes.txt")) as f:
        action_classes = f.read().splitlines()

    with open(os.path.join(datapath, "vibe_cache_refined.pkl"), "rb") as f:
        vibe = pickle.load(f)
    poses = [np.asarray(p, np.float32) for p in vibe["pose"]]
    joints = [np.asarray(j, np.float32) for j in vibe["joints3d"]]

    num_frames_method = np.asarray([p.shape[0] for p in poses])
    num_frames_video = np.minimum(num_frames_video,
                                  num_frames_method).astype(int)

    out_poses, out_joints, out_y = [], [], []
    train_ix, test_ix = [], []
    for index, video in enumerate(videos):
        act, view, subject, side = parse_name(video)
        globtrans = trans_from_vibe(vibe, index, use_z=use_z)
        pose = poses[index].copy()
        jnt = joints[index].copy()

        if side != 1:  # rotate side-2 captures to front view
            if view == 8:
                continue
            R = y_rotation(view)
            glob = _aa_to_matrix(pose[:, :3])
            pose[:, :3] = _matrix_to_aa(R[None] @ glob)
            jnt = jnt @ R.T
            globtrans = globtrans @ R.T

        jnt = jnt[:, ACTION2MOTION_JOINTS] + globtrans[:, None]

        i = len(out_poses)
        out_poses.append(pose)
        out_joints.append(jnt.astype(np.float32))
        out_y.append(act)
        if subject in TRAIN_SUBJECTS:
            if num_frames_video[index] >= 60 * 3 / 4:  # uestc.py:197-204
                train_ix.append(i)
        else:
            test_ix.append(i)

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "uestc_poses.pkl")
    with open(out_path, "wb") as f:
        pickle.dump({"poses": out_poses, "joints3D": out_joints,
                     "y": out_y,
                     "split": {"train": train_ix, "test": test_ix},
                     "action_classes": action_classes}, f)
    print(f"wrote {out_path}: {len(out_poses)} sequences "
          f"(train {len(train_ix)} / test {len(test_ix)})")
    return out_path


def fabricate_raw(datapath: str, n_videos: int = 16, seed: int = 0):
    """Tiny raw-layout UESTC for the self-test / CI."""
    rng = np.random.RandomState(seed)
    info = os.path.join(datapath, "info")
    os.makedirs(info, exist_ok=True)
    names, nf = [], []
    subjects = TRAIN_SUBJECTS[:4] + [3, 4]  # 3, 4 are test subjects
    pose, joints3d, orig_cam = [], [], []
    for i in range(n_videos):
        act = i % 40
        view = i % 8
        subject = subjects[i % len(subjects)]
        side = 1 + (i % 2)
        names.append(f"a{act}_d{view}_p{subject:03d}_c{side}_color.avi")
        T = int(rng.randint(30, 80))
        nf.append(T)
        pose.append(rng.randn(T, 72).astype(np.float32) * 0.1)
        joints3d.append(rng.randn(T, 49, 3).astype(np.float32) * 0.3)
        orig_cam.append(
            np.abs(rng.randn(T, 4)).astype(np.float32) + 0.5)
    with open(os.path.join(info, "names.txt"), "w") as f:
        f.write("\n".join(names))
    with open(os.path.join(info, "num_frames_min.txt"), "w") as f:
        f.write("\n".join(str(x) for x in nf))
    with open(os.path.join(info, "action_classes.txt"), "w") as f:
        f.write("\n".join(f"action_{i}" for i in range(40)))
    with open(os.path.join(datapath, "vibe_cache_refined.pkl"), "wb") as f:
        pickle.dump({"pose": pose, "joints3d": joints3d,
                     "orig_cam": orig_cam}, f)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", default="datasets/uestc_raw")
    p.add_argument("--out", default="datasets/uestc")
    p.add_argument("--no-z", action="store_true",
                   help="skip the camera depth solve (z=0)")
    p.add_argument("--selftest", action="store_true")
    args = p.parse_args()

    if args.selftest:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            raw = os.path.join(tmp, "raw")
            fabricate_raw(raw)
            out = preprocess(raw, os.path.join(tmp, "out"))
            with open(out, "rb") as f:
                data = pickle.load(f)
            assert data["poses"] and data["split"]["train"]
            assert all(j.shape[1] == 18 for j in data["joints3D"])
            print("selftest ok")
        return

    preprocess(args.datapath, args.out, use_z=not args.no_z)


if __name__ == "__main__":
    main()
