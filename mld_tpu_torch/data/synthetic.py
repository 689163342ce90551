"""Synthetic HumanML3D-layout corpus (the twin of
``mld_tpu/data/synthetic.py``, with the same seed, files, captions, splits,
``Mean.npy`` / ``Std.npy`` and ``.synth_version`` stamp).

Real datasets are license-gated downloads (reference prepare/*.sh); the
offline fallback is on-the-fly synthesis: smooth random FK walks on the
canonical skeleton, styled by template captions, run through the real
feature codec (``humanml/motion_process.py:process_file``). The result is
byte-layout-compatible with the true distribution (new_joint_vecs/ texts/
splits/Mean/Std), so every downstream component exercises the real code
path. ``tests/test_torch_train_data.py`` holds its files to the original's.
"""
from __future__ import annotations

import os
from os.path import join as pjoin

import numpy as np

from .humanml.motion_process import process_file
from .humanml.param_util import T2M_KINEMATIC_CHAIN, T2M_RAW_OFFSETS
from .humanml.skeleton import Skeleton, f32

# bumped whenever generation semantics change; written to .synth_version
# in generated trees so stale auto-built corpora rebuild (real datasets
# never carry the stamp and are never touched). v2 = caption-conditioned
# motion styles.
SYNTH_VERSION = 2

_VERBS = ["walks", "runs", "jumps", "turns", "spins", "crouches", "waves",
          "kicks", "sits", "stretches"]
_DIRS = ["forward", "backward", "to the left", "to the right", "in a circle",
         "in place"]
_ADVS = ["slowly", "quickly", "carefully", "casually", "steadily"]

_POS = {"walks": "VERB", "forward": "Loc_VIP", "person": "NOUN",
        "a": "DET", "the": "DET"}


# caption -> motion-style parameters. These make the synthetic corpus
# genuinely text-conditioned: the caption's verb/direction/adverb
# determine limb oscillation, root trajectory, yaw, and tempo, so a
# contrastive text-motion evaluator trained on the corpus can rank
# matched pairs far above chance — which is what lets R-precision/FID
# discriminate trained models from random ones (the reference's metrics
# do the same through the real datasets' correspondence).
_VERB_STYLE = {
    # leg_amp, leg_freq, speed, yaw_rate, bounce, crouch, arm_amp, arm_freq
    "walks":     dict(leg_amp=0.50, leg_freq=1.0, speed=1.0),
    "runs":      dict(leg_amp=0.85, leg_freq=2.1, speed=2.2),
    "jumps":     dict(leg_amp=0.30, leg_freq=1.0, speed=0.45, bounce=0.30),
    "turns":     dict(leg_amp=0.30, leg_freq=0.8, speed=0.40, yaw_rate=0.7),
    "spins":     dict(leg_amp=0.18, leg_freq=0.8, speed=0.15, yaw_rate=3.0),
    "crouches":  dict(leg_amp=0.15, leg_freq=0.5, speed=0.15, crouch=0.45),
    "waves":     dict(leg_amp=0.08, leg_freq=0.5, speed=0.10, arm_amp=1.0,
                      arm_freq=1.6),
    "kicks":     dict(leg_amp=1.25, leg_freq=0.55, speed=0.20, kick=True),
    "sits":      dict(leg_amp=0.05, leg_freq=0.3, speed=0.05, crouch=0.55,
                      hold=True),
    "stretches": dict(leg_amp=0.05, leg_freq=0.3, speed=0.05, arm_amp=0.75,
                      arm_freq=0.35),
}
_DIR_STYLE = {
    "forward": (0.0, 1.0, 0.0), "backward": (0.0, -1.0, 0.0),
    "to the left": (-1.0, 0.0, 0.0), "to the right": (1.0, 0.0, 0.0),
    "in a circle": (0.0, 1.0, 0.9), "in place": (0.0, 0.0, 0.0),
}
_ADV_TEMPO = {"slowly": 0.50, "carefully": 0.75, "casually": 1.0,
              "steadily": 1.30, "quickly": 1.75}


def _style_from_caption(verb: str, direction: str, adv: str) -> dict:
    s = dict(leg_amp=0.0, leg_freq=1.0, speed=0.0, yaw_rate=0.0,
             bounce=0.0, crouch=0.0, arm_amp=0.0, arm_freq=1.0,
             kick=False, hold=False)
    s.update(_VERB_STYLE[verb])
    dx, dz, circ_yaw = _DIR_STYLE[direction]
    s["dir"] = (dx, dz)
    s["yaw_rate"] = s["yaw_rate"] + circ_yaw
    s["tempo"] = _ADV_TEMPO[adv]
    return s


def style_vector_from_caption(caption: str) -> np.ndarray:
    """Parse a synthetic caption back to its 11-dim style vector (roughly
    unit-scaled): the supervised anchor of the evaluator trainer
    (eval/t2m_train.py), as ``mld_tpu/data/synthetic.py:83`` has it."""
    words = caption.strip().rstrip(".").split()
    verb = next(w for w in words if w in _VERB_STYLE)
    adv = next(w for w in words if w in _ADV_TEMPO)
    direction = next(d for d in _DIR_STYLE
                     if f" {d} " in f" {' '.join(words)} ")
    s = _style_from_caption(verb, direction, adv)
    return np.array([
        s["leg_amp"], s["leg_freq"] / 2.0, s["speed"] / 2.0,
        s["yaw_rate"] / 3.0, s["bounce"] * 2.0, s["crouch"] * 2.0,
        s["arm_amp"], s["arm_freq"] / 2.0, s["dir"][0], s["dir"][1],
        s["tempo"],
    ], np.float32)


def synth_joints(T: int, J: int = 22, seed: int = 0,
                 raw_offsets=None, chains=None,
                 style: dict | None = None) -> np.ndarray:
    """Smooth FK walk -> (T, J, 3) joints.

    With `style` (from `_style_from_caption`) the sequence carries the
    caption's semantics: periodic leg/arm oscillation along the skeleton's
    leg/arm chains (chains[0]/[1] are legs and chains[-2]/[-1] arms in
    both the T2M and KIT tables), yaw-integrated root trajectory, bounce
    and crouch tracks. Without it, the original unconditioned random walk.
    """
    rng = np.random.RandomState(seed)
    raw_offsets = T2M_RAW_OFFSETS if raw_offsets is None else raw_offsets
    chains = T2M_KINEMATIC_CHAIN if chains is None else chains
    skel = Skeleton(raw_offsets, chains)
    offsets = raw_offsets * (0.25 + 0.1 * rng.rand(J, 1))
    skel.set_offsets(offsets)

    if style is None:
        ang = np.cumsum(0.02 * rng.randn(T, J, 3), axis=0)
        root = np.cumsum(0.008 * rng.randn(T, 3), axis=0)
        root[:, 1] += 0.9
    else:
        fps = 20.0
        tempo = style["tempo"]
        t = np.arange(T) / fps * tempo
        ang = np.cumsum(0.004 * rng.randn(T, J, 3), axis=0)  # texture

        legs = [c[1:] for c in chains[:2]]
        arms = [c[1:] for c in chains[-2:]]
        la, lf = style["leg_amp"], style["leg_freq"]
        swing = np.sin(2 * np.pi * lf * t + rng.uniform(0, 2 * np.pi))
        if style["kick"]:  # one-sided spiking swings
            swing = np.maximum(swing, 0.0) ** 2
        for side, leg in enumerate(legs):
            if style["kick"] and side == 1:
                continue  # kicks drive one leg only
            sgn = 1.0 if side == 0 else -1.0  # gait: legs anti-phase
            for depth, j in enumerate(leg):
                ang[:, j, 0] += sgn * la * swing * (0.7 ** depth)
        aa, af = style["arm_amp"], style["arm_freq"]
        if aa > 0:
            wavec = np.sin(2 * np.pi * af * t + rng.uniform(0, 2 * np.pi))
            for side, arm in enumerate(arms):
                sgn = 1.0 if side == 0 else -1.0
                for depth, j in enumerate(arm):
                    ang[:, j, 2] += sgn * aa * wavec * (0.75 ** depth)

        yaw = style["yaw_rate"] * t
        ang[:, 0, 1] += yaw

        # root trajectory: speed along the caption direction, rotated by
        # the integrated yaw (circles curve; spins drift little)
        step_len = 0.06 * style["speed"] * tempo
        dx, dz = style["dir"]
        c, s = np.cos(yaw), np.sin(yaw)
        vx = step_len * (c * dx + s * dz)
        vz = step_len * (-s * dx + c * dz)
        root = np.zeros((T, 3))
        root[:, 0] = np.cumsum(vx)
        root[:, 2] = np.cumsum(vz)
        ramp = np.minimum(np.arange(T) / (0.25 * T + 1), 1.0)
        hold = ramp if style["hold"] else np.abs(
            np.sin(2 * np.pi * 0.4 * t))
        root[:, 1] = (0.9 - style["crouch"] * hold
                      + style["bounce"] * np.abs(
                          np.sin(2 * np.pi * style["leg_freq"] * t)))
        root += np.cumsum(0.002 * rng.randn(T, 3), axis=0)  # drift noise

    half = np.linalg.norm(ang, axis=-1, keepdims=True) / 2 + 1e-8
    axis = ang / (2 * half)
    quat = np.concatenate([np.cos(half), axis * np.sin(half)], -1)
    joints = skel.forward_kinematics(f32(quat), f32(root))
    return joints.numpy().astype(np.float64)


def _caption(rng) -> tuple[str, str, dict]:
    verb = rng.choice(_VERBS)
    direction = rng.choice(_DIRS)
    adv = rng.choice(_ADVS)
    cap = f"a person {verb} {direction} {adv}"
    toks = []
    for word in cap.split():
        pos = _POS.get(word, "VERB" if word == verb else
                       ("ADV" if word == adv else "OTHER"))
        toks.append(f"{word}/{pos}")
    return cap, " ".join(toks), _style_from_caption(verb, direction, adv)


def build_synthetic_dataset(root: str, n_samples: int = 64, seed: int = 0,
                            min_len: int = 45, max_len: int = 199,
                            splits=(0.7, 0.15, 0.15),
                            dataset: str = "humanml3d") -> str:
    """Write a synthetic dataset tree under `root`. Returns root.

    dataset: "humanml3d" (22 joints, 263 feats) or "kit" (21 joints, 251).
    Runs on the host (CPU tensors).
    """
    from .humanml.param_util import (
        KIT_FACE_JOINT_IDX, KIT_FID_L, KIT_FID_R, KIT_KINEMATIC_CHAIN,
        KIT_LOWER_LEG_IDX, KIT_RAW_OFFSETS)

    kit = dataset.lower() == "kit"
    raw_offsets = KIT_RAW_OFFSETS if kit else None
    chains = KIT_KINEMATIC_CHAIN if kit else None
    J = 21 if kit else 22

    rng = np.random.RandomState(seed)
    mdir, tdir = pjoin(root, "new_joint_vecs"), pjoin(root, "texts")
    os.makedirs(mdir, exist_ok=True)
    os.makedirs(tdir, exist_ok=True)

    names, feats_all = [], []
    for i in range(n_samples):
        T = int(rng.randint(min_len + 1, max_len))
        cap, toks, style = _caption(rng)
        # synthesize at ONE fixed length and crop the features (the
        # original's choice, so the features are its features); a feature
        # crop is exactly how the reference datasets shorten stored clips
        joints = synth_joints(max_len + 1, J=J, seed=seed * 100003 + i,
                              raw_offsets=raw_offsets, chains=chains,
                              style=style)
        if kit:
            feats, *_ = process_file(
                joints, 0.05, do_uniform_skeleton=False,
                raw_offsets=KIT_RAW_OFFSETS, chains=KIT_KINEMATIC_CHAIN,
                l_idx=KIT_LOWER_LEG_IDX, fid_r=KIT_FID_R, fid_l=KIT_FID_L,
                face_joint_idx=KIT_FACE_JOINT_IDX)
        else:
            feats, *_ = process_file(joints, 0.002,
                                     do_uniform_skeleton=False)
        feats = feats[:T]
        name = f"{i:06d}"
        np.save(pjoin(mdir, name + ".npy"), feats.astype(np.float32))
        with open(pjoin(tdir, name + ".txt"), "w") as f:
            f.write(f"{cap}#{toks}#0.0#0.0\n")
        names.append(name)
        feats_all.append(feats)

    all_feats = np.concatenate(feats_all, 0)
    np.save(pjoin(root, "Mean.npy"), all_feats.mean(0).astype(np.float32))
    np.save(pjoin(root, "Std.npy"),
            (all_feats.std(0) + 1e-7).astype(np.float32))

    n_train = int(splits[0] * n_samples)
    n_val = int(splits[1] * n_samples)
    split_names = {
        "train": names[:n_train],
        "val": names[n_train: n_train + n_val],
        "test": names[n_train + n_val:],
    }
    for split, lst in split_names.items():
        with open(pjoin(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(lst) + "\n")
    with open(pjoin(root, ".synth_version"), "w") as f:
        f.write(str(SYNTH_VERSION))
    return root
