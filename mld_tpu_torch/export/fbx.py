"""Pure-Python binary FBX exporter for animated motion skeletons (a copy of
``mld_tpu/export/fbx.py``, held equal to it by the port's tests).

Replaces the reference's Blender-bound FBX pipeline
(reference scripts/fbx_output.py:1-353, fbx_output_smplx.py): the
reference loads a licensed SMPL rig .fbx into bpy, keyframes per-bone
rotation quaternions + the pelvis location from fitted SMPL poses
(fbx_output.py:111-148), and calls bpy.ops.export_scene.fbx. That needs
Blender plus MPG-licensed template assets — neither available here.

This module writes FBX 7.4 **binary** files directly (Blender's importer
only reads binary FBX), with no dependencies:

  * `export_skeleton_fbx`  — joints [T, J, 3] (demo.py output) -> LimbNode
    skeleton with per-frame local-translation animation curves.
  * `export_smpl_fbx`      — SMPL axis-angle poses [T, 24, 3] + root
    translation [T, 3] (fit.py pkl output) -> rig with per-bone euler
    rotation curves + pelvis location curve, mirroring
    fbx_output.py:111-148 semantics.

The node graph (Models/LimbNode + NodeAttribute/Skeleton + AnimationStack
-> AnimationLayer -> AnimationCurveNode -> AnimationCurve, wired through
OO/OP connections) matches what Blender's own FBX exporter emits and what
its importer consumes (importers read KeyTime/KeyValueFloat and group
connected LimbNode hierarchies into one armature).
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

# FBX time unit: ticks per second (KTime)
KTIME_PER_SEC = 46186158000
FBX_VERSION = 7400

# SMPL-24 bone names + parents (reference fbx_output.py:50-75 table and
# the SMPL kintree; parent[i] < i)
SMPL_BONE_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee", "Spine2",
    "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot", "Neck",
    "L_Collar", "R_Collar", "Head", "L_Shoulder", "R_Shoulder",
    "L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist", "L_Hand", "R_Hand"]
SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21]


# --------------------------------------------------------------------------
# low-level binary writer
# --------------------------------------------------------------------------
class FbxNode:
    """One record in the FBX node tree."""

    def __init__(self, name: str, props: Sequence = (),
                 children: Optional[List["FbxNode"]] = None):
        self.name = name
        self.props = list(props)
        self.children = children if children is not None else []

    def add(self, name: str, *props) -> "FbxNode":
        child = FbxNode(name, props)
        self.children.append(child)
        return child


def _write_prop(out: bytearray, p) -> None:
    if isinstance(p, bool):
        out += b"C" + struct.pack("<B", int(p))
    elif isinstance(p, int):
        out += b"L" + struct.pack("<q", p)
    elif isinstance(p, float):
        out += b"D" + struct.pack("<d", p)
    elif isinstance(p, str):
        b = p.encode()
        out += b"S" + struct.pack("<I", len(b)) + b
    elif isinstance(p, bytes):
        out += b"R" + struct.pack("<I", len(p)) + p
    elif isinstance(p, np.ndarray):
        code = {np.dtype(np.float32): b"f", np.dtype(np.float64): b"d",
                np.dtype(np.int32): b"i", np.dtype(np.int64): b"l"}[p.dtype]
        raw = p.tobytes()
        comp = zlib.compress(raw)
        if len(comp) < len(raw):
            out += (code + struct.pack("<III", p.size, 1, len(comp)) + comp)
        else:
            out += (code + struct.pack("<III", p.size, 0, len(raw)) + raw)
    else:
        raise TypeError(f"unsupported FBX property {type(p)}")


_NULL_RECORD = b"\x00" * 13  # 32-bit node sentinel (version < 7500)


def _write_node(out: bytearray, node: FbxNode) -> None:
    start = len(out)
    # placeholder: endOffset, numProps, propListLen, nameLen (13 bytes)
    out += b"\x00" * 13
    out += node.name.encode()
    plist_start = len(out)
    for p in node.props:
        _write_prop(out, p)
    plist_len = len(out) - plist_start
    if node.children:
        for c in node.children:
            _write_node(out, c)
        out += _NULL_RECORD
    out[start:start + 13] = struct.pack(
        "<IIIB", len(out), len(node.props), plist_len, len(node.name))


def write_fbx(path: str, roots: List[FbxNode]) -> None:
    out = bytearray()
    out += b"Kaydara FBX Binary  \x00\x1a\x00"
    out += struct.pack("<I", FBX_VERSION)
    for r in roots:
        _write_node(out, r)
    out += _NULL_RECORD
    # generic footer (importers don't validate the magic payload)
    out += bytes(16)
    out += b"\x00" * ((16 - len(out) % 16) % 16)
    out += struct.pack("<I", FBX_VERSION) + bytes(120) + bytes(16)
    with open(path, "wb") as f:
        f.write(out)


def read_fbx(path: str):
    """Minimal structural parser (round-trip validation; same record
    grammar Blender's parse_fbx.py reads)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:21] != b"Kaydara FBX Binary  \x00":
        raise ValueError("bad FBX magic")
    version = struct.unpack_from("<I", data, 23)[0]

    def read_node(pos):
        end, nprops, plen, nlen = struct.unpack_from("<IIIB", data, pos)
        if end == 0:
            return None, pos + 13
        pos += 13
        name = data[pos:pos + nlen].decode()
        pos += nlen
        props = []
        pend = pos + plen
        while pos < pend:
            code = data[pos:pos + 1]
            pos += 1
            if code == b"C":
                props.append(bool(data[pos])); pos += 1
            elif code == b"L":
                props.append(struct.unpack_from("<q", data, pos)[0]); pos += 8
            elif code == b"D":
                props.append(struct.unpack_from("<d", data, pos)[0]); pos += 8
            elif code in (b"S", b"R"):
                n = struct.unpack_from("<I", data, pos)[0]
                raw = data[pos + 4:pos + 4 + n]
                props.append(raw.decode() if code == b"S" else raw)
                pos += 4 + n
            elif code in (b"f", b"d", b"i", b"l"):
                n, enc, clen = struct.unpack_from("<III", data, pos)
                pos += 12
                dt = {b"f": np.float32, b"d": np.float64,
                      b"i": np.int32, b"l": np.int64}[code]
                raw = data[pos:pos + clen]
                if enc:
                    raw = zlib.decompress(raw)
                props.append(np.frombuffer(raw, dt))
                pos += clen
            else:
                raise ValueError(f"bad property code {code!r} @ {pos}")
        children = []
        while pos < end:
            child, pos = read_node(pos)
            if child is None:
                break
            children.append(child)
        if pos != end:
            raise ValueError(f"node '{name}' end offset mismatch")
        return FbxNode(name, props, children), end

    pos, roots = 27, []
    while True:
        node, pos = read_node(pos)
        if node is None:
            break
        roots.append(node)
    return version, roots


# --------------------------------------------------------------------------
# scene assembly
# --------------------------------------------------------------------------
def _p70(entries) -> FbxNode:
    n = FbxNode("Properties70")
    for e in entries:
        n.add("P", *e)
    return n


def _header(fps: float, nframes: int) -> List[FbxNode]:
    gs = FbxNode("GlobalSettings")
    gs.add("Version", 1000)
    gs.children.append(_p70([
        ("UpAxis", "int", "Integer", "", 1),
        ("UpAxisSign", "int", "Integer", "", 1),
        ("FrontAxis", "int", "Integer", "", 2),
        ("FrontAxisSign", "int", "Integer", "", 1),
        ("CoordAxis", "int", "Integer", "", 0),
        ("CoordAxisSign", "int", "Integer", "", 1),
        ("OriginalUpAxis", "int", "Integer", "", 1),
        ("OriginalUpAxisSign", "int", "Integer", "", 1),
        ("UnitScaleFactor", "double", "Number", "", 1.0),
        ("OriginalUnitScaleFactor", "double", "Number", "", 1.0),
        ("TimeMode", "enum", "", "", 14),  # custom framerate
        ("CustomFrameRate", "double", "Number", "", float(fps)),
        ("TimeSpanStart", "KTime", "Time", "", 0),
        ("TimeSpanStop", "KTime", "Time", "",
         int(nframes / fps * KTIME_PER_SEC)),
    ]))
    return [gs]


def _definitions(counts: dict) -> FbxNode:
    d = FbxNode("Definitions")
    d.add("Version", 100)
    d.add("Count", sum(counts.values()))
    for typ, cnt in counts.items():
        ot = FbxNode("ObjectType", [typ])
        ot.add("Count", cnt)
        d.children.append(ot)
    return d


class _Scene:
    """Objects + Connections accumulator with unique 64-bit ids."""

    def __init__(self):
        self.objects = FbxNode("Objects")
        self.connections = FbxNode("Connections")
        self._next_id = 1000000

    def new_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def connect_oo(self, child: int, parent: int) -> None:
        self.connections.add("C", "OO", child, parent)

    def connect_op(self, child: int, parent: int, prop: str) -> None:
        self.connections.add("C", "OP", child, parent, prop)

    def limb_node(self, name: str, translation, is_root: bool) -> int:
        uid = self.new_id()
        m = FbxNode("Model", [uid, f"Model::{name}",
                              "Null" if is_root else "LimbNode"])
        m.add("Version", 232)
        m.children.append(_p70([
            ("Lcl Translation", "Lcl Translation", "", "A",
             float(translation[0]), float(translation[1]),
             float(translation[2])),
            ("Lcl Rotation", "Lcl Rotation", "", "A", 0.0, 0.0, 0.0),
            ("Lcl Scaling", "Lcl Scaling", "", "A", 1.0, 1.0, 1.0),
            ("DefaultAttributeIndex", "int", "Integer", "", 0),
        ]))
        m.add("Shading", True)
        m.add("Culling", "CullingOff")
        self.objects.children.append(m)

        aid = self.new_id()
        a = FbxNode("NodeAttribute",
                    [aid, f"NodeAttribute::{name}",
                     "Root" if is_root else "LimbNode"])
        a.children.append(_p70([("Size", "double", "Number", "", 1.0)]))
        a.add("TypeFlags", "Skeleton")
        self.objects.children.append(a)
        self.connect_oo(aid, uid)
        return uid

    def anim_stack_layer(self, nframes: int, fps: float):
        sid = self.new_id()
        stop = int(nframes / fps * KTIME_PER_SEC)
        st = FbxNode("AnimationStack", [sid, "AnimStack::Take 001", ""])
        st.children.append(_p70([
            ("LocalStop", "KTime", "Time", "", stop),
            ("ReferenceStop", "KTime", "Time", "", stop)]))
        self.objects.children.append(st)
        lid = self.new_id()
        self.objects.children.append(
            FbxNode("AnimationLayer", [lid, "AnimLayer::BaseLayer", ""]))
        self.connect_oo(lid, sid)
        return lid

    def animate(self, layer_id: int, model_id: int, prop: str,
                times_ticks: np.ndarray, values_xyz: np.ndarray,
                defaults) -> None:
        """One AnimationCurveNode (d|X, d|Y, d|Z) + 3 AnimationCurves for
        `prop` ('Lcl Translation' / 'Lcl Rotation') on model_id."""
        cn_id = self.new_id()
        cn = FbxNode("AnimationCurveNode", [cn_id, "AnimCurveNode::T", ""])
        cn.children.append(_p70([
            ("d|X", "Number", "", "A", float(defaults[0])),
            ("d|Y", "Number", "", "A", float(defaults[1])),
            ("d|Z", "Number", "", "A", float(defaults[2]))]))
        self.objects.children.append(cn)
        self.connect_oo(cn_id, layer_id)
        self.connect_op(cn_id, model_id, prop)
        nk = len(times_ticks)
        for axis, chan in enumerate("XYZ"):
            cid = self.new_id()
            c = FbxNode("AnimationCurve", [cid, "AnimCurve::", ""])
            c.add("Default", float(defaults[axis]))
            c.add("KeyVer", 4008)
            c.add("KeyTime", times_ticks.astype(np.int64))
            c.add("KeyValueFloat",
                  values_xyz[:, axis].astype(np.float32))
            c.add("KeyAttrFlags", np.asarray([8456], np.int32))  # linear
            c.add("KeyAttrDataFloat", np.zeros(4, np.float32))
            c.add("KeyAttrRefCount", np.asarray([nk], np.int32))
            self.objects.children.append(c)
            self.connect_op(cid, cn_id, f"d|{chan}")


def _assemble(scene: _Scene, fps: float, nframes: int, path: str,
              counts: dict) -> None:
    roots = _header(fps, nframes)
    roots.append(_definitions(counts))
    roots.append(scene.objects)
    roots.append(scene.connections)
    write_fbx(path, roots)


# --------------------------------------------------------------------------
# public exporters
# --------------------------------------------------------------------------
def export_skeleton_fbx(path: str, joints: np.ndarray,
                        parents: Sequence[int],
                        names: Optional[Sequence[str]] = None,
                        fps: float = 20.0, scale: float = 100.0) -> None:
    """joints [T, J, 3] world positions (demo.py npy output) -> FBX with a
    LimbNode per joint and per-frame LOCAL translation curves
    (child world pos - parent world pos; root gets world pos).

    scale=100: meters -> centimeters, the FBX convention the reference rig
    uses (fbx_output.py:127 multiplies translations by 100).
    """
    joints = np.asarray(joints, np.float64) * scale
    T, J, _ = joints.shape
    names = list(names) if names is not None else [
        f"joint_{i:02d}" for i in range(J)]
    parents = list(parents)

    local = joints.copy()
    for j, p in enumerate(parents):
        if p >= 0:
            local[:, j] = joints[:, j] - joints[:, p]

    scene = _Scene()
    ids = []
    for j in range(J):
        ids.append(scene.limb_node(names[j], local[0, j], parents[j] < 0))
    for j, p in enumerate(parents):
        scene.connect_oo(ids[j], ids[p] if p >= 0 else 0)  # 0 = root doc

    layer = scene.anim_stack_layer(T, fps)
    ticks = (np.arange(T, dtype=np.int64) * KTIME_PER_SEC
             / fps).astype(np.int64)
    for j in range(J):
        scene.animate(layer, ids[j], "Lcl Translation", ticks, local[:, j],
                      local[0, j])
    _assemble(scene, fps, T, path,
              {"Model": J, "NodeAttribute": J, "AnimationStack": 1,
               "AnimationLayer": 1, "AnimationCurveNode": J,
               "AnimationCurve": 3 * J, "GlobalSettings": 1})


def _axis_angle_to_euler_xyz_deg(aa: np.ndarray) -> np.ndarray:
    """[..., 3] axis-angle -> XYZ-order euler degrees (FBX default
    RotationOrder). Rodrigues as in fbx_output.py:81-90."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = np.where(theta > 1e-12, aa / np.maximum(theta, 1e-12), 0.0)
    c, s = np.cos(theta[..., 0]), np.sin(theta[..., 0])
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    C = 1 - c
    R = np.empty(aa.shape[:-1] + (3, 3))
    R[..., 0, 0] = x * x * C + c
    R[..., 0, 1] = x * y * C - z * s
    R[..., 0, 2] = x * z * C + y * s
    R[..., 1, 0] = y * x * C + z * s
    R[..., 1, 1] = y * y * C + c
    R[..., 1, 2] = y * z * C - x * s
    R[..., 2, 0] = z * x * C - y * s
    R[..., 2, 1] = z * y * C + x * s
    R[..., 2, 2] = z * z * C + c
    # R = Rz @ Ry @ Rx (XYZ rotation order, x applied first)
    sy = -R[..., 2, 0]
    cy = np.sqrt(np.clip(1 - sy ** 2, 0.0, None))
    gim = cy < 1e-8
    ex = np.where(gim, np.arctan2(-R[..., 1, 2], R[..., 1, 1]),
                  np.arctan2(R[..., 2, 1], R[..., 2, 2]))
    ey = np.arcsin(np.clip(sy, -1.0, 1.0))
    ez = np.where(gim, 0.0, np.arctan2(R[..., 1, 0], R[..., 0, 0]))
    return np.degrees(np.stack([ex, ey, ez], axis=-1))


def export_smpl_fbx(path: str, poses: np.ndarray,
                    trans: Optional[np.ndarray] = None,
                    offsets: Optional[np.ndarray] = None,
                    fps: float = 20.0, scale: float = 100.0) -> None:
    """SMPL pose animation -> FBX rig (reference fbx_output.py semantics:
    per-bone rotation keyframes + pelvis location keyframes).

    poses   [T, 24, 3] axis-angle per bone (fit.py pkl 'pose' reshaped)
    trans   [T, 3] root translation in meters (optional)
    offsets [24, 3] rest-pose bone head positions in meters (optional;
            defaults to a schematic SMPL-proportioned rest pose so the
            file opens standalone without licensed SMPL assets)
    """
    poses = np.asarray(poses, np.float64)
    T = poses.shape[0]
    poses = poses.reshape(T, -1, 3)[:, :24]
    if offsets is None:
        offsets = _DEFAULT_SMPL_OFFSETS
    offsets = np.asarray(offsets, np.float64) * scale
    local_off = offsets.copy()
    for j, p in enumerate(SMPL_PARENTS):
        if p >= 0:
            local_off[j] = offsets[j] - offsets[p]

    euler = _axis_angle_to_euler_xyz_deg(poses)           # [T, 24, 3]

    scene = _Scene()
    ids = []
    for j, name in enumerate(SMPL_BONE_NAMES):
        ids.append(scene.limb_node(name, local_off[j], j == 0))
    for j, p in enumerate(SMPL_PARENTS):
        scene.connect_oo(ids[j], ids[p] if p >= 0 else 0)

    layer = scene.anim_stack_layer(T, fps)
    ticks = (np.arange(T, dtype=np.int64) * KTIME_PER_SEC
             / fps).astype(np.int64)
    for j in range(24):
        scene.animate(layer, ids[j], "Lcl Rotation", ticks, euler[:, j],
                      euler[0, j])
    if trans is not None:
        tr = np.asarray(trans, np.float64) * scale + local_off[0]
        scene.animate(layer, ids[0], "Lcl Translation", ticks, tr, tr[0])
    _assemble(scene, fps, T, path,
              {"Model": 24, "NodeAttribute": 24, "AnimationStack": 1,
               "AnimationLayer": 1, "AnimationCurveNode": 24 + 1,
               "AnimationCurve": 3 * (24 + 1), "GlobalSettings": 1})


# schematic SMPL rest-pose joint positions (meters, Y-up) — proportioned
# from the SMPL template skeleton; used only when no SMPL model is present
_DEFAULT_SMPL_OFFSETS = np.array([
    [0.000, 0.940, 0.000],   # Pelvis
    [0.080, 0.870, 0.000],   # L_Hip
    [-0.080, 0.870, 0.000],  # R_Hip
    [0.000, 1.050, 0.000],   # Spine1
    [0.100, 0.490, 0.000],   # L_Knee
    [-0.100, 0.490, 0.000],  # R_Knee
    [0.000, 1.180, 0.000],   # Spine2
    [0.090, 0.090, 0.000],   # L_Ankle
    [-0.090, 0.090, 0.000],  # R_Ankle
    [0.000, 1.240, 0.000],   # Spine3
    [0.110, 0.020, 0.120],   # L_Foot
    [-0.110, 0.020, 0.120],  # R_Foot
    [0.000, 1.400, 0.000],   # Neck
    [0.070, 1.310, 0.000],   # L_Collar
    [-0.070, 1.310, 0.000],  # R_Collar
    [0.000, 1.520, 0.000],   # Head
    [0.180, 1.370, 0.000],   # L_Shoulder
    [-0.180, 1.370, 0.000],  # R_Shoulder
    [0.430, 1.360, 0.000],   # L_Elbow
    [-0.430, 1.360, 0.000],  # R_Elbow
    [0.680, 1.360, 0.000],   # L_Wrist
    [-0.680, 1.360, 0.000],  # R_Wrist
    [0.770, 1.360, 0.000],   # L_Hand
    [-0.770, 1.360, 0.000],  # R_Hand
])
