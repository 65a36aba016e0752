"""BVH skeletal-animation export from 3-D pose keypoints.

The reference's BvhSaver (src/openpose/filestream/bvhSaver.cpp, 595 LoC) is
compiled only with ``USE_3D_ADAM_MODEL`` and emits the Adam model's joint
angles.  The Adam model is not redistributable, so this module instead derives
a BVH rig directly from the triangulated keypoints the 3-D pipeline already
produces (threed/triangulation.py): rest-pose bone offsets are taken from the
first frame in which a bone is observed, and each frame's motion is the set of
local joint rotations (ZXY Euler, degrees) that carry the rest-pose bone
directions onto the observed ones, plus a root translation.  The output loads
in standard BVH consumers (Blender, bvhacker).

Coordinate convention: OpenPose 3-D keypoints are (x, y, z, score) with y
pointing down (image convention); BVH uses y-up, so y and z rows are negated/
swapped is NOT done here — we export the raw triangulated frame and leave the
axis convention to the consumer, matching how the reference streams raw Adam
coordinates over UDP.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..params import (BODY_25_PARTS, COCO_18_PARTS, MPI_15_PARTS, PoseModel)

_PART_NAMES: Dict[PoseModel, Dict[int, str]] = {
    PoseModel.BODY_25: BODY_25_PARTS,
    PoseModel.COCO_18: COCO_18_PARTS,
    PoseModel.MPI_15: MPI_15_PARTS,
    PoseModel.MPI_15_4: MPI_15_PARTS,
}

# Skeleton trees: {child_part_index: parent_part_index}; the root has no entry.
# Topology follows the reference's limb pair lists (poseParameters.cpp:416-440)
# arranged as a tree rooted at the hip.
_BODY_25_ROOT = 8  # MidHip
_BODY_25_TREE: Dict[int, int] = {
    9: 8, 10: 9, 11: 10, 22: 11, 23: 22, 24: 11,      # right leg/foot
    12: 8, 13: 12, 14: 13, 19: 14, 20: 19, 21: 14,    # left leg/foot
    1: 8,                                             # spine
    0: 1, 15: 0, 17: 15, 16: 0, 18: 16,               # head
    2: 1, 3: 2, 4: 3,                                 # right arm
    5: 1, 6: 5, 7: 6,                                 # left arm
}

_COCO_18_ROOT = 1  # Neck (COCO has no MidHip)
_COCO_18_TREE: Dict[int, int] = {
    0: 1, 14: 0, 16: 14, 15: 0, 17: 15,
    2: 1, 3: 2, 4: 3,
    5: 1, 6: 5, 7: 6,
    8: 1, 9: 8, 10: 9,
    11: 1, 12: 11, 13: 12,
}

_MPI_15_ROOT = 14  # Chest
_MPI_15_TREE: Dict[int, int] = {
    1: 14, 0: 1,
    2: 1, 3: 2, 4: 3,
    5: 1, 6: 5, 7: 6,
    8: 14, 9: 8, 10: 9,
    11: 14, 12: 11, 13: 12,
}

_SKELETONS: Dict[PoseModel, Tuple[int, Dict[int, int]]] = {
    PoseModel.BODY_25: (_BODY_25_ROOT, _BODY_25_TREE),
    PoseModel.COCO_18: (_COCO_18_ROOT, _COCO_18_TREE),
    PoseModel.MPI_15: (_MPI_15_ROOT, _MPI_15_TREE),
    PoseModel.MPI_15_4: (_MPI_15_ROOT, _MPI_15_TREE),
}


def _children(tree: Dict[int, int]) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {}
    for child, parent in tree.items():
        out.setdefault(parent, []).append(child)
    for v in out.values():
        v.sort()
    return out


def _align_rotation(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimal rotation matrix carrying unit vector a onto unit vector b."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = float(np.linalg.norm(v))
    if s < 1e-9:
        if c > 0.0:
            return np.eye(3)
        # 180-degree flip: rotate about any axis orthogonal to a
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis = axis / np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * ((1.0 - c) / (s * s))


def _euler_zxy_deg(rot: np.ndarray) -> Tuple[float, float, float]:
    """Decompose rot = Rz @ Rx @ Ry into (z, x, y) angles in degrees."""
    sx = np.clip(rot[2, 1], -1.0, 1.0)
    x = np.arcsin(sx)
    if abs(sx) < 0.9999999:
        z = np.arctan2(-rot[0, 1], rot[1, 1])
        y = np.arctan2(-rot[2, 0], rot[2, 2])
    else:  # gimbal lock: fold y into z
        z = np.arctan2(rot[1, 0], rot[0, 0])
        y = 0.0
    return (float(np.degrees(z)), float(np.degrees(x)), float(np.degrees(y)))


def rotation_zxy_deg(z: float, x: float, y: float) -> np.ndarray:
    """Compose the ZXY Euler rotation (the inverse of _euler_zxy_deg)."""
    cz, sz = np.cos(np.radians(z)), np.sin(np.radians(z))
    cx, sx = np.cos(np.radians(x)), np.sin(np.radians(x))
    cy, sy = np.cos(np.radians(y)), np.sin(np.radians(y))
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
    rx = np.array([[1.0, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1.0, 0], [-sy, 0, cy]])
    return rz @ rx @ ry


class BvhSaver:
    """Accumulates per-frame 3-D pose keypoints and writes one BVH file.

    Tracks the first person of each frame (BVH animates a single rig, like the
    reference's Adam stream).  Keypoints: [people, parts, 4] (x, y, z, score);
    score <= 0 marks an unobserved joint, which holds its previous rotation.
    """

    def __init__(self, path: str, model: PoseModel = PoseModel.BODY_25,
                 fps: float = 30.0):
        if model not in _SKELETONS:
            raise ValueError(f"no BVH skeleton for {model}")
        self.path = path
        self.model = model
        self.frame_time = 1.0 / max(fps, 1e-6)
        self.root, self.tree = _SKELETONS[model]
        self.children = _children(self.tree)
        # Depth-first order: the hierarchy section AND every motion row list
        # joint channels in exactly this order.
        self.dfs_order: List[int] = []

        def _dfs(j: int) -> None:
            self.dfs_order.append(j)
            for c in self.children.get(j, []):
                _dfs(c)

        _dfs(self.root)
        self.frames: List[np.ndarray] = []

    def add_frame(self, keypoints_3d: Optional[np.ndarray]) -> None:
        if keypoints_3d is None or keypoints_3d.size == 0:
            kp = np.zeros((max(self.dfs_order) + 1, 4), np.float32)
        else:
            kp = np.asarray(keypoints_3d, np.float32)
            if kp.ndim == 3:
                kp = kp[0]
        self.frames.append(kp)

    # -- rig construction ----------------------------------------------------

    def _rest_offsets(self) -> Dict[int, np.ndarray]:
        """Bone offset of each joint from its parent, taken from the first
        frame observing both ends; unobserved bones get a unit +y stub."""
        offsets: Dict[int, np.ndarray] = {}
        for child, parent in self.tree.items():
            offsets[child] = None
            for kp in self.frames:
                if kp[child, 3] > 0 and kp[parent, 3] > 0:
                    vec = kp[child, :3] - kp[parent, :3]
                    if np.linalg.norm(vec) > 1e-6:
                        offsets[child] = vec.astype(np.float64)
                        break
            if offsets[child] is None:
                offsets[child] = np.array([0.0, 1.0, 0.0])
        return offsets

    def _frame_motion(self, kp: np.ndarray, offsets: Dict[int, np.ndarray],
                      prev: Dict[int, np.ndarray]) -> List[float]:
        """One frame's channel row: root XYZ+ZXY, then per-joint ZXY rotations
        in depth-first hierarchy order.

        For each joint with an observed child bone, the joint's GLOBAL
        rotation aligns the rest bone direction with the observed one; its
        LOCAL rotation divides out the parent's global rotation.  Joints whose
        bones are unobserved this frame reuse their previous global rotation.
        """
        glob: Dict[int, np.ndarray] = {}
        for joint in self.dfs_order:
            rest_dirs, obs_dirs = [], []
            for child in self.children.get(joint, []):
                if kp[child, 3] > 0 and kp[joint, 3] > 0:
                    obs = kp[child, :3].astype(np.float64) - kp[joint, :3]
                    rest = offsets[child]
                    no, nr = np.linalg.norm(obs), np.linalg.norm(rest)
                    if no > 1e-6 and nr > 1e-6:
                        rest_dirs.append(rest / nr)
                        obs_dirs.append(obs / no)
            if not rest_dirs:
                rot = prev.get(joint, np.eye(3))
            elif len(rest_dirs) == 1:
                rot = _align_rotation(rest_dirs[0], obs_dirs[0])
            else:
                # Kabsch fit over all observed child bones: exact under rigid
                # motion, least-squares otherwise.
                h = sum(np.outer(r, o) for r, o in zip(rest_dirs, obs_dirs))
                u, _, vt = np.linalg.svd(h)
                d = np.sign(np.linalg.det(vt.T @ u.T))
                rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
            glob[joint] = rot
            prev[joint] = rot

        row: List[float] = []
        root_pos = kp[self.root, :3] if kp[self.root, 3] > 0 else \
            np.zeros(3, np.float32)
        row.extend(float(v) for v in root_pos)
        row.extend(_euler_zxy_deg(glob[self.root]))
        for joint in self.dfs_order[1:]:
            local = glob[self.tree[joint]].T @ glob[joint]
            row.extend(_euler_zxy_deg(local))
        return row

    # -- serialization --------------------------------------------------------

    def _write_joint(self, lines: List[str], joint: int, depth: int,
                     offsets: Dict[int, np.ndarray], names: Dict[int, str],
                     children: Dict[int, List[int]]) -> None:
        pad = "  " * depth
        off = offsets.get(joint, np.zeros(3))
        if depth == 0:
            lines.append(f"ROOT {names[joint]}")
            lines.append("{")
            lines.append("  OFFSET 0.000000 0.000000 0.000000")
            lines.append("  CHANNELS 6 Xposition Yposition Zposition "
                         "Zrotation Xrotation Yrotation")
        else:
            lines.append(f"{pad}JOINT {names[joint]}")
            lines.append(pad + "{")
            lines.append(f"{pad}  OFFSET {off[0]:.6f} {off[1]:.6f} "
                         f"{off[2]:.6f}")
            lines.append(f"{pad}  CHANNELS 3 Zrotation Xrotation Yrotation")
        kids = children.get(joint, [])
        if not kids:
            lines.append(f"{pad}  End Site")
            lines.append(pad + "  {")
            lines.append(f"{pad}    OFFSET 0.000000 0.100000 0.000000")
            lines.append(pad + "  }")
        for child in kids:
            self._write_joint(lines, child, depth + 1, offsets, names,
                              children)
        lines.append(pad + "}")

    def save(self) -> None:
        part_names = _PART_NAMES[self.model]
        names = {j: part_names.get(j, f"joint{j}") for j in self.dfs_order}
        offsets = self._rest_offsets()

        lines: List[str] = ["HIERARCHY"]
        self._write_joint(lines, self.root, 0, offsets, names, self.children)
        lines.append("MOTION")
        lines.append(f"Frames: {len(self.frames)}")
        lines.append(f"Frame Time: {self.frame_time:.6f}")
        prev: Dict[int, np.ndarray] = {}
        for kp in self.frames:
            row = self._frame_motion(kp, offsets, prev)
            lines.append(" ".join(f"{v:.6f}" for v in row))
        with open(self.path, "w") as f:
            f.write("\n".join(lines) + "\n")


def save_bvh(path: str, keypoints_3d_seq: Sequence[np.ndarray],
             model: PoseModel = PoseModel.BODY_25, fps: float = 30.0) -> None:
    """One-shot convenience: sequence of [people, parts, 4] frames -> BVH."""
    saver = BvhSaver(path, model, fps)
    for kp in keypoints_3d_seq:
        saver.add_frame(kp)
    saver.save()
