"""Keypoint JSON writers: per-frame people JSON and COCO evaluation JSON.

People JSON reproduces the reference schema byte-compatibly at the structural
level (version "1.3", key order) — reference:
src/openpose/filestream/fileStream.cpp:306-345 savePeopleJson and
include/openpose/filestream/wPeopleJsonSaver.hpp:78-92 (key list).

COCO JSON reproduces CocoJsonSaver::record
(src/openpose/filestream/cocoJsonSaver.cpp:93-280): per-person entries with
model-specific part reordering into the 17-keypoint COCO order, -1 fill for
missing points, visibility 1/0, score = person score.

The port's own copy of `openpose_tpu/io/json_io.py` (host code, no framework):
the port imports nothing of the JAX package, and
`tests/test_torch_standalone.py` holds the two copies to each other.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def _flatten(arr: Optional[np.ndarray], person: int) -> List[float]:
    if arr is None or arr.size == 0:
        return []
    # vectorized: np.round is half-to-even like builtins.round, and
    # .tolist() yields Python floats json.dump serializes identically —
    # the per-value round() loop was ~40% of the people-JSON host tail
    return np.round(
        np.asarray(arr[person], np.float64).reshape(-1), 6).tolist()


def people_json(pose_keypoints: Optional[np.ndarray] = None,
                face_keypoints: Optional[np.ndarray] = None,
                hand_left_keypoints: Optional[np.ndarray] = None,
                hand_right_keypoints: Optional[np.ndarray] = None,
                pose_keypoints_3d: Optional[np.ndarray] = None,
                face_keypoints_3d: Optional[np.ndarray] = None,
                hand_left_keypoints_3d: Optional[np.ndarray] = None,
                hand_right_keypoints_3d: Optional[np.ndarray] = None,
                person_ids: Optional[Sequence[int]] = None,
                candidates: Optional[List[np.ndarray]] = None) -> Dict:
    """Build the per-frame people dict (serialize with json.dump)."""
    n_people = 0
    for arr in (pose_keypoints, face_keypoints, hand_left_keypoints,
                hand_right_keypoints):
        if arr is not None and arr.size:
            n_people = max(n_people, arr.shape[0])
    people = []
    for person in range(n_people):
        entry = {
            "person_id": [int(person_ids[person]) if person_ids is not None
                          and person < len(person_ids) else -1],
            "pose_keypoints_2d": _flatten(pose_keypoints, person),
            "face_keypoints_2d": _flatten(face_keypoints, person),
            "hand_left_keypoints_2d": _flatten(hand_left_keypoints, person),
            "hand_right_keypoints_2d": _flatten(hand_right_keypoints, person),
            "pose_keypoints_3d": _flatten(pose_keypoints_3d, person),
            "face_keypoints_3d": _flatten(face_keypoints_3d, person),
            "hand_left_keypoints_3d": _flatten(hand_left_keypoints_3d, person),
            "hand_right_keypoints_3d": _flatten(hand_right_keypoints_3d, person),
        }
        people.append(entry)
    out = {"version": 1.3, "people": people}
    if candidates is not None:
        out["part_candidates"] = [{
            str(part): [round(float(v), 6) for v in np.asarray(c).reshape(-1)]
            for part, c in enumerate(candidates)}]
    return out


def save_people_json(path: str, **kwargs) -> None:
    with open(path, "w") as f:
        json.dump(people_json(**kwargs), f, separators=(",", ":"))


# COCO part order maps (cocoJsonSaver.cpp:117-141)
_COCO_ORDER_BY_PARTS = {
    18: [0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10],
    23: [0, 14, 13, 16, 15, 4, 1, 5, 2, 6, 3, 10, 7, 11, 8, 12, 9],
    25: [0, 16, 15, 18, 17, 5, 2, 6, 3, 7, 4, 12, 9, 13, 10, 14, 11],
    19: [0, 16, 15, 18, 17, 5, 2, 6, 3, 7, 4, 12, 9, 13, 10, 14, 11],
}
# Foot variant (cocoJsonSaver.cpp:140-147): 6 foot keypoints
_FOOT_ORDER_BY_PARTS = {25: [19, 20, 21, 22, 23, 24],
                        23: [17, 18, 19, 20, 21, 22]}
# Wrist body-part indices (LWrist, RWrist) shared by BODY_25/COCO_18/MPI_15
# (poseParameters.cpp part name tables)
_WRISTS_BY_PARTS = {25: (7, 4), 19: (7, 4), 18: (7, 4), 15: (7, 4)}

# Variant bitmask (CocoJsonSaver ctor, cocoJsonSaver.cpp:46-70):
# 1 = body, 2 = foot, 4 = face, 8 = hand21, 16 = hand42; < 1 = all five.
VARIANT_BODY, VARIANT_FOOT, VARIANT_FACE = 1, 2, 4
VARIANT_HAND21, VARIANT_HAND42 = 8, 16
_VARIANT_SUFFIX = {VARIANT_BODY: "", VARIANT_FOOT: "_foot",
                   VARIANT_FACE: "_face", VARIANT_HAND21: "_hand21",
                   VARIANT_HAND42: "_hand42"}


class CocoJsonSaver:
    """Accumulate COCO-format detection entries; write with .save().

    `variants` is the reference's `--write_coco_json_variants` bitmask
    (cocoJsonSaver.cpp:46-70): each set bit opens one output stream; the
    foot/face/hand streams are written next to the body file with
    `_foot`/`_face`/`_hand21`/`_hand42` suffixes.  The reference's BODY_135
    flat-array indices (F135/H135 offsets, cocoJsonSaver.cpp:149-178) map to
    this framework's separate datum arrays: face = the first 68 of the
    70-keypoint face model; hand21 = body RWrist + right-hand points 1-20;
    hand42 = body LWrist + left-hand 1-20 + body RWrist + right-hand 1-20
    (each hand's point 0 is its wrist, superseded by the body estimate).
    """

    def __init__(self, variants: int = VARIANT_BODY, foot: bool = False):
        if variants >= 32:
            raise ValueError(
                "unknown value for --write_coco_json_variants (bitmask of "
                "1=body 2=foot 4=face 8=hand21 16=hand42, or <1 for all)")
        if variants < 1:
            variants = (VARIANT_BODY | VARIANT_FOOT | VARIANT_FACE
                        | VARIANT_HAND21 | VARIANT_HAND42)
        # Legacy internal foot=True mode writes the foot stream at the bare
        # path; the variants bitmask always applies the _foot suffix
        # (cocoJsonSaver.cpp ctor opens filePath+"_foot."+extension).
        self._legacy_foot = bool(foot)
        if foot:
            variants = VARIANT_FOOT
        self.variants = variants
        self.entries: Dict[int, List[Dict]] = {
            v: [] for v in _VARIANT_SUFFIX if variants & v}

    def record(self, pose_keypoints: np.ndarray, pose_scores: np.ndarray,
               image_id: int,
               face_keypoints: Optional[np.ndarray] = None,
               hand_left_keypoints: Optional[np.ndarray] = None,
               hand_right_keypoints: Optional[np.ndarray] = None,
               frame_number: Optional[int] = None) -> None:
        """Append one frame's people to every open variant stream.

        Body/foot entries use the filename-parsed `image_id`; face/hand
        streams use `frame_number` (reference: cocoJsonSaver.cpp sets
        imageId = frameNumber and only reassigns it via
        getLastNumberWithErrorMessage for the Body/Foot/Car streams).
        """
        if pose_keypoints.size == 0:
            return
        if frame_number is None:
            frame_number = image_id
        num_parts = pose_keypoints.shape[1]
        wrists = _WRISTS_BY_PARTS.get(num_parts, (7, 4))
        for person in range(pose_keypoints.shape[0]):
            score = round(float(pose_scores[person]), 6)
            for variant, entries in self.entries.items():
                entry_id = (image_id if variant in (VARIANT_BODY, VARIANT_FOOT)
                            else frame_number)
                pts = self._person_points(
                    variant, num_parts, wrists, pose_keypoints[person],
                    None if face_keypoints is None
                    else face_keypoints[person],
                    None if hand_left_keypoints is None
                    else hand_left_keypoints[person],
                    None if hand_right_keypoints is None
                    else hand_right_keypoints[person])
                if pts is None:
                    continue
                valid = pts[:, 2] > 0
                if not valid.any():      # cocoJsonSaver.cpp:208-222
                    continue
                flat: List = []
                for (x, y, _), v in zip(pts, valid):
                    flat += [round(float(x), 3) if v else -1.0,
                             round(float(y), 3) if v else -1.0,
                             1 if v else 0]
                entries.append({"image_id": int(entry_id), "category_id": 1,
                                "keypoints": flat, "score": score})

    @staticmethod
    def _person_points(variant, num_parts, wrists, pose, face, hl, hr):
        """-> [K, 3] points for one person/variant, or None if inapplicable."""
        if variant == VARIANT_BODY:
            order = _COCO_ORDER_BY_PARTS.get(num_parts)
            if order is None:
                raise ValueError(f"no COCO order for {num_parts} parts")
            return pose[order]
        if variant == VARIANT_FOOT:
            order = _FOOT_ORDER_BY_PARTS.get(num_parts)
            if order is None:
                # Reference errors with "Invalid number of body parts" when
                # the foot stream is fed a footless model (cocoJsonSaver.cpp).
                raise ValueError(
                    f"foot COCO stream requested but model has {num_parts} "
                    "body parts (no foot keypoints)")
            return pose[order]
        if variant == VARIANT_FACE:
            return None if face is None or face.size == 0 else face[:68]
        if variant == VARIANT_HAND21:
            if hr is None or hr.size == 0:
                return None
            return np.concatenate([pose[wrists[1]:wrists[1] + 1], hr[1:21]])
        if variant == VARIANT_HAND42:
            if hl is None or hr is None or not (hl.size and hr.size):
                return None
            return np.concatenate([pose[wrists[0]:wrists[0] + 1], hl[1:21],
                                   pose[wrists[1]:wrists[1] + 1], hr[1:21]])
        raise AssertionError(variant)

    def save(self, path: str) -> None:
        """Write each variant stream (body at `path`, others suffixed)."""
        import pathlib
        p = pathlib.Path(path)
        for variant, entries in self.entries.items():
            suffix = _VARIANT_SUFFIX[variant]
            if suffix and not self._legacy_foot:
                out = p.with_name(p.stem + suffix + p.suffix)
            else:
                out = p            # body stream, or legacy foot-only mode
            with open(out, "w") as f:
                json.dump(entries, f)


def image_id_from_name(name: str) -> int:
    """Last number in the file name (getLastNumber, cocoJsonSaver.cpp)."""
    import re
    nums = re.findall(r"\d+", name)
    if not nums:
        raise ValueError(f"no number in image name {name!r}")
    return int(nums[-1])
