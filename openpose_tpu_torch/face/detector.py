"""Face ROI estimation from body keypoints.

Transcribes getFaceFromPoseKeypoints (src/openpose/face/faceDetector.cpp:22-120):
the face square is estimated from neck/nose/eyes/ears geometry, with a
profile-view special case, or from neck+head for MPI-style models.

The port's own copy of `openpose_tpu/face/detector.py` (host code, no framework):
the port imports nothing of the JAX package, and
`tests/test_torch_standalone.py` holds the two copies to each other.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from openpose_tpu_torch.params import PoseModel, POSE_MODEL_INFO

# part indices per model: (neck, nose/head, lear, rear, leye, reye)
_FACE_PARTS = {
    PoseModel.BODY_25: (1, 0, 18, 17, 16, 15),
    PoseModel.COCO_18: (1, 0, 17, 16, 15, 14),
    PoseModel.MPI_15: (1, 0, 0, 0, 0, 0),     # head-based branch
    PoseModel.MPI_15_4: (1, 0, 0, 0, 0, 0),
}


def _dist(kp, a, b):
    return float(np.hypot(kp[a, 0] - kp[b, 0], kp[a, 1] - kp[b, 1]))


def face_rect_from_pose(kp: np.ndarray, model: PoseModel,
                        threshold: float = 0.25) -> Tuple[float, float, float, float]:
    """kp: [parts, 3] one person -> (x, y, w, h) square (w==h, 0 if missing)."""
    neck, nose, lear, rear, leye, reye = _FACE_PARTS[model]
    above = kp[:, 2] > threshold
    cx = cy = size = 0.0

    if nose == lear == rear:  # MPI: neck + head
        if above[neck] and above[nose]:
            cx, cy = float(kp[nose, 0]), float(kp[nose, 1])
            size = 1.33 * _dist(kp, neck, nose)
    else:
        counter = 0
        if above[neck] and above[nose]:
            if (above[leye] == above[lear] and above[reye] == above[rear]
                    and above[leye] != above[reye]):
                e, r = (leye, lear) if above[leye] else (reye, rear)
                cx += float(kp[e, 0] + kp[r, 0] + kp[nose, 0]) / 3.0
                cy += float(kp[e, 1] + kp[r, 1] + kp[nose, 1]) / 3.0
                size += 0.85 * (_dist(kp, nose, e) + _dist(kp, nose, r)
                                + _dist(kp, neck, nose))
            else:
                cx += float(kp[neck, 0] + kp[nose, 0]) / 2.0
                cy += float(kp[neck, 1] + kp[nose, 1]) / 2.0
                size += 2.0 * _dist(kp, neck, nose)
            counter += 1
        if above[leye] and above[reye]:
            cx += float(kp[leye, 0] + kp[reye, 0]) / 2.0
            cy += float(kp[leye, 1] + kp[reye, 1]) / 2.0
            size += 3.0 * _dist(kp, leye, reye)
            counter += 1
        if above[lear] and above[rear]:
            cx += float(kp[lear, 0] + kp[rear, 0]) / 2.0
            cy += float(kp[lear, 1] + kp[rear, 1]) / 2.0
            size += 2.0 * _dist(kp, lear, rear)
            counter += 1
        if counter > 0:
            cx /= counter
            cy /= counter
            size /= counter
    return (cx - size / 2.0, cy - size / 2.0, size, size)


def detect_faces(pose_keypoints: np.ndarray, model: PoseModel,
                 threshold: float = 0.25) -> List[Tuple[float, float, float, float]]:
    """[people, parts, 3] -> list of (x, y, w, h) per person."""
    return [face_rect_from_pose(pose_keypoints[p], model, threshold)
            for p in range(pose_keypoints.shape[0])]
