"""Hand ROI estimation from body keypoints + temporal rectangle smoothing.

Transcribes getHandFromPoseIndexes / getAreaRatio / trackHand
(src/openpose/hand/handDetector.cpp:9-125): the hand square is extrapolated
beyond the wrist along the elbow->wrist direction, sized from arm geometry.

The port's own copy of `openpose_tpu/hand/detector.py` (host code, no framework):
the port imports nothing of the JAX package, and
`tests/test_torch_standalone.py` holds the two copies to each other.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from openpose_tpu_torch.params import PoseModel

Rect = Tuple[float, float, float, float]

# (l_wrist, l_elbow, l_shoulder, r_wrist, r_elbow, r_shoulder)
_ARM_PARTS = {
    PoseModel.BODY_25: (7, 6, 5, 4, 3, 2),
    PoseModel.COCO_18: (7, 6, 5, 4, 3, 2),
    PoseModel.MPI_15: (7, 6, 5, 4, 3, 2),
    PoseModel.MPI_15_4: (7, 6, 5, 4, 3, 2),
}


def _hand_rect(kp: np.ndarray, wrist: int, elbow: int, shoulder: int,
               threshold: float) -> Rect:
    if not (kp[wrist, 2] > threshold and kp[elbow, 2] > threshold
            and kp[shoulder, 2] > threshold):
        return (0.0, 0.0, 0.0, 0.0)
    ratio = 0.33
    cx = float(kp[wrist, 0] + ratio * (kp[wrist, 0] - kp[elbow, 0]))
    cy = float(kp[wrist, 1] + ratio * (kp[wrist, 1] - kp[elbow, 1]))
    d_we = float(np.hypot(kp[wrist, 0] - kp[elbow, 0],
                          kp[wrist, 1] - kp[elbow, 1]))
    d_es = float(np.hypot(kp[elbow, 0] - kp[shoulder, 0],
                          kp[elbow, 1] - kp[shoulder, 1]))
    size = 1.5 * max(d_we, 0.9 * d_es)
    return (cx - size / 2.0, cy - size / 2.0, size, size)


def detect_hands(pose_keypoints: np.ndarray, model: PoseModel,
                 threshold: float = 0.03) -> List[Tuple[Rect, Rect]]:
    """[people, parts, 3] -> [(left_rect, right_rect)] per person."""
    lw, le, ls, rw, re, rs = _ARM_PARTS[model]
    out = []
    for p in range(pose_keypoints.shape[0]):
        kp = pose_keypoints[p]
        out.append((_hand_rect(kp, lw, le, ls, threshold),
                    _hand_rect(kp, rw, re, rs, threshold)))
    return out


def _area_ratio(a: Rect, b: Rect) -> float:
    """Overlap over the smaller area (getAreaRatio, handDetector.cpp:64-88)."""
    sa = a[2] * a[3]
    sb = b[2] * b[3]
    si = max(0.0, 1.0 + min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0])) \
        * max(0.0, 1.0 + min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    su = min(sa, sb)
    return min(1.0, si / su) if su > 0 else 0.0


def track_hand(current: Rect, previous: List[Rect]) -> Rect:
    """Smooth a rect with the best-overlapping previous-frame rect
    (trackHand, handDetector.cpp:90-125)."""
    if current[2] * current[3] <= 0 or not previous:
        return current
    best_idx, best_val = -1, 0.0
    for i, prev in enumerate(previous):
        r = _area_ratio(current, prev)
        if r > best_val:
            best_val, best_idx = r, i
    if best_idx < 0:
        return current
    prev = previous[best_idx]
    ratio = 2.0
    new_w = max((current[2] * ratio + prev[2]) * 0.5,
                (current[3] * ratio + prev[3]) * 0.5)
    x = 0.5 * (current[0] + prev[0] + 0.5 * (current[2] + prev[2]) - new_w)
    y = 0.5 * (current[1] + prev[1] + 0.5 * (current[3] + prev[3]) - new_w)
    return (x, y, new_w, new_w)
