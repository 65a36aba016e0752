"""Skeleton / keypoint overlay rendering (host-side).

Mirrors renderKeypointsCpu (src/openpose/utilities/keypoint.cpp:177-278) and
the per-model entry points renderPoseKeypointsCpu
(src/openpose/pose/renderPose.cpp:8-34): person-area-scaled line/circle
thickness, per-part colors, render threshold.  Rendering is visualization
tooling, not the hot path — it stays on host (the reference's CUDA renderer
exists for the same reason its GPU pipeline wants zero D2H; our device
pipeline outputs keypoints only, frames stay on host).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import cv2
import numpy as np

from openpose_tpu_torch.params import PoseModel, POSE_MODEL_INFO


def _keypoints_rectangle(kp: np.ndarray, threshold: float) -> Tuple[float, float, float, float]:
    valid = kp[:, 2] > threshold
    if not valid.any():
        return (0.0, 0.0, 0.0, 0.0)
    xs, ys = kp[valid, 0], kp[valid, 1]
    return (float(xs.min()), float(ys.min()),
            float(xs.max() - xs.min()), float(ys.max() - ys.min()))


def render_keypoints(frame: np.ndarray, keypoints: np.ndarray,
                     pairs: Sequence[int],
                     colors: Sequence[Tuple[int, int, int]],
                     thickness_circle_ratio: float,
                     thickness_line_ratio: float = 0.75,
                     threshold: float = 0.05,
                     alpha: float = 1.0) -> np.ndarray:
    """Draw keypoints in place on a BGR uint8/float frame; returns frame.

    colors are (R, G, B) per part; drawn as BGR like the reference tables.
    `alpha` blends the drawn skeleton with the underlying pixels (the
    reference's alphaKeypoint / --alpha_pose, default 0.6 in flags.hpp but
    1.0 here for opaque CPU-parity rendering unless requested).
    """
    if keypoints.size == 0:
        return frame
    if alpha < 1.0:
        base = frame.copy()
    height, width = frame.shape[:2]
    area = width * height
    n_colors = len(colors)
    for person in range(keypoints.shape[0]):
        kp = keypoints[person]
        rx, ry, rw, rh = _keypoints_rectangle(kp, 0.1)
        if rw * rh <= 0:
            continue
        ratio_areas = min(1.0, max(rw / width, rh / height))
        thickness_ratio = max(
            int(np.sqrt(area) * thickness_circle_ratio * ratio_areas + 0.5), 2)
        thickness_circle = max(1, thickness_ratio if ratio_areas > 0.05 else -1)
        thickness_line = max(1, int(thickness_ratio * thickness_line_ratio + 0.5))
        radius = thickness_ratio // 2

        for i in range(0, len(pairs), 2):
            a, b = pairs[i], pairs[i + 1]
            if kp[a, 2] > threshold and kp[b, 2] > threshold:
                r, g, bl = colors[b % n_colors]
                cv2.line(frame,
                         (int(kp[a, 0] + 0.5), int(kp[a, 1] + 0.5)),
                         (int(kp[b, 0] + 0.5), int(kp[b, 1] + 0.5)),
                         (bl, g, r), thickness_line, lineType=8)
        for part in range(kp.shape[0]):
            if kp[part, 2] > threshold:
                r, g, bl = colors[part % n_colors]
                cv2.circle(frame,
                           (int(kp[part, 0] + 0.5), int(kp[part, 1] + 0.5)),
                           radius, (bl, g, r), thickness_circle, lineType=8)
    if alpha < 1.0:
        # skeleton pixels = alpha*color + (1-alpha)*original; elsewhere the
        # two frames agree, so a whole-frame weighted sum is the identity.
        blended = cv2.addWeighted(frame, alpha, base, 1.0 - alpha, 0.0)
        np.copyto(frame, blended)
    return frame


def render_pose(frame: np.ndarray, pose_keypoints: np.ndarray,
                model: PoseModel, threshold: float = 0.05,
                blend_original: bool = True,
                alpha: float = 1.0) -> np.ndarray:
    """renderPoseKeypointsCpu (renderPose.cpp:8-34)."""
    if not blend_original:
        frame = np.zeros_like(frame)
    info = POSE_MODEL_INFO[model]
    return render_keypoints(frame, pose_keypoints, info.render_pairs,
                            info.colors, thickness_circle_ratio=1.0 / 75.0,
                            threshold=threshold, alpha=alpha)


def render_face(frame: np.ndarray, face_keypoints: np.ndarray,
                threshold: float = 0.4, alpha: float = 1.0) -> np.ndarray:
    """Face: white dots, pair chain along the 70-point contour ordering
    (reference FACE_PAIRS_RENDER in include/openpose/face/faceParameters.hpp)."""
    pairs = []
    # contour segments: jaw 0-16, brows 17-21 22-26, nose 27-30 31-35,
    # eyes 36-41 42-47 (closed), mouth 48-59 60-67 (closed)
    segments = [(0, 16, False), (17, 21, False), (22, 26, False),
                (27, 30, False), (31, 35, False), (36, 41, True),
                (42, 47, True), (48, 59, True), (60, 67, True)]
    for a, b, closed in segments:
        for i in range(a, b):
            pairs += [i, i + 1]
        if closed:
            pairs += [b, a]
    colors = [(255, 255, 255)] * 70
    return render_keypoints(frame, face_keypoints, pairs, colors,
                            thickness_circle_ratio=1.0 / 175.0,
                            threshold=threshold, alpha=alpha)


_HAND_PAIRS = []
for finger in range(5):
    base = 1 + finger * 4
    _HAND_PAIRS += [0, base]
    for i in range(3):
        _HAND_PAIRS += [base + i, base + i + 1]

# per-finger color ramp (reference HAND_COLORS_RENDER)
_HAND_COLORS = [(100, 100, 100)] + sum(
    [[c] * 4 for c in [(100, 0, 0), (150, 150, 0), (0, 150, 0),
                       (0, 150, 150), (0, 0, 150)]], [])


def render_hands(frame: np.ndarray, left: np.ndarray, right: np.ndarray,
                 threshold: float = 0.2, alpha: float = 1.0) -> np.ndarray:
    for kp in (left, right):
        if kp is not None and kp.size:
            render_keypoints(frame, kp, _HAND_PAIRS, _HAND_COLORS,
                             thickness_circle_ratio=1.0 / 150.0,
                             threshold=threshold, alpha=alpha)
    return frame
