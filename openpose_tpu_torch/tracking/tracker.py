"""Temporal person tracker: fill CNN-skipped frames with LK-propagated poses.

Counterpart of `openpose_tpu/tracking/tracker.py`.  Mirrors PersonTracker
(src/openpose/tracking/personTracker.cpp:386-535) + the stride logic of
PoseExtractor (src/openpose/pose/poseExtractor.cpp:37-54): with
``tracking = N``, the CNN runs on frames where ``frame_id % (N+1) == 0``; in
between, keypoints ride optical flow.  The gray frames stay on the device
between calls; keypoints are host arrays.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.tracking import lk


def gray_frame(frame_bgr: Union[np.ndarray, torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """[H, W, 3] BGR frame -> [H, W] float32 on the device: the plain mean
    of the three channels (not a weighted luma), as the trackers of the JAX
    package take it."""
    frame = torch.as_tensor(frame_bgr).to(device).to(torch.float32)
    return frame.sum(dim=-1) / 3.0


class PersonTracker:
    def __init__(self, confidence_threshold: float = 0.05,
                 merge_results: bool = True,
                 device: Union[str, torch.device, None] = None):
        self.device = device_rule.resolve(device)
        self.confidence_threshold = confidence_threshold
        self.merge_results = merge_results
        self.prev_gray: Optional[torch.Tensor] = None
        self.keypoints: Optional[np.ndarray] = None   # [P, parts, 3]

    def reset(self) -> None:
        self.prev_gray = None
        self.keypoints = None

    def observe(self, pose_keypoints: np.ndarray,
                frame_bgr: np.ndarray) -> None:
        """Record a CNN-detected frame as the new tracking base."""
        self.keypoints = np.asarray(pose_keypoints, np.float32).copy()
        self.prev_gray = gray_frame(frame_bgr, self.device)

    def track(self, frame_bgr: np.ndarray) -> np.ndarray:
        """Propagate the last observed keypoints to this frame via LK."""
        gray = gray_frame(frame_bgr, self.device)
        if self.keypoints is None or self.prev_gray is None \
                or self.keypoints.size == 0:
            self.prev_gray = gray
            return self.keypoints if self.keypoints is not None \
                else np.zeros((0, 0, 3), np.float32)
        p, parts, _ = self.keypoints.shape
        pts = self.keypoints[..., :2].reshape(-1, 2)
        new_pts, valid = lk.pyramidal_lk(self.prev_gray, gray, pts,
                                         device=self.device)
        new_pts = new_pts.cpu().numpy().reshape(p, parts, 2)
        valid = valid.cpu().numpy().reshape(p, parts)
        out = self.keypoints.copy()
        conf_ok = out[..., 2] > self.confidence_threshold
        move = conf_ok & valid
        out[..., 0] = np.where(move, new_pts[..., 0], out[..., 0])
        out[..., 1] = np.where(move, new_pts[..., 1], out[..., 1])
        out[..., 2] = np.where(conf_ok & ~valid, 0.0, out[..., 2])
        self.keypoints = out
        self.prev_gray = gray
        return out


class TrackingPoseExtractor:
    """PoseExtractor + tracking stride (poseExtractor.cpp:37-54)."""

    def __init__(self, pose_extractor, tracking: int = 0,
                 **forward_kwargs):
        self.pose_extractor = pose_extractor
        self.tracking = tracking
        self.forward_kwargs = forward_kwargs
        self.tracker = PersonTracker(device=pose_extractor.device)
        self.frame_id = 0

    def forward(self, frame_bgr: np.ndarray) -> np.ndarray:
        run_cnn = (self.tracking <= 0
                   or self.frame_id % (self.tracking + 1) == 0)
        if run_cnn:
            pred = self.pose_extractor.forward(frame_bgr,
                                               **self.forward_kwargs)
            keypoints = pred.keypoints
            self.tracker.observe(keypoints, frame_bgr)
        else:
            keypoints = self.tracker.track(frame_bgr)
        self.frame_id += 1
        return keypoints
