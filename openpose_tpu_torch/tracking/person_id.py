"""Frame-to-frame person ID assignment (temporal identification).

Counterpart of `openpose_tpu/tracking/person_id.py`.  Mirrors PersonIdExtractor (src/openpose/tracking/personIdExtractor.cpp):
keypoints of known people are propagated with pyramidal LK optical flow,
then greedily matched to current detections by keypoint inlier ratio
(matchLKAndOPGreedy, ibid:168-291); unmatched detections get fresh IDs.
The LK step runs on the device (`tracking/lk.py`, one call per frame for
all tracked people); matching is host-side NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.tracking import lk
from openpose_tpu_torch.tracking.tracker import gray_frame


@dataclasses.dataclass
class PersonEntry:
    keypoints: np.ndarray           # [parts, 2]
    status: np.ndarray              # [parts] bool: True = inactive/low conf
    counter_last_detection: int = 0


class PersonIdExtractor:
    def __init__(self, confidence_threshold: float = 0.1,
                 inlier_ratio_threshold: float = 0.5,
                 distance_threshold: float = 30.0,
                 frames_to_delete: int = 10,
                 device: Union[str, torch.device, None] = None):
        self.device = device_rule.resolve(device)
        self.confidence_threshold = confidence_threshold
        self.inlier_ratio_threshold = inlier_ratio_threshold
        self.distance_threshold = distance_threshold
        self.frames_to_delete = frames_to_delete
        self.entries: Dict[int, PersonEntry] = {}
        self.next_id = 0
        self.prev_gray: Optional[torch.Tensor] = None

    def _capture(self, pose_keypoints: np.ndarray) -> List[PersonEntry]:
        out = []
        for p in range(pose_keypoints.shape[0]):
            kp = pose_keypoints[p]
            out.append(PersonEntry(
                keypoints=kp[:, :2].astype(np.float32).copy(),
                status=kp[:, 2] < self.confidence_threshold))
        return out

    def _update_lk(self, gray: torch.Tensor) -> None:
        """Propagate every tracked person's keypoints prev -> current frame."""
        if not self.entries or self.prev_gray is None:
            return
        ids = list(self.entries.keys())
        all_pts = np.concatenate(
            [self.entries[i].keypoints for i in ids], axis=0)
        new_pts, valid = lk.pyramidal_lk(self.prev_gray, gray, all_pts,
                                         device=self.device)
        new_pts = new_pts.cpu().numpy()
        valid = valid.cpu().numpy()
        n_parts = self.entries[ids[0]].keypoints.shape[0]
        stale = []
        for slot, pid in enumerate(ids):
            entry = self.entries[pid]
            sl = slice(slot * n_parts, (slot + 1) * n_parts)
            entry.keypoints = new_pts[sl]
            entry.status = entry.status | ~valid[sl]
            entry.counter_last_detection += 1
            if entry.counter_last_detection > self.frames_to_delete:
                stale.append(pid)
        for pid in stale:
            del self.entries[pid]

    def _match_greedy(self, detections: List[PersonEntry],
                      image_wh) -> np.ndarray:
        pose_ids = np.full(len(detections), -1, np.int64)
        used: set = set()
        thresh = max(10.0, self.distance_threshold
                     * np.sqrt(image_wh[0] * image_wh[1]) / 960.0)
        converged = False
        while detections and not converged:
            converged = True
            candidates = []   # (total_distance, det_idx, track_id)
            best_score = 0.0
            for i, det in enumerate(detections):
                if pose_ids[i] != -1:
                    continue
                for pid, el in self.entries.items():
                    if pid in used:
                        continue
                    both = ~el.status & ~det.status
                    active = int(both.sum())
                    if active == 0:
                        continue
                    d = np.linalg.norm(
                        el.keypoints[both] - det.keypoints[both], axis=1)
                    inliers = int((d < thresh).sum())
                    score = inliers / active
                    if score < self.inlier_ratio_threshold:
                        continue
                    if score > best_score:
                        best_score = score
                        candidates = [(float(d.sum()), i, pid)]
                    elif score == best_score:
                        candidates.append((float(d.sum()), i, pid))
            candidates.sort()
            for _dist, det_idx, pid in candidates:
                if pid in used or pose_ids[det_idx] != -1:
                    continue
                pose_ids[det_idx] = pid
                used.add(pid)
                converged = False
        for i, det in enumerate(detections):
            if pose_ids[i] == -1:
                pose_ids[i] = self.next_id
                self.next_id += 1
            self.entries[int(pose_ids[i])] = det
        return pose_ids

    def extract_ids(self, pose_keypoints: np.ndarray,
                    frame_bgr: np.ndarray) -> np.ndarray:
        """-> [people] person IDs; updates internal track state."""
        gray = gray_frame(frame_bgr, self.device)
        detections = self._capture(pose_keypoints)
        if self.prev_gray is None:
            ids = np.arange(len(detections), dtype=np.int64)
            self.next_id = len(detections)
            for i, det in enumerate(detections):
                self.entries[i] = det
        else:
            self._update_lk(gray)
            ids = self._match_greedy(
                detections, (frame_bgr.shape[1], frame_bgr.shape[0]))
        self.prev_gray = gray
        return ids
