"""Temporal pose-graph smoothing over keyframe windows.

Counterpart of `openpose_tpu/tracking/pose_graph.py`: treat a window of T
keyframes as a pose graph, per-keypoint trajectories x_t tied to their
detections by confidence-weighted data terms and to each other by a
constant-velocity (acceleration-penalty) smoothness prior:

    min_x  sum_t  c_t ||x_t - z_t||^2  +  lam * sum_t ||x_{t-1} - 2 x_t + x_{t+1}||^2

Each keypoint is an independent T-variable banded linear system with two
right-hand sides (x and y); all (people x parts) systems are solved by one
batched dense `torch.linalg.solve` (T <= 128).  Low-confidence detections
(c=0) are inpainted by the prior: the LK-fill role of PersonTracker, but
globally optimal over the window instead of frame-chained.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule


@torch.inference_mode()
def smooth_trajectories(keypoints: torch.Tensor,
                        smoothness: float = 4.0) -> torch.Tensor:
    """keypoints [T, people, parts, 3] (x, y, score) float32 -> smoothed,
    same shape, on the same device.

    Scores act as data weights; output scores are the input scores.
    """
    t = keypoints.shape[0]
    z = keypoints[..., :2]                             # [T, P, K, 2]
    c = torch.clamp(keypoints[..., 2], min=0.0)        # [T, P, K]

    # Second-difference operator D [T-2, T]; prior = lam * D^T D
    eye = torch.eye(t, dtype=keypoints.dtype, device=keypoints.device)
    d = eye[:-2] - 2.0 * eye[1:-1] + eye[2:]
    prior = smoothness * (d.T @ d)                     # [T, T]

    flat_z = z.permute(1, 2, 0, 3).reshape(-1, t, 2)
    flat_c = c.permute(1, 2, 0).reshape(-1, t)
    a = prior + torch.diag_embed(flat_c) + 1e-6 * eye  # [P*K, T, T]
    smoothed = torch.linalg.solve(a, flat_c[..., None] * flat_z)
    out_xy = smoothed.reshape(z.shape[1], z.shape[2], t, 2) \
                     .permute(2, 0, 1, 3)
    return torch.cat([out_xy, keypoints[..., 2:]], dim=-1)


def smooth_window(window_keypoints: np.ndarray, smoothness: float = 4.0,
                  device: Union[str, torch.device, None] = None
                  ) -> np.ndarray:
    """NumPy wrapper: [T, people, parts, 3] -> smoothed (solved on
    `device`, the card when none is given)."""
    if window_keypoints.shape[0] < 3:
        return window_keypoints
    x = torch.as_tensor(np.asarray(window_keypoints, np.float32))
    return smooth_trajectories(x.to(device_rule.resolve(device)),
                               smoothness).cpu().numpy()


class KeyframeSmoother:
    """Streaming sliding-window smoother for the user path (--smooth_keyframes).

    Buffers per-frame detections, maintains person-slot correspondence
    across frames (greedy nearest-mean matching — the PersonIdExtractor
    role, self-contained here so the smoother works without
    --identification), and emits each frame once `window // 2` future
    frames have arrived, smoothed over the centered window.  Frames where a
    tracked person is missing get confidence-0 rows, which the
    acceleration prior INPAINTS — the reference PersonTracker's LK-fill
    role (src/openpose/tracking/personTracker.cpp:421-535), but globally
    optimal over the window instead of frame-chained.

    push() returns a list of (frame_index, smoothed_keypoints [people,
    parts, 3], scores) ready to emit, in order; flush() drains the tail.
    """

    def __init__(self, window: int = 9, smoothness: float = 4.0,
                 max_people: int = 20, match_radius: float = 100.0,
                 device: Union[str, torch.device, None] = None):
        if window < 3:
            raise ValueError("--smooth_keyframes window must be >= 3")
        self.device = device_rule.resolve(device)
        self.window = window
        self.lookahead = window // 2
        self.smoothness = smoothness
        self.max_people = max_people
        self.match_radius = match_radius
        self._frames: list = []          # [(index, slots [S, parts, 3], scores)]
        self._next_emit = 0
        self._slot_centers: np.ndarray = np.zeros((0, 2), np.float32)
        self._slot_scores: list = []
        self._num_parts: int = 0

    def _assign_slots(self, kp: np.ndarray, scores: np.ndarray) -> np.ndarray:
        """[people, parts, 3] -> [S, parts, 3] slot-aligned (S grows)."""
        n_slots = self._slot_centers.shape[0]
        people = kp.shape[0]
        centers = np.zeros((people, 2), np.float32)
        for p in range(people):
            vis = kp[p, :, 2] > 0
            centers[p] = kp[p, vis, :2].mean(axis=0) if vis.any() else 1e9
        taken = np.zeros(n_slots, bool)
        assign = np.full(people, -1)
        if n_slots:
            d = np.linalg.norm(centers[:, None] - self._slot_centers[None],
                               axis=-1)                       # [people, S]
            for _ in range(min(people, n_slots)):
                p, s = np.unravel_index(np.argmin(d), d.shape)
                if d[p, s] > self.match_radius:
                    break
                assign[p] = s
                taken[s] = True
                d[p, :] = np.inf
                d[:, s] = np.inf
        for p in range(people):
            if assign[p] < 0 and n_slots + 1 <= self.max_people:
                self._slot_centers = np.concatenate(
                    [self._slot_centers, centers[p][None]], axis=0)
                self._slot_scores.append(0.0)
                assign[p] = n_slots
                n_slots += 1
        out = np.zeros((self._slot_centers.shape[0], self._num_parts, 3),
                       np.float32)
        out_scores = np.zeros(self._slot_centers.shape[0], np.float32)
        for p in range(people):
            if assign[p] >= 0:
                out[assign[p]] = kp[p]
                out_scores[assign[p]] = scores[p] if scores is not None \
                    and p < len(scores) else kp[p, :, 2].mean()
                self._slot_centers[assign[p]] = centers[p]
                self._slot_scores[assign[p]] = out_scores[assign[p]]
        return out, out_scores

    def push(self, index: int, keypoints: np.ndarray,
             scores: Optional[np.ndarray] = None) -> list:
        kp = np.asarray(keypoints, np.float32)
        if kp.ndim != 3 or kp.shape[0] == 0:
            kp = np.zeros((0, self._num_parts or 25, 3), np.float32)
        if self._num_parts == 0 and kp.shape[0]:
            self._num_parts = kp.shape[1]
        elif self._num_parts == 0:
            self._num_parts = kp.shape[1] if kp.ndim == 3 else 25
        slots, slot_scores = self._assign_slots(
            kp, None if scores is None else np.asarray(scores))
        self._frames.append((index, slots, slot_scores))
        return self._emit_ready(final=False)

    def flush(self) -> list:
        return self._emit_ready(final=True)

    def _emit_ready(self, final: bool) -> list:
        out = []
        while self._frames:
            emit_pos = self._next_emit - self._frames[0][0]
            if emit_pos >= len(self._frames):
                break
            newest = len(self._frames) - 1
            if not final and newest - emit_pos < self.lookahead:
                break
            lo = max(0, emit_pos - self.lookahead)
            hi = min(len(self._frames), emit_pos + self.lookahead + 1)
            n_slots = max(f[1].shape[0] for f in self._frames[lo:hi])
            stack = np.zeros((hi - lo, n_slots, self._num_parts or 25, 3),
                             np.float32)
            for i, (_, slots, _) in enumerate(self._frames[lo:hi]):
                stack[i, :slots.shape[0]] = slots
            smoothed = smooth_window(stack, self.smoothness, self.device)
            frame = smoothed[emit_pos - lo]
            _, raw_slots, slot_scores = self._frames[emit_pos]
            # emit only slots that ever appeared in this window
            seen = stack[..., 2].max(axis=0) > 0          # [S, parts] any
            active = seen.any(axis=-1)
            kp_out = frame[active]
            sc = np.zeros(int(active.sum()), np.float32)
            live = slot_scores[:raw_slots.shape[0]]
            idx = np.nonzero(active)[0]
            for j, s in enumerate(idx):
                sc[j] = live[s] if s < len(live) else 0.0
            out.append((self._next_emit, kp_out, sc))
            self._next_emit += 1
            # drop frames no longer needed for any future window
            while self._frames and \
                    self._frames[0][0] < self._next_emit - self.lookahead:
                self._frames.pop(0)
        return out
