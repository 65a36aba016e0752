"""Heatmap / PAF visualization overlays (--part_to_show modes).

Mirrors the reference GPU heatmap rendering modes
(src/openpose/pose/renderPose.cu:121-609, keyboard-cycled via
`--part_to_show` and the GUI): blend a chosen channel — one part's
confidence map, the background channel, all parts combined, or a PAF
channel pair as hue-coded vectors — over the input frame.

Counterpart of `openpose_tpu/render/heatmaps.py`, the same code with OpenCV
imported inside the functions that call it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from openpose_tpu_torch.params import PoseModel, POSE_MODEL_INFO


def _colorize(channel: np.ndarray) -> np.ndarray:
    """Map [-1, 1] float map to BGR jet colors (uint8)."""
    import cv2
    norm = np.clip((channel + 1.0) * 0.5, 0.0, 1.0)
    return cv2.applyColorMap((norm * 255).astype(np.uint8),
                             cv2.COLORMAP_JET)


def overlay_heatmap(frame: np.ndarray, heatmaps: np.ndarray,
                    part: int = -1, alpha: float = 0.6) -> np.ndarray:
    """part >= 0: that part's channel; part == -1: max over all parts."""
    import cv2
    h, w = frame.shape[:2]
    channel = (heatmaps[..., part] if part >= 0
               else heatmaps.max(axis=-1))
    channel = cv2.resize(channel.astype(np.float32), (w, h),
                         interpolation=cv2.INTER_CUBIC)
    color = _colorize(channel)
    weight = np.clip(np.abs(channel), 0, 1)[..., None] * alpha
    return (frame * (1 - weight) + color * weight).astype(np.uint8)


def overlay_paf(frame: np.ndarray, heatmaps: np.ndarray,
                model: PoseModel, pair_index: int = -1,
                alpha: float = 0.6) -> np.ndarray:
    """Visualize PAF vectors: hue = direction, saturation = magnitude.

    pair_index == -1 renders the max-magnitude field over all pairs."""
    import cv2
    info = POSE_MODEL_INFO[model]
    off = info.paf_channel_offset
    h, w = frame.shape[:2]
    if pair_index >= 0:
        xi = off + info.map_idx[2 * pair_index]
        yi = off + info.map_idx[2 * pair_index + 1]
        px = heatmaps[..., xi]
        py = heatmaps[..., yi]
    else:
        xs = [off + info.map_idx[2 * k] for k in range(info.num_pairs)]
        ys = [off + info.map_idx[2 * k + 1] for k in range(info.num_pairs)]
        mags = [heatmaps[..., a] ** 2 + heatmaps[..., b] ** 2
                for a, b in zip(xs, ys)]
        best = np.argmax(np.stack(mags), axis=0)
        px = np.take_along_axis(
            np.stack([heatmaps[..., a] for a in xs]), best[None], 0)[0]
        py = np.take_along_axis(
            np.stack([heatmaps[..., b] for b in ys]), best[None], 0)[0]
    px = cv2.resize(px.astype(np.float32), (w, h))
    py = cv2.resize(py.astype(np.float32), (w, h))
    mag = np.sqrt(px * px + py * py)
    hue = ((np.arctan2(py, px) + np.pi) / (2 * np.pi) * 179).astype(np.uint8)
    sat = np.clip(mag * 255 * 2, 0, 255).astype(np.uint8)
    hsv = np.dstack([hue, sat, np.full_like(hue, 255)])
    color = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    weight = np.clip(mag, 0, 1)[..., None] * alpha
    return (frame * (1 - weight) + color * weight).astype(np.uint8)


def add_info_overlay(frame: np.ndarray, fps: float = -1.0,
                     frame_id: int = -1, n_people: int = -1,
                     extra: Optional[str] = None) -> np.ndarray:
    """GuiInfoAdder equivalent (src/openpose/gui/guiInfoAdder.cpp): burn
    FPS / frame number / people count into the frame corners."""
    import cv2
    h, w = frame.shape[:2]
    scale = max(0.4, w / 1280.0)
    color = (255, 255, 255)
    if fps >= 0:
        cv2.putText(frame, f"{fps:.1f} FPS", (int(w * 0.82), 20),
                    cv2.FONT_HERSHEY_SIMPLEX, scale, color, 1)
    if frame_id >= 0:
        cv2.putText(frame, f"Frame {frame_id}", (8, 20),
                    cv2.FONT_HERSHEY_SIMPLEX, scale, color, 1)
    if n_people >= 0:
        cv2.putText(frame, f"People: {n_people}", (8, h - 10),
                    cv2.FONT_HERSHEY_SIMPLEX, scale, color, 1)
    if extra:
        cv2.putText(frame, extra, (8, 40),
                    cv2.FONT_HERSHEY_SIMPLEX, scale, color, 1)
    return frame
