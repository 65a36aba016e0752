"""Synthetic inputs with known people: numpy, and one renderer in torch.

* `make_targets`: a BODY-model net output that encodes given keypoints:
  Gaussian part maps, background, and unit-vector limb bands in the PAF
  channels.  The numpy twin of `openpose_tpu.train.make_targets`; fed to
  `PoseExtractor.forward(net_output=...)` it must assemble exactly the
  people placed.
* `random_people`: keypoints of standing people spread across a frame; with
  its template and `BODY25_DRAW_PAIRS` the port's own copy of what it needs
  of `openpose_tpu/scenes.py` (same numbers from the same seed).
* `coco_ground_truth`: the COCO annotations of such people (the port's copy
  of `openpose_tpu/scenes.py::coco_ground_truth`).
* `render_scene_image`: a BGR frame of stick figures (disks at the joints,
  lines along the limbs) for driving the CNN path; a numpy stand-in for
  `openpose_tpu.scenes.render_scene_image`, which needs OpenCV.  It is the
  port's training domain.
* `render_scene_batch`: the same frames for a whole batch as torch ops on
  a device (the trainer's scene iterator: the numpy renderer is a Python
  loop over 49 strokes a person and cannot feed a card).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["make_targets", "random_people", "coco_ground_truth",
           "render_scene_image", "render_scene_batch", "scene_background"]

# Standing-person template for the 25 BODY_25 parts, unit height, origin at
# the nose, x right / y down (part order: poseParameters.cpp:7-33).
BODY25_TEMPLATE = np.array([
    (0.000, 0.000),    # 0  Nose
    (0.000, 0.120),    # 1  Neck
    (-0.100, 0.120),   # 2  RShoulder
    (-0.140, 0.260),   # 3  RElbow
    (-0.160, 0.400),   # 4  RWrist
    (0.100, 0.120),    # 5  LShoulder
    (0.140, 0.260),    # 6  LElbow
    (0.160, 0.400),    # 7  LWrist
    (0.000, 0.450),    # 8  MidHip
    (-0.060, 0.450),   # 9  RHip
    (-0.070, 0.650),   # 10 RKnee
    (-0.080, 0.850),   # 11 RAnkle
    (0.060, 0.450),    # 12 LHip
    (0.070, 0.650),    # 13 LKnee
    (0.080, 0.850),    # 14 LAnkle
    (-0.025, -0.030),  # 15 REye
    (0.025, -0.030),   # 16 LEye
    (-0.055, -0.010),  # 17 REar
    (0.055, -0.010),   # 18 LEar
    (0.100, 0.920),    # 19 LBigToe
    (0.120, 0.910),    # 20 LSmallToe
    (0.070, 0.880),    # 21 LHeel
    (-0.100, 0.920),   # 22 RBigToe
    (-0.120, 0.910),   # 23 RSmallToe
    (-0.070, 0.880),   # 24 RHeel
], np.float32)

# limbs drawn between BODY_25 parts
BODY25_DRAW_PAIRS = [
    (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9),
    (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (1, 0), (0, 15),
    (15, 17), (0, 16), (16, 18), (14, 19), (19, 20), (14, 21), (11, 22),
    (22, 23), (11, 24)]


# BODY_25 -> 17-keypoint COCO order (cocoJsonSaver.cpp:117-141 and
# io/json_io._COCO_ORDER_BY_PARTS[25])
COCO_ORDER_25 = [0, 16, 15, 18, 17, 5, 2, 6, 3, 7, 4, 12, 9, 13, 10, 14, 11]


def random_people(rng: np.random.RandomState, n_people: int,
                  frame_hw: Tuple[int, int],
                  height_range: Tuple[float, float] = (180.0, 300.0),
                  jitter: float = 2.0,
                  min_spacing: float = 90.0) -> np.ndarray:
    """[n_people, 25, 3] keypoints for one frame; all keypoints visible.

    People are horizontally spread (centers at least `min_spacing` px apart)
    so distinct people produce distinct heatmap blobs, with per-keypoint
    jitter so poses are not identical."""
    h, w = frame_hw
    people = np.zeros((n_people, 25, 3), np.float32)
    # candidate x-centers, spaced then shuffled
    margin = 60.0
    slots = np.linspace(margin, w - margin,
                        max(n_people, int((w - 2 * margin) // min_spacing)))
    rng.shuffle(slots)
    for p in range(n_people):
        height = rng.uniform(*height_range)
        height = min(height, (h - 20.0) / 0.95)  # template spans -0.03..0.92
        cx = slots[p % len(slots)] + rng.uniform(-15, 15)
        top = rng.uniform(8.0, max(9.0, h - height * 0.95 - 8.0))
        pts = BODY25_TEMPLATE.copy()
        if rng.rand() < 0.5:
            pts[:, 0] = -pts[:, 0]          # mirrored person
        kp = pts * height
        kp[:, 0] += cx
        kp[:, 1] += top + height * 0.03     # nose sits 3% below the top
        kp += rng.uniform(-jitter, jitter, kp.shape)
        kp[:, 0] = np.clip(kp[:, 0], 2.0, w - 3.0)
        kp[:, 1] = np.clip(kp[:, 1], 2.0, h - 3.0)
        people[p, :, :2] = kp
        people[p, :, 2] = 1.0
    return people


def coco_ground_truth(people: np.ndarray, image_id: int) -> List[Dict]:
    """COCO annotation dicts (17-kp order, visibility 2, bbox area) for the
    [n, 25, 3] keypoints of one frame."""
    out = []
    for person in people:
        pts = person[COCO_ORDER_25]
        xs, ys = pts[:, 0], pts[:, 1]
        x0, y0 = float(xs.min()), float(ys.min())
        bw, bh = float(xs.max() - x0), float(ys.max() - y0)
        kp = []
        for x, y in zip(xs, ys):
            kp += [float(x), float(y), 2]
        out.append({"image_id": int(image_id), "keypoints": kp,
                    "num_keypoints": 17, "area": bw * bh,
                    "bbox": [x0, y0, bw, bh]})
    return out


def make_targets(keypoints: np.ndarray, pairs: np.ndarray,
                 map_idx: np.ndarray, hw: Tuple[int, int], num_parts: int,
                 num_channels: int, stride: int = 8, sigma: float = 7.0,
                 paf_width: float = 1.0) -> np.ndarray:
    """keypoints [B, people, parts, 3] in input pixels (score > 0 = valid)
    -> [B, H/stride, W/stride, C] float32: parts, background, PAFs."""
    kp = np.asarray(keypoints, np.float32)
    h, w = hw[0] // stride, hw[1] // stride
    grid_y = ((np.arange(h, dtype=np.float32) + 0.5) * stride - 0.5)[:, None]
    grid_x = ((np.arange(w, dtype=np.float32) + 0.5) * stride - 0.5)[None, :]
    kx, ky, kv = kp[..., 0], kp[..., 1], kp[..., 2] > 0   # [B, P, parts]

    # part maps: max over people of exp(-d^2 / 2 sigma^2)
    d2 = ((grid_x - kx[..., None, None]) ** 2
          + (grid_y - ky[..., None, None]) ** 2)
    g = np.where(kv[..., None, None], np.exp(-d2 / (2.0 * sigma * sigma)), 0.0)
    conf = g.max(axis=1).transpose(0, 2, 3, 1)            # [B, h, w, parts]
    bkg = np.clip(1.0 - conf.max(axis=-1, keepdims=True), 0.0, 1.0)

    # PAFs: the unit limb vector within paf_width * stride of the segment,
    # extended by one cell past both joints, averaged over covering people
    pa, pb = pairs[:, 0], pairs[:, 1]
    ax, ay, bx, by = kx[:, :, pa], ky[:, :, pa], kx[:, :, pb], ky[:, :, pb]
    pv = kv[:, :, pa] & kv[:, :, pb]
    vx, vy = bx - ax, by - ay
    norm = np.sqrt(vx * vx + vy * vy)
    nz = norm > 1e-3
    ux = np.where(nz, vx / np.maximum(norm, 1e-3), 0.0)[..., None, None]
    uy = np.where(nz, vy / np.maximum(norm, 1e-3), 0.0)[..., None, None]
    px = grid_x - ax[..., None, None]
    py = grid_y - ay[..., None, None]
    along = px * ux + py * uy
    perp = np.abs(px * uy - py * ux)
    margin = paf_width * stride
    on_limb = ((along >= -margin) & (along <= norm[..., None, None] + margin)
               & (perp <= paf_width * stride)
               & (pv & nz)[..., None, None])
    denom = np.maximum(on_limb.sum(axis=1), 1).astype(np.float32)
    paf_x = np.where(on_limb, ux, 0.0).sum(axis=1) / denom  # [B, pairs, h, w]
    paf_y = np.where(on_limb, uy, 0.0).sum(axis=1) / denom

    off = num_parts + 1
    paf = np.zeros((kp.shape[0], num_channels - off, h, w), np.float32)
    paf[:, map_idx[:, 0] - off] = paf_x
    paf[:, map_idx[:, 1] - off] = paf_y
    return np.concatenate([conf, bkg, paf.transpose(0, 2, 3, 1)],
                          axis=-1).astype(np.float32)


def _hue_bgr(idx: int, total: int, s: float = 1.0, v: float = 1.0):
    """BGR colour of hue idx/total on the HSV wheel."""
    hh = 6.0 * idx / total
    c = v * s
    x = c * (1 - abs(hh % 2 - 1))
    r, g, b = [(c, x, 0), (x, c, 0), (0, c, x), (0, x, c), (x, 0, c),
               (c, 0, x)][int(hh) % 6]
    m = v - c
    return np.array([b + m, g + m, r + m]) * 255.0


def _stroke(img: np.ndarray, p0: np.ndarray, p1: np.ndarray, radius: float,
            color: np.ndarray) -> None:
    """Paint the pixels within `radius` of segment p0-p1 (a disk if p0 == p1)."""
    h, w = img.shape[:2]
    lo = np.floor(np.minimum(p0, p1) - radius).astype(int)
    hi = np.ceil(np.maximum(p0, p1) + radius).astype(int) + 1
    x_lo, y_lo = max(lo[0], 0), max(lo[1], 0)
    x_hi, y_hi = min(hi[0], w), min(hi[1], h)
    if x_lo >= x_hi or y_lo >= y_hi:
        return
    ys, xs = np.mgrid[y_lo:y_hi, x_lo:x_hi].astype(np.float32)
    d = p1 - p0
    t = np.clip(((xs - p0[0]) * d[0] + (ys - p0[1]) * d[1])
                / max(float(d @ d), 1e-6), 0.0, 1.0)
    dist2 = (xs - p0[0] - t * d[0]) ** 2 + (ys - p0[1] - t * d[1]) ** 2
    img[y_lo:y_hi, x_lo:x_hi][dist2 <= radius * radius] = color


LIMB_RADIUS, JOINT_RADIUS = 1.0, 4.0


def scene_background(frame_hw: Tuple[int, int],
                     rng: Optional[np.random.RandomState] = None,
                     background_noise: float = 8.0) -> np.ndarray:
    """[H, W, 3] float32 background of a scene: dim noise around 24 drawn
    from `rng` (one `normal` call of H x W x 3), black without one."""
    h, w = frame_hw
    img = np.zeros((h, w, 3), np.float32)
    if rng is not None and background_noise > 0:
        img[:] = np.clip(rng.normal(24, background_noise, (h, w, 3)), 0, 64)
    return img


def render_scene_image(people: np.ndarray, frame_hw: Tuple[int, int],
                       rng: Optional[np.random.RandomState] = None,
                       background_noise: float = 8.0) -> np.ndarray:
    """[H, W, 3] uint8 BGR image of [people, 25, 3] skeletons: limbs as
    2 px lines coloured by pair, joints as radius-4 disks coloured by part."""
    img = scene_background(frame_hw, rng, background_noise)
    n_parts = people.shape[1] if people.size else 25
    for person in people:
        pts = person[:, :2].astype(np.float32)
        for li, (a, b) in enumerate(BODY25_DRAW_PAIRS):
            if a < n_parts and b < n_parts and min(person[a, 2],
                                                    person[b, 2]) > 0:
                _stroke(img, pts[a], pts[b], LIMB_RADIUS,
                        _hue_bgr(li, len(BODY25_DRAW_PAIRS), 0.55, 0.67))
        for part in range(n_parts):
            if person[part, 2] > 0:
                _stroke(img, pts[part], pts[part], JOINT_RADIUS,
                        _hue_bgr(part, n_parts))
    return np.clip(img, 0, 255).astype(np.uint8)


def _stroke_table(n_parts: int):
    """The strokes of one person in painting order (limbs in
    `BODY25_DRAW_PAIRS` order, then joints): end parts a and b [S], radius
    [S] and uint8 BGR colour [S, 3], as numpy arrays."""
    limbs = [(li, a, b) for li, (a, b) in enumerate(BODY25_DRAW_PAIRS)
             if a < n_parts and b < n_parts]
    a = [a for _, a, _ in limbs] + list(range(n_parts))
    b = [b for _, _, b in limbs] + list(range(n_parts))
    radius = [LIMB_RADIUS] * len(limbs) + [JOINT_RADIUS] * n_parts
    colors = [_hue_bgr(li, len(BODY25_DRAW_PAIRS), 0.55, 0.67)
              for li, _, _ in limbs] \
        + [_hue_bgr(part, n_parts) for part in range(n_parts)]
    # as the numpy renderer stores them: float32 in the canvas, cut to uint8
    colors = np.clip(np.asarray(colors).astype(np.float32), 0, 255)
    return (np.asarray(a), np.asarray(b), np.asarray(radius, np.float32),
            colors.astype(np.uint8))


def render_scene_batch(people: np.ndarray,
                       background: torch.Tensor) -> torch.Tensor:
    """`render_scene_image` for a batch, as torch ops on `background`'s
    device.  people [B, P, parts, 3] float32 on the host (score > 0 =
    drawn; an empty slot is all zeros); background [B, H, W, 3] uint8
    (`scene_background`, cut to uint8).  Returns [B, H, W, 3] uint8.

    For one person at a time, the squared distance of every pixel to all of
    that person's strokes at once; a pixel takes the colour of the last
    stroke that covers it, which is what painting the strokes in order
    leaves, and later people paint over earlier ones.  The arithmetic is
    the numpy renderer's in float32, so the two agree but for a pixel whose
    distance lies within rounding of a stroke's radius."""
    device = background.device
    b, h, w, _ = background.shape
    n_parts = people.shape[2]
    part_a, part_b, radius, colors = _stroke_table(n_parts)
    idx_a = torch.from_numpy(part_a).to(device)
    idx_b = torch.from_numpy(part_b).to(device)
    r2 = torch.from_numpy(radius * radius).to(device)[None, :, None, None]
    # colour 0 of the table is "no stroke"
    table = torch.cat([torch.zeros((1, 3), dtype=torch.uint8),
                       torch.from_numpy(colors)]).to(device)
    order = torch.arange(1, len(part_a) + 1, device=device,
                         dtype=torch.int16)[None, :, None, None]
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, None, :, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, None, :]
    people = np.asarray(people, np.float32)
    used = np.nonzero((people[..., 2] > 0).any(axis=(0, 2)))[0]
    slots = int(used.max()) + 1 if used.size else 0    # trailing empty slots
    people = torch.from_numpy(people[:, :slots]).to(device)
    img = background.clone()
    for p in range(slots):
        person = people[:, p]                               # [B, parts, 3]
        p0, p1 = person[:, idx_a], person[:, idx_b]         # [B, S, 3]
        drawn = (torch.minimum(p0[..., 2], p1[..., 2]) > 0)[..., None, None]
        x0, y0 = p0[..., 0, None, None], p0[..., 1, None, None]
        dx = p1[..., 0, None, None] - x0
        dy = p1[..., 1, None, None] - y0
        px, py = xs - x0, ys - y0
        t = torch.clamp((px * dx + py * dy)
                        / torch.clamp(dx * dx + dy * dy, min=1e-6), 0.0, 1.0)
        dist2 = (px - t * dx) ** 2 + (py - t * dy) ** 2     # [B, S, H, W]
        last = torch.where((dist2 <= r2) & drawn, order,
                           torch.zeros_like(order)).amax(dim=1)   # [B, H, W]
        img = torch.where((last > 0)[..., None], table[last.long()], img)
    return img
