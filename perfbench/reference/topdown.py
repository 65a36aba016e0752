"""Plain whole-body tail: KeepTopN, face and hand rectangles, crops, the
face and hand nets, and their per-channel peaks.

Frozen copies of the port's plain host and tensor arithmetic
(`runtime/whole_body.py`, `face/detector.py`, `hand/detector.py`,
`ops/warp.py`, `ops/maximum.py`), which follow the OpenPose reference
(faceDetector.cpp, handDetector.cpp, the extractors' cropFrame,
keepTopNPeople.cpp).  BODY_25 part indices only.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import cnn, decode

Rect = Tuple[float, float, float, float]
_WIN = 9


def keep_top_n(kp: np.ndarray, scores: np.ndarray, cap: int):
    if kp.shape[0] > cap:
        order = np.argsort(scores)[::-1][:cap]
        return kp[order], scores[order]
    return kp, scores


def _dist(kp, a, b):
    return float(np.hypot(kp[a, 0] - kp[b, 0], kp[a, 1] - kp[b, 1]))


def face_rect(kp: np.ndarray, threshold: float = 0.25) -> Rect:
    """getFaceFromPoseKeypoints for BODY_25 (neck 1, nose 0, ears 18/17,
    eyes 16/15)."""
    neck, nose, lear, rear, leye, reye = 1, 0, 18, 17, 16, 15
    above = kp[:, 2] > threshold
    cx = cy = size = 0.0
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
        cx, cy, size = cx / counter, cy / counter, size / counter
    return (cx - size / 2.0, cy - size / 2.0, size, size)


def _hand_rect(kp, wrist, elbow, shoulder, threshold=0.03) -> Rect:
    if not (kp[wrist, 2] > threshold and kp[elbow, 2] > threshold
            and kp[shoulder, 2] > threshold):
        return (0.0, 0.0, 0.0, 0.0)
    cx = float(kp[wrist, 0] + 0.33 * (kp[wrist, 0] - kp[elbow, 0]))
    cy = float(kp[wrist, 1] + 0.33 * (kp[wrist, 1] - kp[elbow, 1]))
    d_we = _dist(kp, wrist, elbow)
    d_es = _dist(kp, elbow, shoulder)
    size = 1.5 * max(d_we, 0.9 * d_es)
    return (cx - size / 2.0, cy - size / 2.0, size, size)


def hand_crops(kp: np.ndarray) -> List[Tuple[Rect, bool]]:
    """(rect, mirrored) per hand: the left (mirrored), then the right, of
    each person (BODY_25: left wrist 7, elbow 6, shoulder 5; right 4, 3,
    2)."""
    out = []
    for p in range(kp.shape[0]):
        out += [(_hand_rect(kp[p], 7, 6, 5), True),
                (_hand_rect(kp[p], 4, 3, 2), False)]
    return out


def face_crops(kp: np.ndarray) -> List[Tuple[Rect, bool]]:
    return [(face_rect(kp[p]), False) for p in range(kp.shape[0])]


def rect_is_active(rect: Rect) -> bool:
    return min(rect[2], rect[3]) > 1 and rect[2] * rect[3] > 10


def rect_to_transform(rect: Rect, net_side: int, mirror: bool):
    x, y, rw, rh = rect
    scale = max(rw, rh) / float(net_side)
    return (-scale, scale, x + rw, y) if mirror else (scale, scale, x, y)


def _bilinear_weights(scale, trans, out_size, in_size):
    o = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    src = scale[..., None] * o + trans[..., None]
    lo = torch.floor(src)
    d = (src - lo)[..., None]
    lo = lo[..., None]
    cols = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    return (torch.where(cols == lo, 1.0 - d, 0.0)
            + torch.where(cols == lo + 1.0, d, 0.0))


def crop(frame: torch.Tensor, transforms: torch.Tensor, out: int
         ) -> torch.Tensor:
    """frame [H, W, 3]; transforms [P, 4] (sx, sy, tx, ty), src = s * dst
    + t per axis, bilinear, black border -> [P, out, out, 3] float32."""
    h, w, c = frame.shape
    wy = _bilinear_weights(transforms[:, 1], transforms[:, 3], out, h)
    wx = _bilinear_weights(transforms[:, 0], transforms[:, 2], out, w)
    img = frame.to(torch.float32)
    rows = torch.matmul(wy, img.reshape(1, h, w * c))         # [P, out, W*C]
    p = transforms.shape[0]
    cols = torch.bmm(wx, rows.reshape(p, out, w, c).permute(0, 2, 1, 3)
                     .reshape(p, w, out * c))                 # [P, out, out*C]
    return cols.reshape(p, out, out, c).permute(0, 2, 1, 3)


@functools.lru_cache(maxsize=None)
def _window_matrix(up: int) -> np.ndarray:
    up_lo, up_n = -(3 * up) // 2, 4 * up
    u = np.arange(up_n, dtype=np.float64)
    rel = (u + up_lo + 0.5) / up - 0.5 + (_WIN - 1) / 2
    t1 = np.floor(rel).astype(np.int64)
    w4 = decode._cubic_weights(rel - t1)
    mat = np.zeros((up_n, _WIN), dtype=np.float64)
    for i in range(4):
        np.add.at(mat, (np.arange(up_n), t1 - 1 + i), w4[:, i])
    return mat.astype(np.float32)


def argmax_refined(maps: torch.Tensor, up: int = 8) -> torch.Tensor:
    """[N, h, w, C] -> [N, C, 3] (x, y, score) in crop pixels: the coarse
    argmax, its 9x9 window Catmull-Rom-upsampled 8x, the window's argmax."""
    n, h, w, c = maps.shape
    chw = maps.permute(0, 3, 1, 2)
    idx = torch.argmax(chw.reshape(n, c, h * w), dim=-1)
    cx, cy = idx % w, torch.div(idx, w, rounding_mode="floor")
    offs = torch.arange(-(_WIN // 2), _WIN // 2 + 1, device=maps.device)
    ys = torch.clamp(cy[..., None] + offs, 0, h - 1)
    xs = torch.clamp(cx[..., None] + offs, 0, w - 1)
    rows = torch.gather(chw, 2, ys[..., None].expand(n, c, _WIN, w))
    patch = torch.gather(rows, 3, xs[:, :, None, :].expand(n, c, _WIN, _WIN))
    up_lo, up_n = -(3 * up) // 2, 4 * up
    wmat = torch.from_numpy(_window_matrix(up)).to(maps.device)
    grid = torch.matmul(torch.matmul(wmat, patch), wmat.T)
    flat = grid.reshape(n, c, up_n * up_n)
    uidx = torch.argmax(flat, dim=-1)
    score = torch.gather(flat, 2, uidx[..., None])[..., 0]
    x = torch.clamp(cx * up + up_lo + uidx % up_n, 0, w * up - 1)
    y = torch.clamp(cy * up + up_lo
                    + torch.div(uidx, up_n, rounding_mode="floor"),
                    0, h * up - 1)
    return torch.stack([x.float(), y.float(), score], dim=-1)


def upsampled_value(maps: torch.Tensor, xy: torch.Tensor, up: int = 8
                    ) -> torch.Tensor:
    """The 8x Catmull-Rom upsample of maps [N, h, w, C], taps clamped to
    the map, at crop pixels xy [N, C, 2] -> [N, C]: what `argmax_refined`'s
    window holds at that pixel."""
    n, h, w, c = maps.shape
    chw = maps.permute(0, 3, 1, 2).reshape(n, c, h * w)

    def taps(coord, size):
        src = (coord + 0.5) / up - 0.5
        t1 = torch.floor(src)
        d = (src - t1)
        d2, d3 = d * d, d * d * d
        wts = (-0.5 * d3 + d2 - 0.5 * d, 1.5 * d3 - 2.5 * d2 + 1,
               -1.5 * d3 + 2 * d2 + 0.5 * d, 0.5 * d3 - 0.5 * d2)
        t = [torch.clamp(t1 + i - 1, 0, size - 1).long() for i in range(4)]
        return t, wts

    ty, wy = taps(xy[..., 1], h)
    tx, wx = taps(xy[..., 0], w)
    out = torch.zeros((n, c), dtype=torch.float32, device=maps.device)
    for r in range(4):
        for col in range(4):
            idx = (ty[r] * w + tx[col])[..., None]
            val = torch.gather(chw, 2, idx)[..., 0]
            out = out + wy[r] * wx[col] * val
    return out


class Stage:
    """One top-down stage of the reference: a net spec, its weights, crop
    size and the crops' (rect, mirror) rule."""

    def __init__(self, spec_name: str, params, net_size: int, crops_of,
                 num_parts: int):
        self.spec = cnn.load_spec(spec_name)
        self.params = params
        self.net_size = net_size
        self.crops_of = crops_of
        self.num_parts = num_parts

    def run(self, frames: torch.Tensor, people: Sequence[np.ndarray],
            cap: int, precision: str = "float32"):
        """frames [B, H, W, 3]; people[i] the kept keypoints of frame i.
        -> per frame a list over crops of (transform or None, maps [h, w, C]
        or None, peaks [C, 3] in crop px or None)."""
        out = []
        for i, kp in enumerate(people):
            rows = []
            for rect, mirror in self.crops_of(kp)[:cap]:
                rows.append(rect_to_transform(rect, self.net_size, mirror)
                            if rect_is_active(rect) else None)
            active = [tr for tr in rows if tr is not None]
            maps = peaks = None
            if active:
                tr = torch.tensor(active, dtype=torch.float32,
                                  device=frames.device)
                crops = crop(frames[i], tr, self.net_size)
                maps = cnn.forward(self.spec, self.params, crops, precision,
                                   block=8)
                peaks = argmax_refined(maps)
            frame_out, j = [], 0
            for tr in rows:
                if tr is None:
                    frame_out.append((None, None, None))
                else:
                    frame_out.append((tr, maps[j], peaks[j]))
                    j += 1
            out.append(frame_out)
        return out
