"""Plain body decode: net outputs -> people, per frame.

Frozen copies of the port's plain arithmetic (the program's
`ops/resize.py`, `ops/nms.py` and the plain version of the fused PAF
kernel in `ops/paf.py`), which follow the OpenPose reference: Catmull-Rom
8x upsample of the part maps (two float32 matmuls), 3x3 NMS with the
reference's border rules and 7x7 sub-pixel refinement, PAF line integrals
sampled from the low-resolution maps through the same Catmull-Rom taps,
then `assembly.connect_body_parts` on the host.

`tf32=True` is the control: the upsample's matmul operands rounded to TF32
(10 mantissa bits, to nearest even) and summed in float32, the precision
below the float32 (TF32 off) that the configuration states for this path.
The rounding is explicit: whether cuBLAS would take TF32 for a product
depends on its shape (at batch 1 it did not).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import assembly

MAX_LINE_SAMPLES = 25


# --- resize (ops/resize.py) -------------------------------------------------

def _cubic_weights(d: np.ndarray) -> np.ndarray:
    """Catmull-Rom (a = -0.5) weights of the 4 taps at offset d:
    (N,) -> (N, 4)."""
    d = d.astype(np.float64)
    d2, d3 = d * d, d * d * d
    return np.stack([-0.5 * d3 + d2 - 0.5 * d, 1.5 * d3 - 2.5 * d2 + 1.0,
                     -1.5 * d3 + 2.0 * d2 + 0.5 * d, 0.5 * d3 - 0.5 * d2],
                    axis=1)


@functools.lru_cache(maxsize=None)
def _cubic_matrix(out_size: int, in_size: int, scale: float) -> np.ndarray:
    """(out, in) half-pixel Catmull-Rom matrix, taps clamped to the map."""
    x = np.arange(out_size, dtype=np.float64)
    src = (x + 0.5) / scale - 0.5
    t1 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    t0 = np.maximum(0, t1 - 1)
    t2 = np.minimum(in_size - 1, t1 + 1)
    t3 = np.minimum(in_size - 1, t2 + 1)
    w = _cubic_weights(src - t1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i, taps in enumerate((t0, t1, t2, t3)):
        np.add.at(mat, (x.astype(np.int64), taps), w[:, i])
    return mat.astype(np.float32)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    keep = ((bits >> 13) & 1) + 0xFFF
    return ((bits + keep) & ~0x1FFF).view(torch.float32)


def upsample(maps: torch.Tensor, target_hw: Tuple[int, int],
             tf32: bool = False) -> torch.Tensor:
    """[B, h, w, C] -> [B, H, W, C]: out = M_h @ maps @ M_w^T, in float32
    (each operand rounded to TF32 first with tf32)."""
    th, tw = target_hw
    b, h, w, c = maps.shape
    mh = torch.from_numpy(_cubic_matrix(th, h, th / h)).to(maps.device)
    mw = torch.from_numpy(_cubic_matrix(tw, w, tw / w)).to(maps.device)
    r = to_tf32 if tf32 else (lambda t: t)
    rows = torch.matmul(r(mh), r(maps.reshape(b, h, w * c)))
    out = torch.matmul(r(mw), r(rows.reshape(b * th, w, c)))
    return out.reshape(b, th, tw, c)


# --- NMS (ops/nms.py) -------------------------------------------------------

def nms(heatmaps: torch.Tensor, threshold: float, max_peaks: int,
        offset: float) -> torch.Tensor:
    """[N, H, W, C] -> [N, C, max_peaks+1, 3]: count in [.., 0, 0], then
    (x, y, score) of each peak in row-major order."""
    heat = heatmaps.permute(0, 3, 1, 2)
    n, c, h, w = heat.shape
    padded = F.pad(heat, (1, 1, 1, 1), value=float(threshold))
    gt_all = torch.ones_like(heat, dtype=torch.bool)
    ge_all = torch.ones_like(heat, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nb = padded[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                gt_all &= heat > nb
                ge_all &= heat >= nb
    ys = torch.arange(h, device=heat.device)[:, None]
    xs = torch.arange(w, device=heat.device)[None, :]
    interior = (xs > 1) & (xs < w - 2) & (ys > 1) & (ys < h - 2)
    inner = (xs == 1) | (xs == w - 2) | (ys == 1) | (ys == h - 2)
    is_peak = (heat > threshold) & ((interior & gt_all) | (inner & ge_all))
    out = torch.zeros((n, c, max_peaks + 1, 3), dtype=torch.float32,
                      device=heat.device)
    hpos = F.pad(torch.clamp(heat, min=0.0), (3, 3, 3, 3))
    d = torch.arange(-3, 4, device=heat.device, dtype=torch.float32)
    for i in range(n):
        for ch in range(c):
            py, px = torch.nonzero(is_peak[i, ch], as_tuple=True)
            k = min(int(py.numel()), max_peaks)
            out[i, ch, 0, 0] = float(k)
            if k == 0:
                continue
            py, px = py[:k], px[:k]
            # 7x7 window of max(heat, 0), zero outside the map
            win = torch.stack([hpos[i, ch, y:y + 7, x:x + 7]
                               for y, x in zip(py.tolist(), px.tolist())])
            s = win.sum(dim=(1, 2))
            sx = (win * (px[:, None, None] + d[None, None, :])).sum(dim=(1, 2))
            sy = (win * (py[:, None, None] + d[None, :, None])).sum(dim=(1, 2))
            denom = torch.where(s > 0, s, torch.ones_like(s))
            out[i, ch, 1:k + 1, 0] = sx / denom + offset
            out[i, ch, 1:k + 1, 1] = sy / denom + offset
            out[i, ch, 1:k + 1, 2] = heat[i, ch, py, px]
    return out


# --- PAF scoring (the plain version of the fused kernel, ops/paf.py) -------

def _line_geometry(peaks, pairs, hw) -> Dict[str, torch.Tensor]:
    h, w = hw
    counts = peaks[:, :, 0, 0]
    coords = peaks[:, :, 1:, :]
    k = coords.shape[2]
    a_part, b_part = pairs[:, 0].long(), pairs[:, 1].long()
    ca, cb = coords[:, a_part], coords[:, b_part]
    ax, ay = ca[..., 0][..., :, None], ca[..., 1][..., :, None]
    bx, by = cb[..., 0][..., None, :], cb[..., 1][..., None, :]
    vx, vy = bx - ax, by - ay
    linf = torch.maximum(vx.abs(), vy.abs())
    n_samples = torch.clamp(torch.floor(torch.sqrt(5.0 * linf) + 0.5), 5, 25)
    norm = torch.sqrt(vx * vx + vy * vy)
    safe_norm = torch.where(norm > 1e-6, norm, 1.0)
    lm = torch.arange(MAX_LINE_SAMPLES, dtype=torch.float32,
                      device=peaks.device)
    stepx, stepy = (vx / n_samples)[..., None], (vy / n_samples)[..., None]
    mx = torch.clamp(torch.floor(ax[..., None] + lm * stepx + 0.5), 0, w - 1)
    my = torch.clamp(torch.floor(ay[..., None] + lm * stepy + 0.5), 0, h - 1)
    ki = torch.arange(k, dtype=torch.float32, device=peaks.device)
    valid = ((ki[:, None] < counts[:, a_part][..., None, None])
             & (ki[None, :] < counts[:, b_part][..., None, None]))
    return dict(mx=mx, my=my, ux=vx / safe_norm, uy=vy / safe_norm,
                n_samples=n_samples, norm=norm, valid=valid)


def _taps(coord: torch.Tensor, in_size: int, scale: float):
    src = coord / torch.tensor(np.float32(scale), device=coord.device) \
        + float(np.float32(0.5 / scale - 0.5))
    t1 = torch.clamp(torch.floor(src), 0, in_size - 1)
    d = src - t1
    d2 = d * d
    d3 = d2 * d
    weights = (-0.5 * d3 + d2 - 0.5 * d, 1.5 * d3 - 2.5 * d2 + 1.0,
               -1.5 * d3 + 2.0 * d2 + 0.5 * d, 0.5 * d3 - 0.5 * d2)
    t1i = t1.long()
    t2i = torch.clamp(t1i + 1, max=in_size - 1)
    return (torch.clamp(t1i - 1, min=0), t1i, t2i,
            torch.clamp(t2i + 1, max=in_size - 1)), weights


def _tap_sum(low, taps_y, wy, taps_x, wx, ws):
    n, p = low.shape[:2]
    out = None
    for r in range(4):
        acc = None
        for c in range(4):
            idx = taps_y[r] * ws + taps_x[c]
            val = torch.gather(low, 2, idx.reshape(n, p, -1)) \
                .reshape(idx.shape)
            term = wx[c] * val
            acc = term if acc is None else acc + term
        out = wy[r] * acc if out is None else out + wy[r] * acc
    return out


def paf_scores(maps: torch.Tensor, target_hw, peaks, pairs, map_idx,
               inter_threshold: float, inter_min_above: float,
               nms_threshold: float) -> torch.Tensor:
    """[N, P, k, k] pair scores over the leading k = max-count peak slots
    (the rest score -1 by construction)."""
    th, tw = target_hw
    k = max(1, int(peaks[:, :, 0, 0].max()))
    geo = _line_geometry(peaks[:, :, :k + 1], pairs, target_hw)
    n, p = geo["mx"].shape[:2]
    hs, ws = maps.shape[1], maps.shape[2]
    chans = maps.permute(0, 3, 1, 2)
    ty, wy = _taps(geo["my"], hs, th / hs)
    tx, wx = _taps(geo["mx"], ws, tw / ws)
    vals = [_tap_sum(chans[:, map_idx[:, col].long()].reshape(n, p, hs * ws),
                     ty, wy, tx, wx, ws) for col in (0, 1)]
    proj = (geo["ux"][..., None] * vals[0] + geo["uy"][..., None] * vals[1])
    cnt = torch.zeros_like(geo["norm"])
    ssum = torch.zeros_like(geo["norm"])
    for line in range(MAX_LINE_SAMPLES):
        above = (proj[..., line] > inter_threshold) \
            & (line < geo["n_samples"])
        cnt = cnt + above.to(torch.float32)
        ssum = ssum + torch.where(above, proj[..., line], 0.0)
    accepted = cnt / geo["n_samples"] > inter_min_above
    score = torch.where(accepted, ssum / torch.clamp(cnt, min=1.0), -1.0)
    fallback = ~accepted & (geo["norm"] < float(np.sqrt(float(tw * th))
                                               / 150.0))
    score = torch.where(fallback, nms_threshold + 1e-6, score)
    score = torch.where(geo["norm"] > 1e-6, score, -1.0)
    return torch.where(geo["valid"], score, -1.0)


# --- the whole decode --------------------------------------------------------

def decode(maps: torch.Tensor, cfg: dict, tf32: bool = False
           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """maps [B, h, w, C] float32 net outputs -> per frame (keypoints
    [people, parts, 3] in net-input pixels, person scores [people])."""
    parts = cfg["num_parts"]
    net_hw = tuple(cfg["net_hw"])
    pairs = torch.tensor(cfg["pairs"], dtype=torch.int32,
                         device=maps.device).reshape(-1, 2)
    map_idx = torch.tensor(cfg["map_idx"], dtype=torch.int32,
                           device=maps.device).reshape(-1, 2) + parts + 1
    th = cfg["thresholds"]
    maps = maps.to(torch.float32)
    with _no_tf32():
        merged = upsample(maps[..., :parts], net_hw, tf32)
    peaks = nms(merged, th["nms"], cfg["max_peaks"], 0.5)
    scores = paf_scores(maps, net_hw, peaks, pairs, map_idx, th["inter"],
                        th["inter_min_above"], th["nms"])
    peaks_np, scores_np = peaks.cpu().numpy(), scores.cpu().numpy()
    pairs_np = np.asarray(cfg["pairs"], np.int32).reshape(-1, 2)
    return [assembly.connect_body_parts(
        scores_np[i], peaks_np[i], pairs_np, parts, th["min_subset_cnt"],
        th["min_subset_score"], 1.0) for i in range(maps.shape[0])]


class _no_tf32:
    """Full float32 matmuls inside the block."""

    def __enter__(self):
        self.before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.before
