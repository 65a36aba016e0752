"""Pyramidal Lucas-Kanade optical flow in PyTorch (all points at once).

Counterpart of `openpose_tpu/tracking/lk.py`, itself a replacement for the
reference's CPU/CUDA pyramidal LK (src/openpose/tracking/pyramidalLK.{cpp,cu}:
3-level pyramid, 21x21 patches, 2x2 normal-equation solve per keypoint):

* the pyramid is built with a separable 5-tap Gaussian (cv::pyrDown kernel);
* all keypoints are solved in parallel, as one [N, patch, patch] batch, with
  a fixed iteration count instead of per-point early exit (the same update
  rule);
* patches are gathered with bilinear interpolation like the reference's
  `getPatch` path.

Status semantics: a point is invalid if its patch leaves the frame at the
finest level, mirroring OUT_OF_FRAME in pyramidalLK.cpp:27-30.  Float32
throughout; plain torch ops, no hand-written kernel.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from openpose_tpu_torch import device as device_rule

_PYRDOWN_K = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)

ArrayLike = Union[np.ndarray, torch.Tensor]


def _pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: 5-tap Gaussian blur + 2x decimation (reflect border,
    the edge pixel not repeated)."""
    k = torch.tensor(_PYRDOWN_K, dtype=torch.float32, device=img.device)
    x = img[None, None]
    x = F.conv2d(F.pad(x, (0, 0, 2, 2), mode="reflect"), k.view(1, 1, 5, 1))
    x = F.conv2d(F.pad(x, (2, 2, 0, 0), mode="reflect"), k.view(1, 1, 1, 5))
    return x[0, 0, ::2, ::2]


def build_pyramid(image: torch.Tensor, levels: int = 3
                  ) -> Tuple[torch.Tensor, ...]:
    """Gray float image [H, W] -> tuple of `levels` images (finest first)."""
    pyr = [image]
    for _ in range(levels - 1):
        pyr.append(_pyr_down(pyr[-1]))
    return tuple(pyr)


def _bilinear_patch(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                    patch: int) -> torch.Tensor:
    """(patch x patch) windows centred at (cx, cy) [N] -> [N, patch, patch],
    bilinear, taps clamped to the image."""
    h, w = img.shape
    half = (patch - 1) / 2.0
    offs = torch.arange(patch, dtype=torch.float32, device=img.device) - half
    xs = cx[:, None, None] + offs[None, None, :]
    ys = cy[:, None, None] + offs[None, :, None]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    dx = xs - x0
    dy = ys - y0

    def tap(yy, xx):
        xi = torch.clamp(xx, 0, w - 1).long()
        yi = torch.clamp(yy, 0, h - 1).long()
        return img[yi, xi]

    return (tap(y0, x0) * (1 - dx) * (1 - dy) + tap(y0, x0 + 1) * dx * (1 - dy)
            + tap(y0 + 1, x0) * (1 - dx) * dy + tap(y0 + 1, x0 + 1) * dx * dy)


def _lk_level(prev_img, next_img, pts, guess, patch, iterations):
    """One pyramid level for all points: pts, guess [N, 2] -> (flow [N, 2],
    ok [N])."""
    px, py = pts[:, 0], pts[:, 1]
    template = _bilinear_patch(prev_img, px, py, patch)
    # central-difference gradients of the template window
    ix = (_bilinear_patch(prev_img, px + 1, py, patch)
          - _bilinear_patch(prev_img, px - 1, py, patch)) * 0.5
    iy = (_bilinear_patch(prev_img, px, py + 1, patch)
          - _bilinear_patch(prev_img, px, py - 1, patch)) * 0.5
    sxx = (ix * ix).sum(dim=(1, 2))
    syy = (iy * iy).sum(dim=(1, 2))
    sxy = (ix * iy).sum(dim=(1, 2))
    det = sxx * syy - sxy * sxy
    ok_grad = det > 1e-6
    inv = torch.where(ok_grad, 1.0 / torch.where(ok_grad, det, 1.0), 0.0)

    flow = guess
    for _ in range(iterations):
        cur = _bilinear_patch(next_img, px + flow[:, 0], py + flow[:, 1],
                              patch)
        it = cur - template
        bx = (ix * it).sum(dim=(1, 2))
        by = (iy * it).sum(dim=(1, 2))
        dx = -(syy * bx - sxy * by) * inv
        dy = -(sxx * by - sxy * bx) * inv
        flow = flow + torch.stack([dx, dy], dim=1)
    return flow, ok_grad


def _inside(pts, flow, shape, patch):
    """Finest-level bounds check (OUT_OF_FRAME, pyramidalLK.cpp:27-30);
    coarse levels rely on clamped sampling like cv::BORDER_REPLICATE."""
    h, w = shape
    half = (patch - 1) / 2.0
    px, py = pts[:, 0], pts[:, 1]
    end_x = px + flow[:, 0]
    end_y = py + flow[:, 1]
    return ((px - half >= 0) & (px + half < w)
            & (py - half >= 0) & (py + half < h)
            & (end_x >= 0) & (end_x < w) & (end_y >= 0) & (end_y < h))


@torch.inference_mode()
def pyramidal_lk(prev_gray: ArrayLike, next_gray: ArrayLike,
                 points: ArrayLike, levels: int = 3, patch: int = 21,
                 iterations: int = 5,
                 device: Union[str, torch.device, None] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track [N, 2] (x, y) points from prev to next frame (gray [H, W]).

    Returns (new_points [N, 2] float32, valid [N] bool) on `device` (the
    card when none is given).  Coarse-to-fine like pyramidalLKCpu
    (pyramidalLK.cpp:314-370).
    """
    device = device_rule.resolve(device)
    prev_gray, next_gray, pts = (
        torch.as_tensor(a).to(device, torch.float32)
        for a in (prev_gray, next_gray, points))
    prev_pyr = build_pyramid(prev_gray, levels)
    next_pyr = build_pyramid(next_gray, levels)
    flow = torch.zeros_like(pts)
    ok = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    for lvl in range(levels - 1, -1, -1):
        flow, ok_level = _lk_level(prev_pyr[lvl], next_pyr[lvl],
                                   pts * (1.0 / (1 << lvl)), flow, patch,
                                   iterations)
        ok = ok & ok_level
        if lvl > 0:
            flow = flow * 2.0
    ok = ok & _inside(pts, flow, prev_pyr[0].shape, patch)
    return pts + flow, ok
