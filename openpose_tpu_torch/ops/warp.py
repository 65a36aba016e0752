"""Batched affine crop: per-person square ROIs as net inputs.

Counterpart of `openpose_tpu/ops/warp.py` (which imports JAX, so the host
helpers are written again here).  Semantics per crop, cv::warpAffine with
WARP_INVERSE_MAP: dst(x, y) = src(sx * x + tx, sy * y + ty), bilinear taps,
black constant border; a mirrored (left-hand) crop has sx < 0 and
tx = rect.x + rect.w.

The transforms are axis-aligned, so the warp is separable: one [out_h, H]
row matrix and one [out_w, W] column matrix per crop, built on the device
and applied as two float32 matrix products, the JAX package's form.  On CUDA
the products refuse to run with TF32 matmuls switched on, as the heatmap
path does (`resize._require_full_f32`).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from openpose_tpu_torch.ops import resize


def _bilinear_weights(scale: torch.Tensor, trans: torch.Tensor,
                      out_size: int, in_size: int) -> torch.Tensor:
    """[...] per-crop (scale, trans) -> [..., out_size, in_size] bilinear
    matrices: row o holds 1 - d at floor(src) and d at floor(src) + 1 for
    src = scale * o + trans; taps outside [0, in) get no weight."""
    o = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    src = scale[..., None] * o + trans[..., None]            # [..., O]
    lo = torch.floor(src)
    d = (src - lo)[..., None]
    lo = lo[..., None]
    cols = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    return (torch.where(cols == lo, 1.0 - d, 0.0)
            + torch.where(cols == lo + 1.0, d, 0.0))


def crop_affine_batch(image: torch.Tensor, transforms: torch.Tensor,
                      out_size: Union[int, Tuple[int, int]] = 368
                      ) -> torch.Tensor:
    """image [H, W, C] (or a batch [B, H, W, C]); transforms [P, 4] (or
    [B, P, 4]) rows (sx, sy, tx, ty): src_x = sx * dst_x + tx, src_y =
    sy * dst_y + ty.  Returns [P, out_h, out_w, C] (or [B, P, ...])
    float32; samples outside the image are 0."""
    out_h, out_w = (out_size, out_size) if isinstance(out_size, int) \
        else out_size
    single = image.ndim == 3
    if single:
        image, transforms = image[None], transforms[None]
    b, h, w, c = image.shape
    p = transforms.shape[1]
    tr = transforms.to(torch.float32)
    wy = _bilinear_weights(tr[..., 1], tr[..., 3], out_h, h)   # [B, P, oh, H]
    wx = _bilinear_weights(tr[..., 0], tr[..., 2], out_w, w)   # [B, P, ow, W]
    img = image.to(torch.float32)
    resize._require_full_f32(img)
    # rows, then columns
    rows = torch.matmul(wy, img.reshape(b, 1, h, w * c))      # [B, P, oh, W*C]
    # one batched product per crop, [ow, W] x [W, oh * C]: a broadcast of
    # wx over the rows would materialise [BP, oh, ow, W] (39 GiB for 64
    # crops of a 720x1280 frame)
    cols = torch.bmm(wx.reshape(b * p, out_w, w),
                     rows.reshape(b * p, out_h, w, c).permute(0, 2, 1, 3)
                     .reshape(b * p, w, out_h * c))           # [BP, ow, oh*C]
    out = cols.reshape(b, p, out_w, out_h, c).permute(0, 1, 3, 2, 4)
    return out[0] if single else out


def rect_to_transform(rect_xywh: Sequence[float], net_side: int,
                      mirror: bool) -> Tuple[float, float, float, float]:
    """(x, y, w, h) square rect -> (sx, sy, tx, ty) row.  Mirrored crops use
    sx = -scale, tx = x + w (cropFrame, handExtractorCaffe.cpp:51-62)."""
    x, y, rw, rh = rect_xywh
    scale = max(rw, rh) / float(net_side)
    if mirror:
        return (-scale, scale, x + rw, y)
    return (scale, scale, x, y)


def map_forward(keypoints_xy: np.ndarray, transform) -> np.ndarray:
    """Inverse of `map_back`: [.., 2] image-space points -> crop space
    (dst = (src - t) / s per axis)."""
    sx, sy, tx, ty = transform
    kp = np.asarray(keypoints_xy)
    out = kp.astype(np.float32, copy=True)
    out[..., 0] = (kp[..., 0] - tx) / sx
    out[..., 1] = (kp[..., 1] - ty) / sy
    return out


def map_back(keypoints_xy: np.ndarray, transform) -> np.ndarray:
    """[.., 2] crop-space points -> image space through the same affine
    (connectKeypoints, handExtractorCaffe.cpp:76-95)."""
    sx, sy, tx, ty = transform
    kp = np.asarray(keypoints_xy)
    out = kp.astype(np.float32, copy=True)
    out[..., 0] = sx * kp[..., 0] + tx
    out[..., 1] = sy * kp[..., 1] + ty
    return out
