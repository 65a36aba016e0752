"""Resize ops as products with small interpolation matrices.

Counterpart of `openpose_tpu/ops/resize.py`: the same numpy-built matrices
(Catmull-Rom or Keys cubic, bilinear with a black border), applied to NHWC
tensors with two float32 `torch.matmul` products, ``out = W_h @ img @ W_w^T``.

The heatmap path (`upsample_merge`, `resize_bicubic`) needs full float32
products: reduced precision flattens Gaussian peak tops and the strict `>`
NMS rule then drops those peaks (docs/performance.md, "Numerics on the
MXU").  On CUDA it refuses to run while TF32 matmuls are switched on.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def _cubic_weights(d: np.ndarray, a: float) -> np.ndarray:
    """Weights of the 4 cubic taps at fractional offset d in [~0,1).

    a=-0.5 is the reference's Catmull-Rom cubicInterpolate; a=-0.75 is
    OpenCV's INTER_CUBIC table.  Shape: d (N,) -> (N, 4)."""
    d = d.astype(np.float64)
    d2, d3 = d * d, d * d * d
    if a == -0.5:
        w0 = -0.5 * d3 + d2 - 0.5 * d
        w1 = 1.5 * d3 - 2.5 * d2 + 1.0
        w2 = -1.5 * d3 + 2.0 * d2 + 0.5 * d
        w3 = 0.5 * d3 - 0.5 * d2
    else:
        # Keys kernel at distances |d+1|, |d|, |1-d|, |2-d|
        def k(t):
            at = np.abs(t)
            return np.where(
                at <= 1, (a + 2) * at**3 - (a + 3) * at**2 + 1,
                np.where(at < 2, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a,
                         0.0))
        w0, w1, w2, w3 = k(d + 1), k(d), k(1 - d), k(2 - d)
    return np.stack([w0, w1, w2, w3], axis=1)


@functools.lru_cache(maxsize=None)
def _cubic_matrix(out_size: int, in_size: int, scale: float, a: float = -0.5,
                  half_pixel: bool = True) -> np.ndarray:
    """(out_size, in_size) matrix for 1-D cubic resampling: t1 =
    clamp(floor(src), 0, in-1), t0/t2/t3 clamped neighbours, dx = src - t1
    measured from the clamped t1 (the reference's border behaviour)."""
    x = np.arange(out_size, dtype=np.float64)
    src = (x + 0.5) / scale - 0.5 if half_pixel else x / scale
    t1 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    t0 = np.maximum(0, t1 - 1)
    t2 = np.minimum(in_size - 1, t1 + 1)
    t3 = np.minimum(in_size - 1, t2 + 1)
    w = _cubic_weights(src - t1, a)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i, taps in enumerate((t0, t1, t2, t3)):
        np.add.at(mat, (x.astype(np.int64), taps), w[:, i])
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(out_size: int, in_size: int, scale: float,
                     half_pixel: bool = False) -> np.ndarray:
    """(out_size, in_size) bilinear matrix; source coordinates outside
    [0, in) get zero weight (cv::warpAffine's black border)."""
    x = np.arange(out_size, dtype=np.float64)
    src = (x + 0.5) / scale - 0.5 if half_pixel else x / scale
    lo = np.floor(src).astype(np.int64)
    d = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for taps, w in ((lo, 1.0 - d), (lo + 1, d)):
        valid = (taps >= 0) & (taps < in_size)
        np.add.at(mat, (x[valid].astype(np.int64), taps[valid]), w[valid])
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _cubic_tensor(out_size: int, in_size: int, scale: float,
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_cubic_matrix(out_size, in_size, scale)).to(device)


@functools.lru_cache(maxsize=64)
def _fixed_aspect_tensors(th: int, tw: int, h: int, w: int, scale: float,
                          device: torch.device
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    if scale > 1.0:
        mh = _cubic_matrix(th, h, scale, a=-0.75, half_pixel=False).copy()
        mw = _cubic_matrix(tw, w, scale, a=-0.75, half_pixel=False).copy()
        # zero the rows that map fully outside the source
        mh[np.arange(th) / scale > h - 1 + 1e-9] = 0
        mw[np.arange(tw) / scale > w - 1 + 1e-9] = 0
    else:
        mh = _bilinear_matrix(th, h, scale)
        mw = _bilinear_matrix(tw, w, scale)
    return torch.from_numpy(mh).to(device), torch.from_numpy(mw).to(device)


def _apply_matrices(x: torch.Tensor, mh: torch.Tensor,
                    mw: torch.Tensor) -> torch.Tensor:
    """NHWC resample: out[b,y,x,c] = sum_ij mh[y,i] x[b,i,j,c] mw[x,j]."""
    b, h, w, c = x.shape
    rows = torch.matmul(mh, x.reshape(b, h, w * c))          # [B, th, W*C]
    th = mh.shape[0]
    out = torch.matmul(mw, rows.reshape(b * th, w, c))       # [B*th, tw, C]
    return out.reshape(b, th, mw.shape[0], c)


def _require_full_f32(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the heatmap path needs full float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def resize_bicubic(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Catmull-Rom upsample of NHWC maps to (H, W), half-pixel centres."""
    return upsample_merge([x], [1.0], target_hw)


def upsample_merge(sources: Sequence[torch.Tensor],
                   scale_ratios: Sequence[float],
                   target_hw: Tuple[int, int]) -> torch.Tensor:
    """Multi-scale resize-and-average of NHWC heatmaps onto the scale-0
    grid, scale i sampled at ``(target / source_0) / (s_i / s_0)``."""
    th, tw = target_hw
    h0, w0 = sources[0].shape[1], sources[0].shape[2]
    acc = None
    for src, ratio in zip(sources, scale_ratios):
        _require_full_f32(src)
        rel = ratio / scale_ratios[0]
        mh = _cubic_tensor(th, src.shape[1], (th / h0) / rel, src.device)
        mw = _cubic_tensor(tw, src.shape[2], (tw / w0) / rel, src.device)
        out = _apply_matrices(src.to(torch.float32), mh, mw)
        acc = out if acc is None else acc + out
    return acc / len(sources)


def resize_fixed_aspect(image: torch.Tensor, scale: float,
                        target_hw: Tuple[int, int]) -> torch.Tensor:
    """Scale an NHWC image by `scale` into an (H, W) canvas, zero-padded at
    the bottom/right: cv::warpAffine semantics (src = dst / scale), Keys
    cubic (a = -0.75) when upscaling, bilinear with a black border else."""
    th, tw = target_hw
    mh, mw = _fixed_aspect_tensors(th, tw, image.shape[1], image.shape[2],
                                   float(scale), image.device)
    return _apply_matrices(image.to(torch.float32), mh, mw)


def normalize_vgg(image: torch.Tensor) -> torch.Tensor:
    """VGG input normalization x/256 - 0.5."""
    return image * (1.0 / 256.0) - 0.5
