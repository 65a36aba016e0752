"""Wrappers of the hand-written PAF kernels (`kernels/paf_score.cu`).

* `paf_scores_fused`, the port of the TPU kernel
  `openpose_tpu/ops/paf_pallas.py::paf_scores_fused`; plain version
  `paf.paf_scores_multiscale_reference`.
* `sample_bicubic_scales`, the port of the TPU kernel
  `openpose_tpu/ops/paf_pallas.py::sample_bicubic_pallas`, taking all scales
  of a pair block in one launch; plain version
  `paf.sample_bicubic_scales_reference` (the in-order sum of
  `paf.sample_bicubic_reference`).  `sample_bicubic` is its one-scale case.

On CUDA tensors each wrapper launches its kernel on the current stream, or
raises; it never falls back.  On CPU tensors it runs the plain version.
These are the only places that route between a kernel and its plain
version.  `<wrapper>.launches` counts the kernel launches.

Per call the wrapper checks shapes, dtypes, devices and layout, which needs
no host sync.  The values of `pairs` and `map_idx` are checked where the
tables are built (`paf.pair_tables`); the kernel scores NaN for a pair whose
entries index outside the peaks or the maps, and never reads out of bounds.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from openpose_tpu_torch.kernels import build
from openpose_tpu_torch.ops import paf

MAX_PEAKS = 128
MAX_SCALES = 8


def _check_inputs(sources, peaks, pairs, map_idx) -> None:
    device = peaks.device
    if not 1 <= len(sources) <= MAX_SCALES:
        raise ValueError(f"1..{MAX_SCALES} scales supported, got {len(sources)}")
    for name, t, dtype in (("peaks", peaks, torch.float32),
                           ("pairs", pairs, torch.int32),
                           ("map_idx", map_idx, torch.int32)):
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if peaks.ndim != 4 or peaks.shape[-1] != 3:
        raise ValueError(f"peaks must be [N, parts, K+1, 3], got {tuple(peaks.shape)}")
    k = peaks.shape[2] - 1
    if not 1 <= k <= MAX_PEAKS:
        raise ValueError(f"max_peaks {k} outside 1..{MAX_PEAKS}")
    if pairs.ndim != 2 or pairs.shape[1] != 2 or map_idx.shape != pairs.shape:
        raise ValueError("pairs and map_idx must both be [P, 2]")
    c = sources[0].shape[3]
    for src in sources:
        if src.device != device or src.dtype != torch.float32:
            raise ValueError(f"sources must be float32 on {device}")
        if src.ndim != 4 or src.shape[0] != peaks.shape[0] or src.shape[3] != c:
            raise ValueError(f"sources must be [N, h, w, {c}], "
                             f"got {tuple(src.shape)}")


def _scale_arrays(tensors, hs, ws, factors):
    """The per-scale host arrays both launchers take."""
    ns = len(tensors)
    return ((ctypes.c_void_p * ns)(*[t.data_ptr() for t in tensors]),
            (ctypes.c_int * ns)(*hs), (ctypes.c_int * ns)(*ws),
            (ctypes.c_double * ns)(*[float(f[0]) for f in factors]),
            (ctypes.c_double * ns)(*[float(f[1]) for f in factors]), ns)


def paf_scores_fused(sources: Sequence[torch.Tensor],
                     scale_ratios: Sequence[float],
                     target_hw: Tuple[int, int], peaks: torch.Tensor,
                     pairs: torch.Tensor, map_idx: torch.Tensor,
                     inter_threshold: float, inter_min_above_threshold: float,
                     default_nms_threshold: float,
                     smem_limit: int = 0) -> torch.Tensor:
    """[N, P, K, K] pair scores from per-scale NHWC net outputs
    [N, h_s, w_s, C], peaks [N, parts, K+1, 3] (K <= 128), and int32
    pairs / absolute map_idx [P, 2].  The kernel reads the NHWC maps as
    they are.  smem_limit (bytes, 0: what the device allows) caps the
    shared memory a block stages the maps in; the scores do not
    depend on it."""
    if not peaks.is_cuda:
        return paf.paf_scores_multiscale_reference(
            sources, scale_ratios, target_hw, peaks, pairs, map_idx,
            inter_threshold, inter_min_above_threshold, default_nms_threshold)
    _check_inputs(sources, peaks, pairs, map_idx)
    n, parts, k = peaks.shape[0], peaks.shape[1], peaks.shape[2] - 1
    p = pairs.shape[0]
    th, tw = target_hw
    maps = [src.contiguous() for src in sources]     # no copy when they are
    factors = paf._scale_factors(sources, scale_ratios, target_hw)
    out = torch.empty((n, p, k, k), dtype=torch.float32, device=peaks.device)
    lib = build.library()
    code = lib.paf_score_launch(
        *_scale_arrays(maps, [t.shape[1] for t in maps],
                       [t.shape[2] for t in maps], factors),
        maps[0].shape[3], peaks.data_ptr(), pairs.data_ptr(),
        map_idx.data_ptr(), out.data_ptr(), n, parts, p, k, th, tw,
        float(inter_threshold), float(inter_min_above_threshold),
        float(default_nms_threshold), int(smem_limit),
        peaks.device.index or 0,
        torch.cuda.current_stream(peaks.device).cuda_stream)
    build.check(lib, code, "paf_score_kernel launch")
    paf_scores_fused.launches += 1
    return out


paf_scores_fused.launches = 0


def _check_sampler_inputs(lows, my, mx) -> None:
    if not 1 <= len(lows) <= MAX_SCALES:
        raise ValueError(f"1..{MAX_SCALES} scales supported, got {len(lows)}")
    device = lows[0].device
    for low_xy in lows:
        if low_xy.device != device or low_xy.dtype != torch.float32 \
                or low_xy.ndim != 5 or low_xy.shape[2] != 2 \
                or low_xy.shape[:2] != lows[0].shape[:2]:
            raise ValueError(
                f"low_xy must be float32 [N, P, 2, hs, ws] on {device} with "
                f"one N, P for all scales, got {low_xy.dtype} "
                f"{tuple(low_xy.shape)} on {low_xy.device}")
    for name, t in (("my", my), ("mx", mx)):
        if t.device != device or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 on {device}, "
                             f"got {t.dtype} on {t.device}")
        if t.shape != my.shape or t.ndim != 3 \
                or tuple(t.shape[:2]) != tuple(lows[0].shape[:2]):
            raise ValueError(f"my and mx must both be [N, P, S] with the "
                             f"maps' N, P = {tuple(lows[0].shape[:2])}")
    for name, t in (*(("low_xy", low) for low in lows), ("my", my),
                    ("mx", mx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sample_bicubic_scales(lows: Sequence[torch.Tensor], my: torch.Tensor,
                          mx: torch.Tensor,
                          scales: Sequence[Tuple[float, float]],
                          smem_limit: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vx, vy) [N, P, S]: the sum over scales, in scale order, of the
    Catmull-Rom upsample of each pair's x/y planes lows[s]
    [N, P, 2, hs, ws] float32 by scales[s] = (scale_h, scale_w), at the
    int32 target-grid pixels my, mx [N, P, S] (any S; coordinates outside
    the grid read the clamped border taps).  One launch for all scales.
    smem_limit (bytes, 0: what the device allows) caps the shared memory a
    block copies the planes to; the values do not depend on it."""
    if len(lows) != len(scales):
        raise ValueError(f"{len(lows)} maps for {len(scales)} scales")
    if not lows[0].is_cuda:
        return paf.sample_bicubic_scales_reference(lows, my, mx, scales)
    _check_sampler_inputs(lows, my, mx)
    n, p = lows[0].shape[:2]
    vx = torch.empty(my.shape, dtype=torch.float32, device=my.device)
    vy = torch.empty_like(vx)
    lib = build.library()
    code = lib.sample_bicubic_launch(
        *_scale_arrays(lows, [t.shape[3] for t in lows],
                       [t.shape[4] for t in lows], scales),
        my.data_ptr(), mx.data_ptr(), vx.data_ptr(), vy.data_ptr(), n, p,
        my.shape[2], int(smem_limit), my.device.index or 0,
        torch.cuda.current_stream(my.device).cuda_stream)
    build.check(lib, code, "sample_bicubic_kernel launch")
    sample_bicubic_scales.launches += 1
    return vx, vy


sample_bicubic_scales.launches = 0


def sample_bicubic(low_xy: torch.Tensor, my: torch.Tensor, mx: torch.Tensor,
                   scale_h: float, scale_w: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`sample_bicubic_scales` with one scale: the function of the TPU
    kernel `sample_bicubic_pallas`, batched over frames."""
    return sample_bicubic_scales([low_xy], my, mx, [(scale_h, scale_w)])
