"""Scale planning and keypoint rescaling.

`extract_scales` mirrors ScaleAndSizeExtractor::extract
(src/openpose/core/scaleAndSizeExtractor.cpp:37-112): given the input
resolution, produce per-scale net input sizes (multiples of 16, aspect kept)
and input->net scale factors; plus the input->output scale.

`scale_keypoints` mirrors KeypointScaler (src/openpose/core/keypointScaler.cpp)
for the supported ScaleModes.

The port's own copy of `openpose_tpu/pose/scaler.py` (host code, no framework):
the port imports nothing of the JAX package, and
`tests/test_torch_standalone.py` holds the two copies to each other.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple

import numpy as np


def _iround(a: float) -> int:
    return int(a + 0.5)


def resize_get_scale_factor(initial: Tuple[int, int], target: Tuple[int, int]) -> float:
    """(w, h) sizes -> min scale ratio (src/openpose/utilities/openCv.cpp:182-189)."""
    ratio_w = (target[0] - 1) / (initial[0] - 1)
    ratio_h = (target[1] - 1) / (initial[1] - 1)
    return min(ratio_w, ratio_h)


class ScaleMode(enum.Enum):
    """Output coordinate frames (include/openpose/core/enumClasses.hpp)."""

    InputResolution = "InputResolution"
    NetOutputResolution = "NetOutputResolution"
    OutputResolution = "OutputResolution"
    ZeroToOne = "ZeroToOne"
    PlusMinusOne = "PlusMinusOne"


@dataclasses.dataclass(frozen=True)
class ScalePlan:
    scale_input_to_net: Tuple[float, ...]   # per scale
    net_input_sizes: Tuple[Tuple[int, int], ...]  # (w, h) per scale
    scale_input_to_output: float
    output_resolution: Tuple[int, int]      # (w, h)


def extract_scales(input_resolution: Tuple[int, int],
                   net_resolution: Tuple[int, int] = (-1, 368),
                   scale_number: int = 1, scale_gap: float = 0.25,
                   output_resolution: Tuple[int, int] = (-1, -1),
                   net_resolution_dynamic: float = -1.0) -> ScalePlan:
    """input_resolution/net_resolution/output_resolution are (width, height);
    -1 in net_resolution means 'derive from aspect ratio, multiple of 16'.
    `net_resolution_dynamic` > 0 clips the derived width to
    ratio * 656 * (net_h/368) to bound memory, like the reference flag
    (include/openpose/flags.hpp net_resolution_dynamic,
    scaleAndSizeExtractor.cpp)."""
    in_w, in_h = input_resolution
    net_w, net_h = net_resolution
    if net_w <= 0 and net_h <= 0:
        raise ValueError("only one net dimension may be -1")
    if net_w <= 0:
        net_w = 16 * _iround(net_h * in_w / in_h / 16.0)
        if net_resolution_dynamic > 0:
            cap = 16 * _iround(net_resolution_dynamic * 656.0
                               * net_h / 368.0 / 16.0)
            net_w = min(net_w, cap)
    elif net_h <= 0:
        net_h = 16 * _iround(net_w * in_h / in_w / 16.0)

    scales: List[float] = []
    sizes: List[Tuple[int, int]] = []
    for i in range(scale_number):
        current = 1.0 - i * scale_gap
        if current < 0 or current > 1:
            raise ValueError("scales must satisfy 0 <= 1 - i*scale_gap <= 1")
        tw = min(max(_iround(net_w * current) // 16 * 16, 1), net_w)
        th = min(max(_iround(net_h * current) // 16 * 16, 1), net_h)
        scales.append(resize_get_scale_factor((in_w, in_h), (tw, th)))
        sizes.append((tw, th))

    if output_resolution[0] > 0 and output_resolution[1] > 0:
        out_res = output_resolution
        s_out = resize_get_scale_factor((in_w, in_h), out_res)
    else:
        out_res = (in_w, in_h)
        s_out = 1.0
    return ScalePlan(tuple(scales), tuple(sizes), s_out, out_res)


def scale_keypoints(keypoints: np.ndarray, scale: float) -> np.ndarray:
    """Scale x, y (not score) by `scale`."""
    if keypoints.size == 0 or scale == 1.0:
        return keypoints
    out = keypoints.copy()
    out[..., 0] *= scale
    out[..., 1] *= scale
    return out


def keypoints_to_mode(keypoints: np.ndarray, mode: ScaleMode,
                      input_resolution: Tuple[int, int],
                      net_output_resolution: Tuple[int, int],
                      output_resolution: Tuple[int, int]) -> np.ndarray:
    """Convert keypoints from input-resolution frame to the requested frame
    (src/openpose/core/keypointScaler.cpp)."""
    if keypoints.size == 0 or mode == ScaleMode.InputResolution:
        return keypoints
    in_w, in_h = input_resolution
    out = keypoints.copy()
    if mode == ScaleMode.ZeroToOne:
        out[..., 0] /= in_w - 1
        out[..., 1] /= in_h - 1
    elif mode == ScaleMode.PlusMinusOne:
        out[..., 0] = 2.0 * out[..., 0] / (in_w - 1) - 1
        out[..., 1] = 2.0 * out[..., 1] / (in_h - 1) - 1
    elif mode == ScaleMode.NetOutputResolution:
        s = resize_get_scale_factor(input_resolution, net_output_resolution)
        out[..., 0] *= s
        out[..., 1] *= s
    elif mode == ScaleMode.OutputResolution:
        s = resize_get_scale_factor(input_resolution, output_resolution)
        out[..., 0] *= s
        out[..., 1] *= s
    return out
