"""The yardstick's arithmetic: a net's FLOPs and the card's peaks.

`net_flops` is a copy of the port's `models/graph.py::count_flops` (2 FLOPs
a multiply-add; pooling and activations counted as the original counts
them), over the benchmark's frozen spec copies.  `PEAKS` is NVIDIA's H100
SXM datasheet, dense rates at the card's 700 W limit, the port's
`utils/benchmark.py::DATASHEET`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

from perfbench.reference import cnn

# (substrings all in the lower-cased device name, dense bf16 FLOP/s)
PEAKS = ((("h100", "hbm3"), 989.4e12),)


def bf16_peak(device_kind: str) -> Optional[float]:
    kind = device_kind.lower()
    for keys, peak in PEAKS:
        if all(k in kind for k in keys):
            return peak
    return None


@functools.lru_cache(maxsize=None)
def net_flops(spec_name: str, hw: Tuple[int, int]) -> int:
    """FLOPs of one image of (H, W) through the net, Caffe ceil-mode
    pooling."""
    spec = cnn.load_spec(spec_name)
    shapes = {spec["input"]: (hw[0], hw[1], spec["input_channels"])}
    total = 0
    for layer in spec["layers"]:
        h, w, c = shapes[layer["bottoms"][0]]
        kind = layer["type"]
        if kind == "Convolution":
            k, s, p = layer["kernel"], layer["stride"], layer["pad"]
            oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            out = (oh, ow, layer["num_output"])
            total += 2 * k * k * c * layer["num_output"] * oh * ow
        elif kind == "Pooling":
            k, s, p = layer["kernel"], layer["stride"], layer["pad"]
            oh = -(-(h + 2 * p - k) // s) + 1
            ow = -(-(w + 2 * p - k) // s) + 1
            out = (oh, ow, c)
            total += k * k * c * oh * ow
        elif kind in ("ReLU", "PReLU"):
            out = (h, w, c)
            total += h * w * c
        elif kind == "Concat":
            out = (h, w, sum(shapes[b][2] for b in layer["bottoms"]))
        else:
            raise ValueError(f"unsupported layer type {kind}")
        for top in layer["tops"]:
            shapes[top] = out
    return total
