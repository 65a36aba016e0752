"""Plain float32 forward of an OpenPose net spec (VGG trunk + CPM stages).

The spec is the benchmark's frozen copy of the deploy topology
(`specs/<name>.json`: Convolution, ReLU, PReLU, ceil-mode Pooling,
Concat).  `forward` runs it with `F.conv2d` in float32 and TF32 off, in
blocks of frames so that it fits beside whatever else the card holds.
`precision="fp8"` is the control: every convolution's input and weight
rounded to float8 e4m3 (a per-tensor scale, as an fp8 GEMM takes them),
products summed in float32.
"""

from __future__ import annotations

import functools
import json
import pathlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

SPEC_DIR = pathlib.Path(__file__).resolve().parent / "specs"
FP8_MAX = 448.0        # largest finite float8 e4m3fn


@functools.lru_cache(maxsize=None)
def load_spec(name: str) -> dict:
    return json.loads((SPEC_DIR / f"{name}.json").read_text())


def blob_channels(spec: dict) -> Dict[str, int]:
    out = {spec["input"]: spec["input_channels"]}
    for layer in spec["layers"]:
        if layer["type"] == "Convolution":
            c = layer["num_output"]
        elif layer["type"] == "Concat":
            c = sum(out[b] for b in layer["bottoms"])
        else:
            c = out[layer["bottoms"][0]]
        for top in layer["tops"]:
            out[top] = c
    return out


def learned_layers(spec: dict) -> Tuple[List[tuple], List[tuple]]:
    """([(conv name, c_in, c_out, kernel)], [(PReLU name, channels)])."""
    ch = blob_channels(spec)
    convs, prelus = [], []
    for layer in spec["layers"]:
        if layer["type"] == "Convolution":
            convs.append((layer["name"], ch[layer["bottoms"][0]],
                          layer["num_output"], layer["kernel"]))
        elif layer["type"] == "PReLU":
            prelus.append((layer["name"], ch[layer["bottoms"][0]]))
    return convs, prelus


def output_channels(spec: dict) -> int:
    return blob_channels(spec)[spec["output"]]


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / x.abs().amax().clamp(min=1e-12)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _max_pool(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """Caffe's ceil-mode pooling: the last window may start in the
    padding, which is -inf."""
    h, w = x.shape[2], x.shape[3]
    out_h = -(-(h + 2 * p - k) // s) + 1
    out_w = -(-(w + 2 * p - k) // s) + 1
    pad_h, pad_w = s * (out_h - 1) + k - h, s * (out_w - 1) + k - w
    if pad_h or pad_w:
        x = F.pad(x, (p, pad_w - p, p, pad_h - p), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def _forward_block(spec: dict, params, images: torch.Tensor,
                   precision: str) -> torch.Tensor:
    x = images.to(torch.float32) * (1.0 / 256.0) - 0.5       # VGG normalize
    acts = {spec["input"]: x.permute(0, 3, 1, 2).contiguous()}
    for layer in spec["layers"]:
        x = acts[layer["bottoms"][0]]
        kind = layer["type"]
        if kind == "Convolution":
            w, b = params[layer["name"]]["w"], params[layer["name"]]["b"]
            if precision == "fp8":
                x, w = _fp8(x), _fp8(w)
            out = F.conv2d(x, w.to(torch.float32), b.to(torch.float32),
                           layer["stride"], layer["pad"])
        elif kind == "ReLU":
            out = F.relu(x)
        elif kind == "PReLU":
            slope = params[layer["name"]]["slope"].to(torch.float32)
            out = torch.where(x >= 0, x, x * slope[:, None, None])
        elif kind == "Pooling":
            out = _max_pool(x, layer["kernel"], layer["stride"], layer["pad"])
        elif kind == "Concat":
            out = torch.cat([acts[b] for b in layer["bottoms"]], dim=1)
        else:
            raise ValueError(f"unsupported layer type {kind}")
        for top in layer["tops"]:
            acts[top] = out
    return acts[spec["output"]].permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def forward(spec: dict, params, images: torch.Tensor,
            precision: str = "float32", block: int = 2) -> torch.Tensor:
    """images [N, H, W, 3] BGR 0..255 -> net output [N, H/8, W/8, C]
    float32, `block` frames at a time."""
    if precision not in ("float32", "fp8"):
        raise ValueError(f"precision must be float32 or fp8, got {precision}")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        return torch.cat([_forward_block(spec, params, images[i:i + block],
                                         precision)
                          for i in range(0, images.shape[0], block)])
