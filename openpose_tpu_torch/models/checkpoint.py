"""Weight bridge between the JAX package's parameters and the port's, and
the checkpoint file both packages read.

The JAX executor keeps conv weights HWIO; the port keeps PyTorch's OIHW.
Bias and PReLU slope are 1-D in both.  `from_jax_params` and `load_npz`
return the params dict that `graph.PoseNet` takes; `to_jax_params` and
`save` go the other way, so that either package loads what the other
trained: the file is the JAX package's (`openpose_tpu/models/checkpoint.py`:
one `.npz`, keys `"layer/key"`, HWIO weights).
"""

from __future__ import annotations

import pathlib
from typing import Dict, Mapping

import numpy as np
import torch

from openpose_tpu_torch.models.graph import Params


def from_jax_params(params: Mapping[str, Mapping[str, np.ndarray]]) -> Params:
    """JAX params (`{layer: {"w" | "b" | "slope": array}}`, any array type
    numpy can read) -> float32 torch params, conv weights HWIO -> OIHW."""
    out: Params = {}
    for layer, sub in params.items():
        conv: Dict[str, torch.Tensor] = {}
        for key, val in sub.items():
            arr = np.asarray(val, np.float32)
            if key == "w":
                arr = arr.transpose(3, 2, 0, 1)
            conv[key] = torch.tensor(arr)
        out[layer] = conv
    return out


def load_npz(path: str) -> Params:
    """Read the `.npz` that `openpose_tpu.models.checkpoint.save` writes
    (keys `"layer/key"`, HWIO weights) into port params."""
    with np.load(path) as data:
        nested: Dict[str, Dict[str, np.ndarray]] = {}
        for full_key in data.files:
            layer, key = full_key.rsplit("/", 1)
            nested.setdefault(layer, {})[key] = data[full_key]
    return from_jax_params(nested)


def to_jax_params(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """Port params (tensors on any device, in any memory format) -> float32
    numpy arrays in the JAX layout, conv weights OIHW -> HWIO; the inverse
    of `from_jax_params`, bit for bit."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for layer, sub in params.items():
        conv: Dict[str, np.ndarray] = {}
        for key, val in sub.items():
            # numpy sees the logical OIHW order of a channels-last tensor
            arr = val.detach().to("cpu", torch.float32).numpy()
            if key == "w":
                arr = arr.transpose(2, 3, 1, 0)
            conv[key] = np.ascontiguousarray(arr)
        out[layer] = conv
    return out


def save(path: str, params: Params) -> None:
    """Write port params as the `.npz` that `load_npz` and
    `openpose_tpu.models.checkpoint.load` read."""
    flat = {f"{layer}/{key}": val
            for layer, sub in to_jax_params(params).items()
            for key, val in sub.items()}
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
