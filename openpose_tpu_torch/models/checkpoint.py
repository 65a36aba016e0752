"""Weight bridge from the JAX package's parameters to the port's.

The JAX executor keeps conv weights HWIO; the port keeps PyTorch's OIHW.
Bias and PReLU slope are 1-D in both.  Both functions return the params
dict that `graph.PoseNet` takes.
"""

from __future__ import annotations

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
