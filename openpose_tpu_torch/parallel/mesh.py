"""Device mesh and sharding rules for running over several cards.

Counterpart of `openpose_tpu/parallel/mesh.py` over `torch.distributed`: one
global mesh with two dimensions,

* ``data``  -- the frame batch, or the points of a bundle adjustment;
* ``model`` -- conv output channels (tensor parallelism).

A weight is sharded over ``model`` by its output channels when they divide
evenly, and replicated otherwise (the small 26/52-channel heads at some
mesh sizes).  The port keeps conv weights OIHW, so the sharded dimension of
a 4-D weight is 0 (the original's HWIO shards dimension 3).  Placements are
DTensor's: one per mesh dimension, in the order (data, model).

The process group must be initialised first (`torch.distributed.
init_process_group` with its address, world size and rank: nothing on the
machine tells a program of a cluster).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard


def make_mesh(devices: Optional[Sequence[int]] = None,
              data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the given ranks (all of the initialised
    process group's by default).  `device_type` is "cuda" unless the caller
    names "cpu" (a gloo group)."""
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def param_sharding(mesh: DeviceMesh, params):
    """DTensor placements matching `params` (`{layer: {key: tensor}}`, OIHW
    conv weights): channel-sharded over ``model`` where that divides."""
    model_size = mesh.shape[mesh.mesh_dim_names.index("model")]

    def shard_leaf(leaf: torch.Tensor) -> Tuple[Placement, ...]:
        # shard the output channels only when they divide evenly
        if leaf.ndim in (1, 4) and leaf.shape[0] % model_size == 0:
            return (Replicate(), Shard(0))
        return replicated(mesh)
    return {layer: {key: shard_leaf(leaf) for key, leaf in sub.items()}
            for layer, sub in params.items()}


def batch_sharding(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """The leading (batch) dimension over ``data``, replicated over
    ``model``."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    return (Replicate(), Replicate())
