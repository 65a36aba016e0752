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

The process model is SPMD, one process per card: every rank calls the same
entry point with its own rows of the global batch (`local_rows`), data rank
`r` of `d` the rows `[r*B/d, (r+1)*B/d)`, and the ranks of one ``model``
group hold the same rows.  A model-sharded weight is a DTensor holding the
rank's shard (`shard_params`); `graph.PoseNet.param` gathers it at use
(`full_tensor()`), and its gradient comes back as the rank's shard: the
collectives are all-gathers of weights only, as in the original.

The process group must be initialised first: `process_group` joins one on
this machine through a file (no address, no network), NCCL on cards and
gloo on the CPU; elsewhere `torch.distributed.init_process_group` with its
address, world size and rank (nothing on the machine tells a program of a
cluster).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from openpose_tpu_torch import device as device_rule


@contextlib.contextmanager
def process_group(init_file: str, world_size: int, rank: int,
                  device: Union[str, torch.device]) -> Iterator[torch.device]:
    """Join a group of `world_size` ranks of this machine that meet through
    `init_file` (a path no earlier group used), as `rank`: NCCL where
    `device` is a card, which becomes the rank's current device, and gloo
    where it is the CPU.  Yields the device; the group is destroyed on
    leaving the block, however it is left."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"file://{init_file}", world_size=world_size, rank=rank)
    try:
        yield device
    finally:
        dist.destroy_process_group()


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


def size(mesh: Optional[DeviceMesh], dim: str) -> int:
    """The number of shards along mesh dimension `dim` (1 without a
    mesh)."""
    return 1 if mesh is None else mesh.shape[mesh.mesh_dim_names.index(dim)]


def rank_device(mesh: Optional[DeviceMesh],
                device: Union[str, torch.device, None] = None
                ) -> torch.device:
    """The device a rank of `mesh` computes on: the named one, else the
    current card of a CUDA mesh or the CPU of a gloo one; without a mesh,
    `device.resolve`'s.  A named device of another type than the mesh's
    raises: a meshed entry point never moves to the CPU on its own."""
    if mesh is None:
        return device_rule.resolve(device)
    if device is None:
        return torch.device("cpu") if mesh.device_type == "cpu" \
            else torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"device {device} is not on the mesh's "
                         f"{mesh.device_type!r} devices")
    return device


def local_rows(mesh: Optional[DeviceMesh], batch: int) -> slice:
    """This rank's rows of a global batch of `batch`: data rank r of d takes
    `[r*batch/d, (r+1)*batch/d)` (all of them without a mesh).  Raises
    ValueError naming both sizes when the batch does not tile the mesh."""
    if mesh is None:
        return slice(0, batch)
    shards = size(mesh, "data")
    if batch % shards:
        raise ValueError(f"batch {batch} does not tile the mesh's {shards} "
                         "data shards")
    share = batch // shards
    start = mesh.get_local_rank("data") * share
    return slice(start, start + share)


def param_sharding(mesh: DeviceMesh, params):
    """DTensor placements matching `params` (`{layer: {key: tensor}}`, OIHW
    conv weights): channel-sharded over ``model`` where that divides."""
    model_size = size(mesh, "model")

    def shard_leaf(leaf: torch.Tensor) -> Tuple[Placement, ...]:
        # shard the output channels only when they divide evenly
        if leaf.ndim in (1, 4) and leaf.shape[0] % model_size == 0:
            return (Replicate(), Shard(0))
        return replicated(mesh)
    return {layer: {key: shard_leaf(leaf) for key, leaf in sub.items()}
            for layer, sub in params.items()}


def shard_params(mesh: DeviceMesh, params):
    """`params` (the same full tree on every rank) as DTensors holding this
    rank's shards by `param_sharding`'s placements; no collective."""
    placements = param_sharding(mesh, params)
    index = mesh.get_local_rank("model")
    model_size = size(mesh, "model")

    def shard_leaf(leaf: torch.Tensor, place) -> DTensor:
        local = leaf.detach()
        if isinstance(place[1], Shard):
            local = local.chunk(model_size)[index]
        return DTensor.from_local(local.clone(), mesh, place,
                                  run_check=False)
    return {layer: {key: shard_leaf(leaf, placements[layer][key])
                    for key, leaf in sub.items()}
            for layer, sub in params.items()}


def gather_params(params):
    """The full tensors of a param tree whose leaves may be DTensors (an
    all-gather over ``model`` for each sharded one: every rank of the group
    calls it); plain leaves are returned as they are."""
    return {layer: {key: leaf.full_tensor() if isinstance(leaf, DTensor)
                    else leaf for key, leaf in sub.items()}
            for layer, sub in params.items()}


def batch_sharding(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """The leading (batch) dimension over ``data``, replicated over
    ``model``."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    return (Replicate(), Replicate())
