"""Training step for the pose CNNs (heatmap + PAF regression).

Counterpart of `openpose_tpu/train.py`: the CPM/PAF objective, L2
regression of the net output against rendered targets (arXiv:1812.08008
section 2).  Targets are rendered on the device from keypoint annotations:
Gaussian part maps, background, and unit-vector limb bands at stride 8.

* The trained net is a `graph.PoseNet(..., trainable=True)`, called outside
  `torch.inference_mode()`; serving code gets `state.net.serving_view()`, a
  net over the same storage that takes no gradient.
* The optimizer is `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`:
  bias-corrected moments, `eps` added to the square root of the second
  moment and nothing under it.  That is the formula of `optax.adam(lr)`
  (`eps_root = 0`), which the JAX trainer uses.
* `compute_dtype` is float32 (the parity mode: convolutions without TF32,
  forward and backward) or bfloat16 (the fast mode on the card: float32
  master weights, rounded to bfloat16 for each step's convolutions;
  autograd carries the gradients back through the rounding).
* Over a mesh (`parallel/mesh.py`) every rank steps on its own rows of the
  global batch.  The gradients and the loss are averaged over ``data`` in
  one all-reduce: the original's loss is the mean over the whole global
  batch, and the shards are equal.  With a ``model`` dimension above 1 the
  weights, their gradients and Adam's moments are the rank's shards (Adam
  is elementwise, so the update equals the full one).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.models import graph
from openpose_tpu_torch.models.caffe_proto import NetSpec
from openpose_tpu_torch.parallel import mesh as mesh_lib

# learning rate of a step, counted from 0
Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    net: graph.PoseNet               # trainable float32 master weights
    optimizer: torch.optim.Adam
    schedule: Schedule
    step: int = 0                    # optimizer steps taken

    @property
    def params(self) -> graph.Params:
        """The weights as `{layer: {key: tensor}}` (`checkpoint.save`)."""
        return self.net.params()


def make_targets(keypoints: torch.Tensor, pairs: torch.Tensor,
                 map_idx: torch.Tensor, hw: Tuple[int, int], num_parts: int,
                 num_channels: int, stride: int = 8, sigma: float = 7.0,
                 paf_width: float = 1.0) -> torch.Tensor:
    """Render [B, H/stride, W/stride, C] training targets on the keypoints'
    device.

    keypoints: [B, people, parts, 3] in input-pixel coords (score > 0 =
    valid).  Returns the channel layout of the net output: parts,
    background, PAFs.  `synthetic.make_targets` is its numpy twin."""
    dev = keypoints.device
    pairs, map_idx = pairs.long(), map_idx.long()
    h, w = hw[0] // stride, hw[1] // stride
    grid_y = ((torch.arange(h, dtype=torch.float32, device=dev) + 0.5)
              * stride - 0.5)[:, None]
    grid_x = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5)
              * stride - 0.5)[None, :]
    kx, ky, kv = keypoints[..., 0], keypoints[..., 1], keypoints[..., 2] > 0

    # part maps: max over people of exp(-d^2 / 2 sigma^2)
    d2 = ((grid_x - kx[..., None, None]) ** 2
          + (grid_y - ky[..., None, None]) ** 2)
    g = torch.exp(-d2 / (2.0 * sigma * sigma)) * kv[..., None, None]
    conf = g.amax(dim=1).permute(0, 2, 3, 1)               # [B, h, w, parts]
    bkg = torch.clamp(1.0 - conf.amax(dim=-1, keepdim=True), 0.0, 1.0)

    # PAFs: the unit limb vector within paf_width * stride of the segment,
    # extended by one cell past both joints (CMU's putVecMaps margin: the
    # stride-8 stripe would else end a cell short of the joint and line
    # samples at the peak read zero), averaged over the covering people
    pa, pb = pairs[:, 0], pairs[:, 1]
    ax, ay, bx, by = kx[:, :, pa], ky[:, :, pa], kx[:, :, pb], ky[:, :, pb]
    pv = kv[:, :, pa] & kv[:, :, pb]
    vx, vy = bx - ax, by - ay
    norm = torch.sqrt(vx * vx + vy * vy)
    nz = norm > 1e-3
    zero = torch.zeros((), device=dev)
    ux = torch.where(nz, vx / norm.clamp(min=1e-3), zero)[..., None, None]
    uy = torch.where(nz, vy / norm.clamp(min=1e-3), zero)[..., None, None]
    px = grid_x - ax[..., None, None]
    py = grid_y - ay[..., None, None]
    along = px * ux + py * uy
    perp = (px * uy - py * ux).abs()
    margin = paf_width * stride
    on_limb = ((along >= -margin) & (along <= norm[..., None, None] + margin)
               & (perp <= paf_width * stride)
               & (pv & nz)[..., None, None])
    denom = on_limb.sum(dim=1).clamp(min=1).to(torch.float32)
    paf_x = (ux * on_limb).sum(dim=1) / denom              # [B, pairs, h, w]
    paf_y = (uy * on_limb).sum(dim=1) / denom

    # each pair owns its two channels, so the order of assignment is free
    off = num_parts + 1
    slots = torch.cat([map_idx[:, 0], map_idx[:, 1]]) - off
    paf = torch.zeros((keypoints.shape[0], num_channels - off, h, w),
                      dtype=torch.float32, device=dev)
    paf[:, slots] = torch.cat([paf_x, paf_y], dim=1)
    return torch.cat([conf, bkg, paf.permute(0, 2, 3, 1)], dim=-1)


def loss_fn(net: graph.PoseNet, images: torch.Tensor, targets: torch.Tensor,
            compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mean squared error between net output and rendered targets."""
    pred = net(images, compute_dtype)
    return torch.mean((pred - targets) ** 2)


def mean_over_data(net: graph.PoseNet, loss: torch.Tensor,
                   mesh) -> torch.Tensor:
    """Average `net`'s gradients (the rank's shards where they are
    DTensors) and `loss` over the mesh's ``data`` dimension, in place, with
    one all-reduce of one flat buffer; returns the averaged loss."""
    grads = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
             for p in net.parameters()]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    dist.all_reduce(flat, group=mesh.get_group("data"))
    flat /= mesh_lib.size(mesh, "data")
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()
    return flat[-1]


def make_train_step(compute_dtype: torch.dtype = torch.float32, mesh=None):
    """A `(state, images, targets) -> (state, loss)` step: loss, gradients
    and one Adam update at the schedule's rate for `state.step`.  The state
    is updated in place; the loss stays on the device.  With a `mesh` the
    images and targets are this rank's rows, and the gradients and the loss
    are averaged over its ``data`` dimension before the update."""

    def step(state: TrainState, images: torch.Tensor, targets: torch.Tensor):
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        with graph.full_f32_convs():       # the backward convolutions too
            loss = loss_fn(state.net, images, targets, compute_dtype)
            loss.backward()
        if mesh is not None:
            loss = mean_over_data(state.net, loss.detach(), mesh)
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def init_train_state(spec: NetSpec, generator: torch.Generator,
                     learning_rate: Union[float, Schedule] = 1e-4,
                     device: Union[str, torch.device, None] = None,
                     params: Optional[graph.Params] = None,
                     mesh=None) -> TrainState:
    """He-normal weights from `generator` (or `params`) on `device` (the
    card when None), Adam with zero moments, step 0.  learning_rate: a
    constant, or a function of the step.  mesh: where its ``model``
    dimension is above 1, the net holds this rank's shards of the weights
    (`parallel.mesh.shard_params`) and Adam updates those."""
    device = device_rule.resolve(device)
    if params is None:
        params = graph.init_params(spec, generator)
    net = graph.PoseNet(spec, params, trainable=True).to(device)
    if mesh_lib.size(mesh, "model") > 1:
        net = graph.PoseNet(spec, mesh_lib.shard_params(mesh, net.params()),
                            trainable=True)
    schedule = learning_rate if callable(learning_rate) \
        else (lambda step, lr=float(learning_rate): lr)
    optimizer = torch.optim.Adam(net.parameters(), lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(net, optimizer, schedule)


def warmup_cosine_schedule(peak: float, warmup_steps: int, decay_steps: int,
                           end: float) -> Schedule:
    """Linear warm-up from 0 to `peak` over `warmup_steps`, then a cosine
    from `peak` to `end` that finishes at step `decay_steps` (counted from
    step 0, the warm-up included: the cosine runs over `decay_steps -
    warmup_steps`) and stays there: the values of
    `optax.warmup_cosine_decay_schedule(0, peak, warmup_steps, decay_steps,
    end)`, which the JAX trainer uses."""
    cosine_steps = decay_steps - warmup_steps
    if warmup_steps <= 0 or cosine_steps <= 0:
        raise ValueError(f"need 0 < warmup_steps < decay_steps, got "
                         f"{warmup_steps} and {decay_steps}")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak * step / warmup_steps
        frac = min(step - warmup_steps, cosine_steps) / cosine_steps
        return end + (peak - end) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule
