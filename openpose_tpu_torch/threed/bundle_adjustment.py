"""Bundle adjustment: joint refinement of 3-D points and camera extrinsics.

Counterpart of `openpose_tpu/threed/bundle_adjustment.py` in torch ops:
minimise the robust reprojection error over every 3-D keypoint and the
cameras' extrinsics together,

    min_{X, c}  sum_{p, v}  Huber(|| proj(K_v [R(c_v) | t(c_v)] X_p) - obs ||)

by Levenberg-Marquardt with the Schur complement: each point's 3x3 block is
eliminated, leaving the reduced 6V x 6V camera system.

* Cameras are se(3) twists around the initial extrinsics (axis-angle
  rotation + translation); camera 0 is held fixed (the gauge).
* Huber weights are iteratively reweighted and held constant while the
  Jacobians are taken (`.detach()`, the `stop_gradient` of the original).
* The Jacobians are forward-mode (`torch.func.jacfwd`) of the weighted
  residual of one point, batched over the points by `torch.func.vmap`.
* The whole LM loop stays on the device: accepting a step, rejecting it and
  the damping go through `torch.where`, and the solves are the `_ex` forms
  that leave a singular system to its NaNs (as the original's do) instead
  of checking it on the host, so no iteration waits for the host.

With a `mesh` (`parallel/mesh.py`), every rank takes its contiguous share of
the points on the mesh's `data` dimension, builds its part of the reduced
system and of the cost, and one all-reduce over the `data` group assembles
them (the `psum` of the original's `shard_map`); the small camera solve is
replicated, each rank back-substitutes its own points, and the points are
all-gathered at the end, so every rank returns the whole answer.  float32
throughout; TF32 must be off on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import jacfwd, vmap

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.ops import resize
from openpose_tpu_torch.threed.triangulation import Device

HUBER_DELTA = 2.0


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle [3] -> rotation matrix [3, 3] (stable near 0).

    At w = 0, theta = sqrt(0 + 1e-12) rounds to float32(1e-6) exactly, so
    the sin/cos branch is taken there (as in the original), with k = w /
    theta carrying a 1e6 factor into the Jacobian; near 0 the two branches
    agree to float32 rounding."""
    theta = torch.sqrt(torch.sum(w * w) + 1e-12)
    k = w / theta
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    kx = torch.stack([torch.stack([zero, -k[2], k[1]]),
                      torch.stack([k[2], zero, -k[0]]),
                      torch.stack([-k[1], k[0], zero])])
    s = torch.sin(theta)
    c = torch.cos(theta)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    r = eye + s * kx + (1.0 - c) * (kx @ kx)
    # theta ~ 0: first-order fallback
    small = theta < 1e-6
    r0 = eye + kx * theta
    return torch.where(small, r0, r)


def _camera_matrix(intrinsics: torch.Tensor, extrinsics0: torch.Tensor,
                   twist: torch.Tensor) -> torch.Tensor:
    """K [3,3], base [R0|t0] [3,4], twist [6] -> refined M = K [R|t]."""
    delta_r = _rodrigues(twist[:3])
    r = delta_r @ extrinsics0[:, :3]
    t = delta_r @ extrinsics0[:, 3] + twist[3:]
    return intrinsics @ torch.cat([r, t[:, None]], dim=1)


def _point_residuals(point: torch.Tensor, cams: torch.Tensor,
                     obs: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """point [3]; cams [V,3,4]; obs [V,2] -> (residuals [2V], weights [2V])."""
    ph = torch.cat([point, torch.ones(1, dtype=point.dtype,
                                      device=point.device)])
    proj = cams @ ph                                  # [V, 3]
    z = torch.where(proj[:, 2].abs() > 1e-9, proj[:, 2], 1e-9)
    r = (proj[:, :2] / z[:, None] - obs).reshape(-1)  # [2V]
    rn = torch.sqrt(torch.sum(r.reshape(-1, 2) ** 2, -1) + 1e-12)
    wv = torch.where(rn <= HUBER_DELTA, 1.0, HUBER_DELTA / rn) * mask
    # IRLS: the weights are constants of the step (differentiating through
    # them biases the Gauss-Newton step)
    return r, wv.repeat_interleave(2).detach()


def _build_normal_eqs(points, twists, intrinsics, extrinsics0, obs, mask):
    """This shard's reduced camera system by the Schur complement.

    points [Ps,3]; obs [Ps,V,2]; mask [Ps,V]; twists [V,6].
    Returns (h [6V,6V], b [6V]) summed over the shard's points, and per
    point what back-substitution needs: (hpp_inv [Ps,3,3], hpc [Ps,3,6V],
    bp [Ps,3])."""
    v = twists.shape[0]

    def resid(pt, tw_flat, ob, mk):
        cams = vmap(_camera_matrix)(intrinsics, extrinsics0,
                                    tw_flat.reshape(v, 6))
        r, w = _point_residuals(pt, cams, ob, mk)
        return r * torch.sqrt(w)

    tw_flat = twists.reshape(-1)
    per_point = (0, None, 0, 0)
    r = vmap(resid, per_point)(points, tw_flat, obs, mask)       # [Ps, 2V]
    jp, jc = vmap(jacfwd(resid, argnums=(0, 1)), per_point)(
        points, tw_flat, obs, mask)                # [Ps, 2V, 3], [Ps, 2V, 6V]
    jpt = jp.transpose(1, 2)
    hpp = jpt @ jp + 1e-6 * torch.eye(3, dtype=jp.dtype, device=jp.device)
    hpc = jpt @ jc                                               # [Ps, 3, 6V]
    hcc = jc.transpose(1, 2) @ jc                                # [Ps, 6V, 6V]
    bp = (jpt @ r[..., None])[..., 0]
    bc = (jc.transpose(1, 2) @ r[..., None])[..., 0]
    hpp_inv = torch.linalg.inv_ex(hpp)[0]
    hcp_inv = hpc.transpose(1, 2) @ hpp_inv
    h_red = hcc - hcp_inv @ hpc
    b_red = bc - (hcp_inv @ bp[..., None])[..., 0]
    return h_red.sum(0), b_red.sum(0), hpp_inv, hpc, bp


def bundle_adjust(points3d, observations, vis_mask, intrinsics, extrinsics0,
                  iterations: int = 10, mesh=None, device: Device = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Refine points and camera extrinsics.

    points3d [N,3]; observations [N,V,2] pixels; vis_mask [N,V];
    intrinsics [V,3,3]; extrinsics0 [V,3,4] (arrays or tensors).
    Returns (refined points [N,3], refined extrinsics [V,3,4]) as float32
    numpy arrays.  With `mesh` (a `parallel.mesh.make_mesh` mesh, called
    by every rank with the same inputs), the points are shared out over its
    `data` dimension, which must divide N, and every rank returns the whole
    answer.  The device is the card unless named; with a mesh and no
    device, the mesh's device type.
    """
    if device is None and mesh is not None:
        device = mesh.device_type
    dev = device_rule.resolve(device)

    def f32(a):
        a = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return a.to(dev, torch.float32)

    pts, obs, msk, kk, e0 = map(f32, (points3d, observations, vis_mask,
                                      intrinsics, extrinsics0))
    resize._require_full_f32(pts)
    n, v = msk.shape
    group = None
    if mesh is not None:
        group = mesh.get_group("data")
        shards = dist.get_world_size(group)
        if n % shards:
            raise ValueError(f"{n} points do not divide over the mesh's "
                             f"{shards} data shards")
        rank = mesh.get_local_rank("data")
        share = n // shards
        lo = rank * share
        pts, obs, msk = (t[lo:lo + share] for t in (pts, obs, msk))

    def total_cost(pts_, twists_):
        cams = vmap(_camera_matrix)(kk, e0, twists_)
        r, w = vmap(_point_residuals, (0, None, 0, 0))(pts_, cams, obs, msk)
        cost = (w * r * r).sum(-1).sum()
        if group is not None:
            dist.all_reduce(cost, group=group)
        return cost

    fix = torch.ones((v, 6), device=dev)
    fix[0] = 0.0
    fix = fix.reshape(-1)
    free = torch.diag(1.0 - fix)
    twists = torch.zeros((v, 6), device=dev)
    lam = torch.tensor(1e-3, device=dev)
    cost = total_cost(pts, twists)
    for _ in range(iterations):
        # Levenberg-Marquardt: a damped step, kept only if the cost drops
        h, b, hpp_inv, hpc, bp = _build_normal_eqs(pts, twists, kk, e0, obs,
                                                   msk)
        if group is not None:
            hb = torch.cat([h.reshape(-1), b])
            dist.all_reduce(hb, group=group)
            h, b = hb[:-6 * v].reshape(6 * v, 6 * v), hb[-6 * v:]
        # gauge fix: freeze camera 0 (its block becomes the identity)
        h = h * fix[:, None] * fix[None, :] + free
        h = h + lam * torch.diag(torch.clamp_min(torch.diag(h), 1e-6))
        b = b * fix
        delta_c = -torch.linalg.solve_ex(h, b)[0]
        # back-substitute each point's update, with the same damping
        rhs = bp + (hpc @ delta_c)
        delta_p = -torch.linalg.solve_ex(
            torch.linalg.inv_ex(hpp_inv)[0] * (1.0 + lam),
            rhs[..., None])[0][..., 0]
        new_pts = pts + delta_p
        new_twists = twists + delta_c.reshape(v, 6)
        new_cost = total_cost(new_pts, new_twists)
        accept = new_cost < cost
        pts = torch.where(accept, new_pts, pts)
        twists = torch.where(accept, new_twists, twists)
        lam = torch.where(accept, lam / 3.0, lam * 10.0)
        cost = torch.where(accept, new_cost, cost)

    if group is not None:
        parts = [torch.empty_like(pts) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, pts, group=group)
        pts = torch.cat(parts)
    eye = torch.eye(3, device=dev).expand(v, 3, 3)
    refined_ext = vmap(_camera_matrix)(eye, e0, twists)
    return pts.cpu().numpy(), refined_ext.cpu().numpy()
