"""Multi-view 3D triangulation: batched DLT + Gauss-Newton Huber refinement.

Counterpart of `openpose_tpu/threed/triangulation.py` (the reference's
PoseTriangulation, src/openpose/3d/poseTriangulation.cpp:9-120,
poseTriangulationPrivate.cpp:119-281) in torch ops:

* keypoint validity: score > 0.35 and >= 8 px from the image border;
* min views: clamp(#cams - 1, 2, 4) unless overridden;
* DLT: the eigenvector of the smallest eigenvalue of A^T A, A the stacked
  rows [x*P3 - P1; y*P3 - P2] of the valid views, for every keypoint at once;
* refinement: 10 fixed Gauss-Newton steps with iteratively reweighted Huber
  (delta 2 px) on the per-view reprojection norm, the projection's Jacobian
  in closed form, each step one batched 3x3 solve;
* outlier gate: mean reprojection error under 25 * sqrt(w*h / 1310720) px,
  or the point is zeroed.

Every keypoint of every person is one row of the same batched tensors: all
parts x all views are computed and invalid views carry zero weight, so one
call solves a whole frame (`reconstruct_array`).  float32 throughout; the
device work runs on the card unless the caller names another device.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule

VALID_SCORE_THRESHOLD = 0.35
BORDER_PX = 8.0
HUBER_DELTA = 2.0
REPROJECTION_MAX_BASE = 25.0  # * sqrt(area / 1310720)
GAUSS_NEWTON_ITERATIONS = 10

Device = Union[str, torch.device, None]


def _dlt_solve(points2d: torch.Tensor, cams: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """points2d [..., V, 2], cams [V, 3, 4], mask [..., V] -> [..., 4]
    homogeneous points scaled to w = 1.  Masked views give zero rows."""
    x = points2d[..., 0:1]
    y = points2d[..., 1:2]
    rows_x = x * cams[:, 2, :] - cams[:, 0, :]            # [..., V, 4]
    rows_y = y * cams[:, 2, :] - cams[:, 1, :]
    m = mask[..., None]
    a = torch.cat([rows_x * m, rows_y * m], dim=-2)       # [..., 2V, 4]
    ata = a.transpose(-1, -2) @ a
    _, v = torch.linalg.eigh(ata)                         # ascending
    sol = v[..., :, 0]
    w4 = sol[..., 3:4]
    w4 = torch.where(w4.abs() > 1e-12, w4, torch.full_like(w4, 1e-12))
    return sol / w4


def _project(point3d: torch.Tensor, cams: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., 4] homogeneous points, [V, 3, 4] cams -> (pixels [..., V, 2],
    guarded depth [..., V], whether the depth was kept as it is [..., V])."""
    proj = torch.einsum("vij,...j->...vi", cams, point3d)  # [..., V, 3]
    z = proj[..., 2]
    kept = z.abs() > 1e-9
    z = torch.where(kept, z, torch.full_like(z, 1e-9))
    return proj[..., :2] / z[..., None], z, kept


def _gauss_newton_refine(point3d: torch.Tensor, points2d: torch.Tensor,
                         cams: torch.Tensor, mask: torch.Tensor,
                         iterations: int = GAUSS_NEWTON_ITERATIONS
                         ) -> torch.Tensor:
    """Minimise sum_v Huber(||proj_v - obs_v||) over each 3-D point:
    point3d [..., 4], points2d [..., V, 2], mask [..., V] -> [..., 4]."""
    eye = 1e-9 * torch.eye(3, dtype=point3d.dtype, device=point3d.device)
    rows = cams[:, :2, :3]                                # [V, 2, 3]
    depth_row = cams[:, 2, :3]                            # [V, 3]
    p3 = point3d
    for _ in range(iterations):
        xyz = p3[..., :3] / p3[..., 3:4]
        p3 = torch.cat([xyz, torch.ones_like(xyz[..., :1])], -1)
        pix, z, kept = _project(p3, cams)
        r = pix - points2d                                # [..., V, 2]
        # d(p_i / z) / dxyz = (P_i - (p_i / z) P_3) / z; a clamped depth is
        # a constant (the reference projection's guard)
        jac = (rows - pix[..., None] * (depth_row[:, None, :]
                                        * kept[..., None, None])) \
            / z[..., None, None]                          # [..., V, 2, 3]
        rn = torch.sqrt((r * r).sum(-1) + 1e-12)
        wv = torch.where(rn <= HUBER_DELTA, torch.ones_like(rn),
                         HUBER_DELTA / rn) * mask         # [..., V]
        jw = jac * wv[..., None, None]
        jtj = torch.einsum("...vki,...vkj->...ij", jw, jac) + eye
        jtr = torch.einsum("...vki,...vk->...i", jw, r)
        delta = torch.linalg.solve_ex(jtj, jtr[..., None])[0][..., 0]
        p3 = torch.cat([xyz - delta, p3[..., 3:]], -1)
    return p3


@torch.no_grad()
def triangulate_points(points2d, scores, cams, image_wh, min_views: int = 0,
                       refine: bool = True, device: Device = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangulate keypoints seen from V views.

    points2d: [..., K, V, 2] pixel coords per keypoint per view (any
              leading batch, e.g. people).
    scores:   [..., K, V] detection scores.
    cams:     [V, 3, 4] camera matrices M = K [R|t].
    image_wh: [V, 2] image sizes (for border/outlier thresholds).

    Returns (xyzs [..., K, 4] = x, y, z, score; valid [..., K] bool) on the
    device.  Score is the mean 2D score over the used views (the reference
    Datum::poseKeypoints3D convention).
    """
    dev = device_rule.resolve(device)

    def f32(t):
        return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t,
                               dtype=torch.float32).to(dev)

    points2d, scores, cams, image_wh = map(f32, (points2d, scores, cams,
                                                 image_wh))
    n_cams = scores.shape[-1]
    mv = min_views if min_views > 0 else int(np.clip(n_cams - 1, 2, 4))

    valid_view = ((scores > VALID_SCORE_THRESHOLD)
                  & (points2d[..., 0] > BORDER_PX)
                  & (points2d[..., 0] < image_wh[:, 0] - BORDER_PX)
                  & (points2d[..., 1] > BORDER_PX)
                  & (points2d[..., 1] < image_wh[:, 1] - BORDER_PX))
    n_valid = valid_view.sum(-1)
    enough = n_valid >= mv
    mask = valid_view.to(torch.float32)

    p3 = _dlt_solve(points2d, cams, mask)
    if refine:
        p3 = _gauss_newton_refine(p3, points2d, cams, mask)
    err = torch.sqrt(((_project(p3, cams)[0] - points2d) ** 2).sum(-1))
    mean_err = (err * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)

    area = image_wh[0, 0] * image_wh[0, 1]
    max_err = REPROJECTION_MAX_BASE * torch.sqrt(area / 1310720.0)
    ok = enough & (mean_err < max_err)
    mean_score = (scores * mask).sum(-1) / n_valid.clamp_min(1)
    xyzs = torch.where(ok[..., None],
                       torch.cat([p3[..., :3], mean_score[..., None]], -1),
                       torch.zeros((), dtype=torch.float32, device=dev))
    return xyzs, ok


def reconstruct_array(keypoints_per_view: Sequence[np.ndarray],
                      cam_matrices: np.ndarray, image_sizes,
                      min_views: int = 0, device: Device = None
                      ) -> np.ndarray:
    """Host entry mirroring PoseTriangulation::reconstructArray: every
    person of the frame in one `triangulate_points` call.

    keypoints_per_view: list of [people, parts, 3] arrays (same people order
    across views; the reference makes the same assumption for its stereo
    rigs and uses the least number of people over the views).
    Returns [people, parts, 4] (x, y, z, score).
    """
    views = [np.asarray(kv) for kv in keypoints_per_view]
    n_people = min((v.shape[0] for v in views if v.size), default=0)
    if n_people == 0:
        return np.zeros((0, 0, 4), np.float32)
    parts = next(v.shape[1] for v in views if v.size)
    v_count = len(views)
    pts = np.zeros((n_people, parts, v_count, 2), np.float32)
    scs = np.zeros((n_people, parts, v_count), np.float32)
    for i, kv in enumerate(views):
        if kv.size:
            pts[:, :, i, :] = kv[:n_people, :, :2]
            scs[:, :, i] = kv[:n_people, :, 2]
    xyzs, _ = triangulate_points(pts, scs, cam_matrices,
                                 np.asarray(image_sizes, np.float32),
                                 min_views, device=device)
    return xyzs.cpu().numpy()
