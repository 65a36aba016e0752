"""3-D accuracy benchmark: synthetic multi-camera rig -> triangulation -> BA.

Counterpart of `openpose_tpu/accuracy3d.py`; closes the 3-D loop the way
`accuracy.py` closes the 2-D one.  Ground-truth 3-D skeletons are projected
through a synthetic calibrated K-camera rig, pixel noise is added, and the
port's reconstruction runs unchanged: the batched DLT + Gauss-Newton Huber
triangulation (`threed/triangulation.py`) and the bundle adjustment
(`threed/bundle_adjustment.py`).  Reported numbers:

* 3-D RMSE (mm) against the truth, per pixel-noise level;
* mean 2-D reprojection error (px) against the reference's outlier gate
  `25 * sqrt(area / 1310720)` px (poseTriangulation.cpp:98-120);
* camera-pose recovery error after BA from perturbed extrinsics.

The rig, the people and the noise are drawn on the host by numpy in the
original's order, so both packages build the same inputs from one seed.
The device work runs on the card unless the caller names another device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from openpose_tpu_torch import synthetic
from openpose_tpu_torch.threed.bundle_adjustment import bundle_adjust
from openpose_tpu_torch.threed.triangulation import Device, triangulate_points


def make_rig(n_cams: int = 4, radius_m: float = 3.0,
             image_wh: Tuple[int, int] = (1280, 720),
             focal_px: float = 1000.0) -> Tuple[np.ndarray, np.ndarray]:
    """Cameras on a circle looking at the origin.

    Returns (intrinsics [V,3,3], extrinsics [V,3,4]); full matrices are
    K @ [R|t] as CameraParameterReader computes on load."""
    w, h = image_wh
    kk = np.zeros((n_cams, 3, 3), np.float32)
    ext = np.zeros((n_cams, 3, 4), np.float32)
    for i in range(n_cams):
        ang = 2.0 * np.pi * i / n_cams
        c = np.array([radius_m * np.sin(ang), 0.0, -radius_m * np.cos(ang)])
        # camera looks at the origin: z axis toward -c
        z = -c / np.linalg.norm(c)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        r = np.stack([x, y, z])                  # world -> camera rotation
        t = -r @ c
        ext[i, :, :3] = r
        ext[i, :, 3] = t
        kk[i] = [[focal_px, 0, w / 2.0], [0, focal_px, h / 2.0], [0, 0, 1]]
    return kk, ext


def make_people_3d(rng: np.random.RandomState, n_people: int,
                   height_m: Tuple[float, float] = (1.5, 1.9),
                   depth_jitter_m: float = 0.06) -> np.ndarray:
    """[n, 25, 3] ground-truth 3-D skeletons (meters) around the rig center.

    BODY25_TEMPLATE posed in a vertical plane with per-keypoint depth jitter
    (so the geometry is non-planar, exercising the full DLT)."""
    out = np.zeros((n_people, 25, 3), np.float32)
    for p in range(n_people):
        height = rng.uniform(*height_m)
        pts = synthetic.BODY25_TEMPLATE.copy()
        if rng.rand() < 0.5:
            pts[:, 0] = -pts[:, 0]
        xyz = np.zeros((25, 3), np.float32)
        xyz[:, 0] = pts[:, 0] * height + rng.uniform(-0.8, 0.8)
        xyz[:, 1] = (pts[:, 1] - 0.45) * height     # hips near y=0
        xyz[:, 2] = rng.uniform(-0.5, 0.5) \
            + rng.uniform(-depth_jitter_m, depth_jitter_m, 25)
        out[p] = xyz
    return out


def project(points3d: np.ndarray, kk: np.ndarray, ext: np.ndarray
            ) -> np.ndarray:
    """[..., 3] world points -> [..., V, 2] pixels."""
    cams = np.einsum("vij,vjk->vik", kk, ext)            # [V, 3, 4]
    ph = np.concatenate([points3d, np.ones(points3d.shape[:-1] + (1,),
                                           points3d.dtype)], axis=-1)
    proj = np.einsum("vik,...k->...vi", cams, ph)        # [..., V, 3]
    return proj[..., :2] / np.maximum(np.abs(proj[..., 2:3]), 1e-9) \
        * np.sign(proj[..., 2:3])


def triangulation_eval(n_people: int = 8, n_cams: int = 4,
                       pixel_noise: float = 1.0, seed: int = 0,
                       image_wh: Tuple[int, int] = (1280, 720),
                       device: Device = None) -> Dict[str, float]:
    """Project -> noise -> triangulate (DLT + GN Huber) -> RMSE/reprojection.

    Every person is triangulated in one batched call."""
    rng = np.random.RandomState(seed)
    kk, ext = make_rig(n_cams, image_wh=image_wh)
    cams = np.einsum("vij,vjk->vik", kk, ext).astype(np.float32)
    gt = make_people_3d(rng, n_people)                   # [N, 25, 3]
    obs = project(gt, kk, ext)                           # [N, 25, V, 2]
    obs = obs + rng.normal(0.0, pixel_noise, obs.shape)
    scores = rng.uniform(0.5, 1.0, (n_people, 25, n_cams)).astype(np.float32)
    wh = np.tile(np.asarray(image_wh, np.float32), (n_cams, 1))

    xyzs_all, ok_all = triangulate_points(obs.astype(np.float32), scores,
                                          cams, wh, device=device)
    xyzs_all, ok_all = xyzs_all.cpu().numpy(), ok_all.cpu().numpy()
    errs, reps, n_valid = [], [], 0
    for p in range(n_people):
        xyzs, ok = xyzs_all[p], ok_all[p]
        val = ok & (np.abs(xyzs[:, :3]).sum(-1) > 0)
        n_valid += int(val.sum())
        if val.any():
            d = xyzs[val, :3] - gt[p][val]
            errs.append(np.sum(d * d, axis=-1))
            rep = project(xyzs[val, :3], kk, ext) - project(gt[p][val],
                                                            kk, ext)
            reps.append(np.sqrt(np.sum(rep ** 2, axis=-1)).mean(axis=-1))
    total = n_people * 25
    rmse_m = float(np.sqrt(np.concatenate(errs).mean())) if errs else -1.0
    rep_px = float(np.concatenate(reps).mean()) if reps else -1.0
    area = image_wh[0] * image_wh[1]
    return {"pixel_noise": pixel_noise,
            "rmse_mm": rmse_m * 1000.0,
            "reprojection_px": rep_px,
            "valid_fraction": n_valid / total,
            "reference_gate_px": 25.0 * float(np.sqrt(area / 1310720.0))}


def bundle_problem(n_people: int = 8, n_cams: int = 4,
                   pixel_noise: float = 1.0, cam_rot_err_deg: float = 0.5,
                   cam_t_err_m: float = 0.02, seed: int = 0,
                   device: Device = None) -> Dict[str, np.ndarray]:
    """`bundle_eval`'s inputs: the rig, the truth `gt` [N*25, 3], noisy
    observations `obs` [N*25, V, 2], the perturbed extrinsics `ext0` (every
    camera but the gauge anchor, camera 0) beside the true `ext_true`, and
    the points `pts0` triangulated (on `device`) with those wrong cameras;
    `vis` [N*25, V] says every view sees every point."""
    rng = np.random.RandomState(seed)
    image_wh = (1280, 720)
    kk, ext_true = make_rig(n_cams, image_wh=image_wh)
    gt = make_people_3d(rng, n_people).reshape(-1, 3)    # [N*25, 3]
    obs = project(gt, kk, ext_true)
    obs = obs + rng.normal(0.0, pixel_noise, obs.shape)

    # Perturb every camera but the gauge anchor
    ext0 = ext_true.copy()
    for vcam in range(1, n_cams):
        w = rng.normal(0, np.deg2rad(cam_rot_err_deg), 3)
        th = np.linalg.norm(w) + 1e-12
        k = w / th
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        dr = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)
        ext0[vcam, :, :3] = dr @ ext_true[vcam, :, :3]
        ext0[vcam, :, 3] = dr @ ext_true[vcam, :, 3] \
            + rng.normal(0, cam_t_err_m, 3)

    # Initial points: triangulate with the WRONG cameras
    cams0 = np.einsum("vij,vjk->vik", kk, ext0).astype(np.float32)
    wh = np.tile(np.asarray(image_wh, np.float32), (n_cams, 1))
    scores = np.ones((gt.shape[0], n_cams), np.float32)
    obs = obs.astype(np.float32)
    xyzs, _ = triangulate_points(obs, scores, cams0, wh, device=device)
    return {"gt": gt, "obs": obs, "kk": kk, "ext_true": ext_true,
            "ext0": ext0, "pts0": xyzs.cpu().numpy()[:, :3],
            "vis": np.ones((gt.shape[0], n_cams), np.float32)}


def bundle_eval(n_people: int = 8, n_cams: int = 4, pixel_noise: float = 1.0,
                cam_rot_err_deg: float = 0.5, cam_t_err_m: float = 0.02,
                iterations: int = 15, seed: int = 0, mesh=None,
                device: Device = None) -> Dict[str, float]:
    """BA recovery: perturbed extrinsics + noisy obs -> refined cameras/points.

    Reports point RMSE before/after BA and residual camera rotation (deg) /
    translation (mm) error after BA (camera 0 is the gauge anchor).  `mesh`
    goes to `bundle_adjust` as it is."""
    prob = bundle_problem(n_people, n_cams, pixel_noise, cam_rot_err_deg,
                          cam_t_err_m, seed, device)
    gt, pts0, ext_true = prob["gt"], prob["pts0"], prob["ext_true"]

    rmse_before = float(np.sqrt(((pts0 - gt) ** 2).sum(-1).mean()))
    pts1, ext1 = bundle_adjust(pts0, prob["obs"], prob["vis"], prob["kk"],
                               prob["ext0"], iterations=iterations, mesh=mesh,
                               device=device)
    rmse_after = float(np.sqrt(((pts1 - gt) ** 2).sum(-1).mean()))

    rot_err, t_err = [], []
    for vcam in range(1, n_cams):
        dr = ext1[vcam, :, :3] @ ext_true[vcam, :, :3].T
        ang = np.rad2deg(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))
        rot_err.append(ang)
        t_err.append(np.linalg.norm(ext1[vcam, :, 3] - ext_true[vcam, :, 3]))
    return {"pixel_noise": pixel_noise,
            "cam_rot_err_deg_in": cam_rot_err_deg,
            "cam_t_err_mm_in": cam_t_err_m * 1000.0,
            "rmse_mm_before_ba": rmse_before * 1000.0,
            "rmse_mm_after_ba": rmse_after * 1000.0,
            "cam_rot_err_deg_out": float(np.mean(rot_err)),
            "cam_t_err_mm_out": float(np.mean(t_err)) * 1000.0}


def noise_sweep(levels=(0.0, 0.5, 1.0, 2.0, 5.0), **kw) -> List[Dict]:
    return [triangulation_eval(pixel_noise=lv, **kw) for lv in levels]
