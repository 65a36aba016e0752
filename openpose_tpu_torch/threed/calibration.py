"""Calibration toolbox: chessboard intrinsics + extrinsics (host tooling).

Mirrors the reference calibration module
(src/openpose/calibration/cameraParameterEstimation.cpp):

* mode 1 (estimate_intrinsics): chessboard corners + cv::calibrateCamera
  (ibid:148-190);
* mode 2 (estimate_extrinsics): solvePnP of the board in a target camera
  vs the base camera, composing relative extrinsics (ibid:454-471).

This is setup tooling, not the hot path — OpenCV on host is the right tool
(the reference uses the same OpenCV calls).  The port's copy of
`openpose_tpu/threed/calibration.py`: OpenCV is imported where it is used
(`opencv()`), so the package imports on a machine without it, and a call
there stops with an ImportError that says OpenCV is needed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from openpose_tpu_torch.threed.camera import CameraParameters


def opencv():
    """The cv2 module; ImportError naming OpenCV where it is missing."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("camera calibration needs OpenCV (the cv2 "
                          "module), which is not installed") from e
    return cv2


def _board_object_points(grid_inner: Tuple[int, int],
                         square_size_mm: float) -> np.ndarray:
    cols, rows = grid_inner
    objp = np.zeros((rows * cols, 3), np.float32)
    objp[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2)
    return objp * (square_size_mm / 1000.0)


def find_chessboard(image: np.ndarray, grid_inner: Tuple[int, int]
                    ) -> Optional[np.ndarray]:
    """Sub-pixel chessboard corners or None (gridPatternFunctions.cpp)."""
    cv2 = opencv()
    gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY) if image.ndim == 3 \
        else image
    found, corners = cv2.findChessboardCorners(
        gray, grid_inner,
        cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE)
    if not found:
        return None
    corners = cv2.cornerSubPix(
        gray, corners, (11, 11), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.001))
    return corners.reshape(-1, 2)


def estimate_intrinsics(images: Sequence[np.ndarray],
                        grid_inner: Tuple[int, int] = (9, 6),
                        square_size_mm: float = 40.0,
                        serial: str = "camera"
                        ) -> Tuple[CameraParameters, float]:
    """-> (parameters with identity extrinsics, RMS reprojection error)."""
    cv2 = opencv()
    objp = _board_object_points(grid_inner, square_size_mm)
    obj_points, img_points = [], []
    shape = None
    for img in images:
        corners = find_chessboard(img, grid_inner)
        if corners is not None:
            obj_points.append(objp)
            img_points.append(corners.astype(np.float32))
            shape = img.shape[:2][::-1]
    if len(obj_points) < 3:
        raise ValueError(
            f"chessboard found in only {len(obj_points)} images; >= 3 needed")
    rms, k, dist, _rv, _tv = cv2.calibrateCamera(
        obj_points, img_points, shape, None, None)
    params = CameraParameters(
        serial=serial,
        camera_matrix=np.hstack([np.eye(3), np.zeros((3, 1))]),
        intrinsics=k, distortion=dist.reshape(-1))
    return params, float(rms)


def estimate_extrinsics(base: CameraParameters, target: CameraParameters,
                        base_image: np.ndarray, target_image: np.ndarray,
                        grid_inner: Tuple[int, int] = (9, 6),
                        square_size_mm: float = 40.0) -> np.ndarray:
    """Relative [R|t] of `target` w.r.t. `base` from one simultaneous
    chessboard view pair (cameraParameterEstimation.cpp:454-471)."""
    cv2 = opencv()
    objp = _board_object_points(grid_inner, square_size_mm)
    exts = []
    for cam, img in ((base, base_image), (target, target_image)):
        corners = find_chessboard(img, grid_inner)
        if corners is None:
            raise ValueError("chessboard not visible in both cameras")
        ok, rvec, tvec = cv2.solvePnP(
            objp, corners.astype(np.float32), cam.intrinsics,
            cam.distortion[:5])
        if not ok:
            raise ValueError("solvePnP failed")
        r, _ = cv2.Rodrigues(rvec)
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = tvec.reshape(-1)
        exts.append(m)
    rel = exts[1] @ np.linalg.inv(exts[0])
    return rel[:3, :]


def undistort(image: np.ndarray, params: CameraParameters) -> np.ndarray:
    """Producer-side undistortion (producer.cpp undistort path)."""
    cv2 = opencv()
    return cv2.undistort(image, params.intrinsics, params.distortion[:8])
