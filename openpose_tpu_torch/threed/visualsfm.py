"""VisualSFM / SiftGPU export of chessboard correspondences.

Re-design of the reference's calibration mode-4 tooling
(src/openpose/calibration/cameraParameterEstimation.cpp:662-733
``writeVisualSFMSiftGPU`` and :2340-2420 ``estimateAndSaveSiftFile``): the
inner chessboard corners of each camera's views are written as a SiftGPU
``.sift`` binary (so VisualSFM treats each corner as a "feature") plus a
``FeatureMatches.txt`` pairing identical corner indices across cameras —
letting VisualSFM solve the multi-camera extrinsics as a structure-from-
motion problem.

Binary layout (exact reference parity, little-endian):
    int32 name      'SIFT' packed             (cameraParameterEstimation.cpp:662)
    int32 version   'V4.0' packed             (:665)
    int32 nSift
    int32 keyDimension  (5)
    int32 descDimension (128)
    nSift x (x, y, 0.0, scale=1.0, orientation=0.0) float32
    nSift x 128 zero uint8 descriptors
    int32 EOF       0xff + 'EOF'<<8 packed    (:666)

The port's copy of `openpose_tpu/threed/visualsfm.py`; the writers and
readers are numpy and `struct`, and only the mode-4 flow needs OpenCV.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SIFT_NAME = ord("S") + (ord("I") << 8) + (ord("F") << 16) + (ord("T") << 24)
SIFT_VERSION_4 = ord("V") + (ord("4") << 8) + (ord(".") << 16) + (ord("0") << 24)
SIFT_EOF = 0xFF + (ord("E") << 8) + (ord("O") << 16) + (ord("F") << 24)
KEY_DIMENSION = 5
DESC_DIMENSION = 128


def write_visualsfm_sift(path: str, points2d: np.ndarray) -> None:
    """Write [N, 2] pixel points as a SiftGPU .sift file
    (writeVisualSFMSiftGPU, cameraParameterEstimation.cpp:667-719)."""
    pts = np.asarray(points2d, np.float32).reshape(-1, 2)
    n = pts.shape[0]
    keys = np.zeros((n, KEY_DIMENSION), np.float32)
    keys[:, 0] = pts[:, 0]
    keys[:, 1] = pts[:, 1]
    keys[:, 3] = 1.0                      # scale; orientation stays 0
    with open(path, "wb") as f:
        f.write(struct.pack("<5i", SIFT_NAME, SIFT_VERSION_4, n,
                            KEY_DIMENSION, DESC_DIMENSION))
        f.write(keys.tobytes())
        f.write(np.zeros(n * DESC_DIMENSION, np.uint8).tobytes())
        f.write(struct.pack("<i", SIFT_EOF))


def read_visualsfm_sift(path: str) -> np.ndarray:
    """Parse a .sift file back to [N, 2] points (round-trip validation)."""
    data = pathlib.Path(path).read_bytes()
    name, version, n, key_dim, desc_dim = struct.unpack_from("<5i", data)
    if name != SIFT_NAME or version != SIFT_VERSION_4:
        raise ValueError(f"not a SiftGPU V4.0 file: {path}")
    keys = np.frombuffer(data, np.float32, count=n * key_dim,
                         offset=20).reshape(n, key_dim)
    tail = 20 + n * key_dim * 4 + n * desc_dim
    (eof,) = struct.unpack_from("<i", data, tail)
    if eof != SIFT_EOF:
        raise ValueError(f"missing SIFT EOF marker: {path}")
    return keys[:, :2].copy()


def camera_file_stem(camera_index: int) -> str:
    """'00_0<i>' / '00_<i>' naming (getFileNameFromCameraIndex,
    cameraParameterEstimation.cpp:721-737)."""
    if camera_index >= 100:
        raise ValueError("only implemented for up to 99 cameras")
    return ("00_0" if camera_index < 10 else "00_") + str(camera_index)


def write_feature_matches(path: str,
                          match_indexes: Sequence[Sequence[int]]) -> None:
    """FeatureMatches.txt: for every camera pair, the sorted intersection
    of found-corner indices, repeated twice (once per camera's feature
    list) — the reference's match-file layout
    (cameraParameterEstimation.cpp:2386-2409)."""
    n_cameras = len(match_indexes)
    sets = [sorted(set(m)) for m in match_indexes]
    with open(path, "w") as f:
        for i in range(n_cameras):
            for j in range(i + 1, n_cameras):
                inter = sorted(set(sets[i]) & set(sets[j]))
                f.write(f"{camera_file_stem(i)}.jpg "
                        f"{camera_file_stem(j)}.jpg {len(inter)}\n")
                for _ in range(2):
                    f.write(" ".join(str(v) for v in inter) + " \n")
                f.write("\n")


def estimate_and_save_sift_files(
        grid_inner_corners: Tuple[int, int],
        image_folder: str,
        number_cameras: int,
        image_paths: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Full mode-4 flow (estimateAndSaveSiftFile,
    cameraParameterEstimation.cpp:2340-2420): images in `image_folder`
    ordered view-major (view0cam0, view0cam1, ..., view1cam0, ...), find
    inner chessboard corners per view per camera, write one
    ``<stem>.sift`` per camera plus ``FeatureMatches.txt``.

    Views where the chessboard is not found contribute (-1, -1) corner
    placeholders and no match indices (reference :786-795).
    Returns {sift_files, matches_file, n_views, found:[per-camera count]}.
    """
    from openpose_tpu_torch.threed.calibration import (find_chessboard,
                                                       opencv)
    cv2 = opencv()

    folder = pathlib.Path(image_folder)
    if image_paths is None:
        image_paths = sorted(
            str(p) for p in folder.iterdir()
            if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".bmp"))
    if not image_paths:
        raise FileNotFoundError(f"no images in {image_folder}")
    if len(image_paths) % number_cameras:
        raise ValueError(
            f"{len(image_paths)} images not divisible by "
            f"{number_cameras} cameras")
    n_views = len(image_paths) // number_cameras
    n_corners = grid_inner_corners[0] * grid_inner_corners[1]

    points: List[List[np.ndarray]] = [[] for _ in range(number_cameras)]
    match_indexes: List[List[int]] = [[] for _ in range(number_cameras)]
    found_count = [0] * number_cameras
    for view in range(n_views):
        for cam in range(number_cameras):
            img = cv2.imread(image_paths[view * number_cameras + cam])
            corners = None if img is None else find_chessboard(
                img, grid_inner_corners)
            if corners is not None and corners.shape[0] == n_corners:
                points[cam].append(corners.astype(np.float32))
                match_indexes[cam].extend(
                    view * n_corners + i for i in range(n_corners))
                found_count[cam] += 1
            else:
                points[cam].append(
                    np.full((n_corners, 2), -1.0, np.float32))

    sift_files = []
    for cam in range(number_cameras):
        path = str(folder / f"{camera_file_stem(cam)}.sift")
        write_visualsfm_sift(path, np.concatenate(points[cam], axis=0))
        sift_files.append(path)
    matches_file = str(folder / "FeatureMatches.txt")
    write_feature_matches(matches_file, match_indexes)
    return {"sift_files": sift_files, "matches_file": matches_file,
            "n_views": n_views, "found": found_count}
