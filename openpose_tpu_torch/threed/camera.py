"""Camera parameter I/O, compatible with the reference's per-serial XML files.

Reads/writes the OpenCV FileStorage XML layout used by CameraParameterReader
(src/openpose/3d/cameraParameterReader.cpp:85-174; sample file
models/cameraParameters/flir/17012332.xml.example): matrices CameraMatrix
(3x4 extrinsics M = K[R|t] premultiplied or plain [R|t]), Intrinsics (3x3),
Distortion (8x1).
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class CameraParameters:
    serial: str
    camera_matrix: np.ndarray          # [3, 4] extrinsics ([R|t])
    intrinsics: np.ndarray             # [3, 3]
    distortion: np.ndarray             # [N] (usually 5 or 8)

    @property
    def full_matrix(self) -> np.ndarray:
        """M = K @ [R|t] (what triangulation consumes;
        cameraParameterReader.cpp computes this product on load)."""
        return self.intrinsics @ self.camera_matrix


def _parse_matrix(node) -> np.ndarray:
    rows = int(node.findtext("rows"))
    cols = int(node.findtext("cols"))
    data = [float(x) for x in node.findtext("data").split()]
    return np.asarray(data, np.float64).reshape(rows, cols)


def _matrix_xml(name: str, mat: np.ndarray) -> str:
    flat = " ".join(repr(float(v)) for v in np.asarray(mat).reshape(-1))
    return (f'<{name} type_id="opencv-matrix">\n'
            f'  <rows>{mat.shape[0]}</rows>\n'
            f'  <cols>{mat.shape[1] if mat.ndim > 1 else 1}</cols>\n'
            f'  <dt>d</dt>\n'
            f'  <data>\n    {flat}</data></{name}>\n')


def read_camera_xml(path: str) -> CameraParameters:
    text = pathlib.Path(path).read_text()
    # strip XML comments that ElementTree chokes on inside prolog
    root = ET.fromstring(re.sub(r"<!--.*?-->", "", text, flags=re.S))
    cm = _parse_matrix(root.find("CameraMatrix"))
    intr = _parse_matrix(root.find("Intrinsics"))
    dist_node = root.find("Distortion")
    dist = (_parse_matrix(dist_node).reshape(-1)
            if dist_node is not None else np.zeros(8))
    serial = pathlib.Path(path).stem.replace(".xml", "")
    return CameraParameters(serial, cm, intr, dist)


def write_camera_xml(path: str, params: CameraParameters) -> None:
    body = (_matrix_xml("CameraMatrix", params.camera_matrix)
            + _matrix_xml("Intrinsics", params.intrinsics)
            + _matrix_xml("Distortion", params.distortion.reshape(-1, 1)))
    pathlib.Path(path).write_text(
        '<?xml version="1.0"?>\n<opencv_storage>\n' + body
        + "</opencv_storage>\n")


def read_camera_directory(directory: str,
                          serials: Optional[List[str]] = None
                          ) -> List[CameraParameters]:
    """Load every *.xml in a directory (sorted by serial), like
    CameraParameterReader::readParameters with empty serial list."""
    d = pathlib.Path(directory)
    paths = sorted(d.glob("*.xml")) if serials is None else [
        d / f"{s}.xml" for s in serials]
    return [read_camera_xml(str(p)) for p in paths]
