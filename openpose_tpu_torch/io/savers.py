"""Output savers: images, video, keypoints, heatmaps, UDP streaming.

Mirrors the reference filestream module (src/openpose/filestream/):
ImageSaver, VideoSaver (imageSaver.cpp, videoSaver.cpp), KeypointSaver
(OpenCV-FileStorage-style JSON/XML/YML, keypointSaver.cpp), HeatMapSaver
(float PNG, heatMapSaver.cpp), UdpSender (udpSender.cpp — plain UDP here).

Counterpart of `openpose_tpu/io/savers.py`, the same code with OpenCV
imported inside the functions that call it: keypoint JSON, raw float
heatmaps and UDP need no OpenCV.  One deliberate difference: a yml or xml
keypoint file takes a frame with no people (the original raises on it).
"""

from __future__ import annotations

import json
import pathlib
import socket
from typing import Dict, List, Optional, Sequence

import numpy as np


class ImageSaver:
    """PNG/JPG frames to a directory (imageSaver.cpp)."""

    def __init__(self, directory: str, image_format: str = "png"):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.format = image_format

    def save(self, image: np.ndarray, name: str) -> str:
        import cv2
        path = self.dir / f"{name}_rendered.{self.format}"
        cv2.imwrite(str(path), image)
        return str(path)


class VideoSaver:
    """cv::VideoWriter wrapper (videoSaver.cpp; MJPG avi default)."""

    def __init__(self, path: str, fps: float = 30.0,
                 fourcc: str = "MJPG"):
        import cv2
        self.path = path
        self.fps = fps
        self.fourcc = cv2.VideoWriter_fourcc(*fourcc)
        self.writer: Optional[cv2.VideoWriter] = None

    def write(self, frame: np.ndarray) -> None:
        if self.writer is None:
            import cv2
            h, w = frame.shape[:2]
            self.writer = cv2.VideoWriter(self.path, self.fourcc, self.fps,
                                          (w, h))
        self.writer.write(frame.astype(np.uint8))

    def close(self) -> None:
        if self.writer is not None:
            self.writer.release()
            self.writer = None

    def mux_audio_from(self, source_video: str) -> bool:
        """Copy the source video's audio track into the written file
        (reference: videoSaver.cpp ffmpeg remux, --write_video with audio).
        Requires the ffmpeg binary; returns False (and leaves the silent
        video) when unavailable."""
        import shutil
        import subprocess
        if self.writer is not None or shutil.which("ffmpeg") is None:
            return False
        tmp = self.path + ".mux.avi"
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", "-i", self.path,
                 "-i", source_video, "-c:v", "copy", "-map", "0:v:0",
                 "-map", "1:a:0?", "-shortest", tmp],
                check=True)
            pathlib.Path(tmp).replace(self.path)
            return True
        except (subprocess.CalledProcessError, OSError):
            pathlib.Path(tmp).unlink(missing_ok=True)
            return False


class KeypointSaver:
    """Keypoints in OpenCV FileStorage layout (keypointSaver.cpp):
    one entry per array, named e.g. pose_0, stored as sizes + flat data."""

    def __init__(self, directory: str, file_format: str = "json"):
        if file_format not in ("json", "xml", "yml"):
            raise ValueError(f"unsupported format {file_format}")
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.format = file_format

    def save(self, keypoints: Sequence[np.ndarray], name: str,
             key: str = "pose") -> str:
        path = self.dir / f"{name}_{key}.{self.format}"
        if self.format == "json":
            payload = {}
            for i, arr in enumerate(keypoints):
                arr = np.asarray(arr)
                payload[f"{key}_{i}"] = {
                    "sizes": list(arr.shape),
                    "data": [round(float(v), 6) for v in arr.reshape(-1)]}
            path.write_text(json.dumps(payload))
        else:
            import cv2
            fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_WRITE)
            for i, arr in enumerate(keypoints):
                arr = np.asarray(arr, np.float32)
                # a frame with no people is a (0, parts * 3) matrix
                fs.write(f"{key}_{i}", arr.reshape(
                    arr.shape[0], arr.shape[1] * arr.shape[2])
                    if arr.ndim == 3 else arr)
            fs.release()
        return str(path)


class HeatMapSaver:
    """Raw float heatmaps (heatMapSaver.cpp): .float binary or PNG tiles."""

    def __init__(self, directory: str, image_format: str = "float"):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.format = image_format

    def save(self, heatmaps: np.ndarray, name: str) -> str:
        heatmaps = np.asarray(heatmaps, np.float32)
        if self.format == "float":
            path = self.dir / f"{name}_heatmaps.float"
            # reference raw format: dims count, dims, row-major data
            with open(path, "wb") as f:
                dims = np.asarray([heatmaps.ndim] + list(heatmaps.shape),
                                  np.float32)
                f.write(dims.tobytes())
                f.write(heatmaps.tobytes())
        else:
            import cv2
            path = self.dir / f"{name}_heatmaps.png"
            tile = np.concatenate(
                [heatmaps[..., c] for c in range(heatmaps.shape[-1])], axis=1)
            norm = np.clip((tile + 1.0) * 127.5, 0, 255).astype(np.uint8)
            cv2.imwrite(str(path), norm)
        return str(path)


def load_float_heatmaps(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.float32)
    ndim = int(raw[0])
    shape = [int(v) for v in raw[1:1 + ndim]]
    return raw[1 + ndim:].reshape(shape).copy()


class UdpSender:
    """Stream keypoint JSON over UDP (udpSender.cpp's role; JSON payload
    instead of the Adam-specific binary layout)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8051):
        self.address = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, payload: Dict) -> None:
        self.sock.sendto(json.dumps(payload).encode(), self.address)

    def close(self) -> None:
        self.sock.close()
