"""Frame producers: video / webcam / IP camera / image directory.

Counterpart of `openpose_tpu/io/producers.py`, the same code with OpenCV
imported inside the functions that call it: a producer whose `_raw_frames`
yields arrays from memory runs where OpenCV is not installed.

Mirrors the reference producer family (src/openpose/producer/producer.cpp
factory :411-460, videoReader/webcamReader/ipCameraReader/
imageDirectoryReader) on top of cv::VideoCapture, with frame_first/step/last
windowing (DatumProducer, include/openpose/producer/datumProducer.hpp:14-190),
optional flip/rotate and undistortion, and multi-view frame splitting
(Matrix::splitCvMatIntoVectorMatrix for horizontally-concatenated stereo
frames).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from openpose_tpu_torch.threed.camera import CameraParameters, read_camera_directory

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")


@dataclasses.dataclass
class Frame:
    image: np.ndarray
    frame_id: int
    sub_id: int = 0
    sub_id_max: int = 0
    name: str = ""
    camera: Optional[CameraParameters] = None


@dataclasses.dataclass
class ProducerConfig:
    frame_first: int = 0
    frame_step: int = 1
    frame_last: int = -1          # -1 = until the end
    frames_repeat: bool = False   # loop the source forever (--frames_repeat)
    frame_flip: bool = False
    frame_rotate: int = 0         # 0 / 90 / 180 / 270
    num_views: int = 1            # split horizontally-concatenated views
    camera_parameter_path: Optional[str] = None
    undistort: bool = False


class Producer:
    """Base: applies windowing/flip/rotate/split to a raw frame stream."""

    seekable = False

    def __init__(self, config: ProducerConfig = ProducerConfig()):
        self.config = config
        self.cameras: List[CameraParameters] = []
        self._pending_seek = 0
        if config.camera_parameter_path:
            self.cameras = read_camera_directory(config.camera_parameter_path)

    def request_seek(self, delta: int) -> bool:
        """Jump delta frames (either direction) at the next read; the GUI's
        l/k seek (reference gui.cpp spVideoSeek atomics).  Returns False for
        non-seekable sources (webcam/IP streams)."""
        if not self.seekable:
            return False
        self._pending_seek += delta
        return True

    def _raw_frames(self) -> Iterator[Tuple[np.ndarray, str]]:
        raise NotImplementedError

    def _transform(self, img: np.ndarray) -> np.ndarray:
        c = self.config
        if c.frame_rotate:
            import cv2
            code = {90: cv2.ROTATE_90_COUNTERCLOCKWISE,
                    180: cv2.ROTATE_180,
                    270: cv2.ROTATE_90_CLOCKWISE}[c.frame_rotate]
            img = cv2.rotate(img, code)
        if c.frame_flip:
            import cv2
            img = cv2.flip(img, 1)
        return img

    def frames(self) -> Iterator[List[Frame]]:
        """Yields one List[Frame] per time step (len == num_views);
        loops forever when frames_repeat is set."""
        out_id = 0
        while True:
            yielded = False
            for frames in self._one_pass(out_id):
                yielded = True
                yield frames
                out_id = frames[0].frame_id + 1
            if not self.config.frames_repeat or not yielded:
                return

    def _one_pass(self, start_id: int) -> Iterator[List[Frame]]:
        c = self.config
        out_id = start_id
        for raw_index, (img, name) in enumerate(self._raw_frames()):
            if raw_index < c.frame_first:
                continue
            if c.frame_last >= 0 and raw_index > c.frame_last:
                break
            if (raw_index - c.frame_first) % c.frame_step != 0:
                continue
            img = self._transform(img)
            views = (np.array_split(img, c.num_views, axis=1)
                     if c.num_views > 1 else [img])
            frames = []
            for sub_id, view in enumerate(views):
                cam = self.cameras[sub_id] if sub_id < len(self.cameras) \
                    else None
                if c.undistort and cam is not None:
                    import cv2
                    view = cv2.undistort(view, cam.intrinsics,
                                         cam.distortion[:8])
                frames.append(Frame(
                    image=np.ascontiguousarray(view), frame_id=out_id,
                    sub_id=sub_id, sub_id_max=c.num_views - 1,
                    name=name, camera=cam))
            yield frames
            out_id += 1


class ImageDirectoryReader(Producer):
    """Sorted image files; carries the stem as output name
    (src/openpose/producer/imageDirectoryReader.cpp)."""

    seekable = True

    def __init__(self, directory: str,
                 config: ProducerConfig = ProducerConfig()):
        super().__init__(config)
        self.paths = sorted(
            p for p in pathlib.Path(directory).iterdir()
            if p.suffix.lower() in IMAGE_EXTENSIONS)
        if not self.paths:
            raise ValueError(f"no images found in {directory}")

    def _raw_frames(self):
        import cv2
        i = 0
        while i < len(self.paths):
            if self._pending_seek:
                i = int(np.clip(i + self._pending_seek, 0,
                                len(self.paths) - 1))
                self._pending_seek = 0
            p = self.paths[i]
            img = cv2.imread(str(p))
            if img is None:
                raise IOError(f"could not read image {p}")
            yield img, p.stem
            i += 1


class VideoReader(Producer):
    """cv::VideoCapture file wrapper (videoReader.cpp)."""

    seekable = True

    def __init__(self, path: str, config: ProducerConfig = ProducerConfig()):
        import cv2
        super().__init__(config)
        self.path = path
        self.capture = cv2.VideoCapture(path)
        if not self.capture.isOpened():
            raise IOError(f"could not open video {path}")
        self.fps = self.capture.get(cv2.CAP_PROP_FPS) or 30.0
        self.frame_count = int(self.capture.get(cv2.CAP_PROP_FRAME_COUNT))

    def _raw_frames(self):
        import cv2
        stem = pathlib.Path(self.path).stem
        if not self.capture.isOpened():       # reopened for --frames_repeat
            self.capture = cv2.VideoCapture(self.path)
        index = 0
        while True:
            if self._pending_seek:
                pos = self.capture.get(cv2.CAP_PROP_POS_FRAMES)
                hi = (self.frame_count - 1 if self.frame_count > 0
                      else pos + self._pending_seek)
                self.capture.set(cv2.CAP_PROP_POS_FRAMES,
                                 float(np.clip(pos + self._pending_seek,
                                               0, hi)))
                self._pending_seek = 0
            ok, img = self.capture.read()
            if not ok:
                break
            yield img, f"{stem}_{index:012d}"
            index += 1
        self.capture.release()


class WebcamReader(Producer):
    """Webcam / V4L index (webcamReader.cpp).

    Like the reference, frames are pulled on a side thread into a 1-slot
    buffer so the pipeline always consumes the FRESHEST frame instead of
    OpenCV's stale internal queue (webcamReader.cpp bufferingThread)."""

    def __init__(self, index: int = 0, resolution: Tuple[int, int] = (-1, -1),
                 config: ProducerConfig = ProducerConfig()):
        import cv2
        super().__init__(config)
        self.capture = cv2.VideoCapture(index)
        if not self.capture.isOpened():
            raise IOError(f"could not open webcam {index}")
        if resolution[0] > 0:
            self.capture.set(cv2.CAP_PROP_FRAME_WIDTH, resolution[0])
            self.capture.set(cv2.CAP_PROP_FRAME_HEIGHT, resolution[1])
        import threading
        self._lock = threading.Lock()
        self._latest = None
        self._stopped = False
        self._thread = threading.Thread(target=self._buffer_loop, daemon=True)
        self._thread.start()

    def _buffer_loop(self):
        while not self._stopped:
            ok, img = self.capture.read()
            if not ok:
                self._stopped = True
                break
            with self._lock:
                self._latest = img

    def close(self) -> None:
        self._stopped = True
        self._thread.join(timeout=2.0)
        self.capture.release()

    def _raw_frames(self):
        import time
        index = 0
        while True:
            with self._lock:
                img, self._latest = self._latest, None
            if img is None:
                if self._stopped:
                    break
                time.sleep(0.002)
                continue
            yield img, f"webcam_{index:012d}"
            index += 1


class IpCameraReader(VideoReader):
    """RTSP/HTTP stream (ipCameraReader.cpp) — same VideoCapture path."""

    seekable = False                    # live stream: no random access


def create_producer(image_dir: Optional[str] = None,
                    video: Optional[str] = None,
                    webcam: Optional[int] = None,
                    ip_camera: Optional[str] = None,
                    flir_camera: bool = False,
                    camera_resolution: Tuple[int, int] = (-1, -1),
                    config: ProducerConfig = ProducerConfig()) -> Producer:
    """Factory (producer.cpp:411-460)."""
    if flir_camera:
        # The reference's FlirReader requires the proprietary Spinnaker SDK
        # (src/openpose/producer/flirReader.cpp, spinnakerWrapper.cpp);
        # hardware-synced capture is out of scope here. Multi-camera rigs are
        # supported via --num_views on a stacked stream or per-view videos.
        raise NotImplementedError(
            "FLIR/Spinnaker capture is not supported; use --video/--ip_camera "
            "with --num_views and --camera_parameter_path instead")
    if image_dir:
        return ImageDirectoryReader(image_dir, config)
    if video:
        return VideoReader(video, config)
    if ip_camera:
        return IpCameraReader(ip_camera, config)
    if webcam is not None:
        return WebcamReader(webcam, resolution=camera_resolution,
                            config=config)
    raise ValueError("no input source given")
