"""ctypes binding for the native frame pump (native/frame_pump.cpp).

A GIL-free worker pool that decodes + preprocesses frames into uint8 NHWC
net inputs in submission order (the reference's producer + WQueueOrderer
roles in C++).  Normalization (x/256 - 0.5) happens on-device so the
host->device upload is 4x smaller.  Falls back cleanly: `available()` is False when the shared
library has not been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import numpy as np

from openpose_tpu_torch.utils.native_build import ensure_built

_lib = None


def _load():
    global _lib
    if _lib is None:
        path = ensure_built("libframe_pump.so")
        if path is None:
            raise RuntimeError("native frame pump build failed: "
                               + ensure_built.last_error)
        lib = ctypes.CDLL(str(path))
        lib.fp_create.restype = ctypes.c_void_p
        lib.fp_create.argtypes = [ctypes.c_int] * 4
        lib.fp_submit_file.restype = ctypes.c_long
        lib.fp_submit_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.fp_submit_bytes.restype = ctypes.c_long
        lib.fp_submit_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int]
        lib.fp_next.restype = ctypes.c_long
        lib.fp_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.fp_pending.restype = ctypes.c_long
        lib.fp_pending.argtypes = [ctypes.c_void_p]
        lib.fp_destroy.argtypes = [ctypes.c_void_p]
        lib.vp_create.restype = ctypes.c_void_p
        lib.vp_create.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5
        lib.vp_create2.restype = ctypes.c_void_p
        lib.vp_create2.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 6
        lib.vp_next.restype = ctypes.c_long
        lib.vp_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int]
        lib.vp_next_batch.restype = ctypes.c_long
        lib.vp_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int]
        lib.vp_fps.restype = ctypes.c_double
        lib.vp_fps.argtypes = [ctypes.c_void_p]
        lib.vp_frame_count.restype = ctypes.c_long
        lib.vp_frame_count.argtypes = [ctypes.c_void_p]
        lib.vp_size.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
        lib.vp_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return ensure_built("libframe_pump.so") is not None


class NativeFramePump:
    """Ordered multi-threaded decode + preprocess to net-input tensors."""

    def __init__(self, net_w: int, net_h: int, threads: int = 4,
                 capacity: int = 32):
        self._lib = _load()
        self._handle = self._lib.fp_create(threads, capacity, net_w, net_h)
        self.net_w = net_w
        self.net_h = net_h

    def submit_file(self, path: str) -> int:
        return self._lib.fp_submit_file(self._handle, path.encode())

    def submit_bytes(self, data: bytes) -> int:
        return self._lib.fp_submit_bytes(self._handle, data, len(data))

    def next(self, timeout_ms: int = 10000
             ) -> Optional[Tuple[int, np.ndarray, float, Tuple[int, int]]]:
        """-> (seq, net_input [net_h, net_w, 3] BGR uint8, scale,
        (src_w, src_h)) or None on timeout; raises on decode failure."""
        out = np.empty((self.net_h, self.net_w, 3), np.uint8)
        scale = ctypes.c_double()
        wh = (ctypes.c_int * 2)()
        seq = self._lib.fp_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.byref(scale), wh, timeout_ms)
        if seq == -1:
            return None
        if seq == -2:
            raise IOError("native frame pump: decode failed")
        return int(seq), out, float(scale.value), (wh[0], wh[1])

    def pending(self) -> int:
        return int(self._lib.fp_pending(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.fp_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeVideoPump:
    """Native video decode + parallel preprocessing, frame order preserved
    (VideoCaptureReader + WDatumProducer roles in C++;
    native/frame_pump.cpp VideoPump).  Emits (seq, original BGR frame,
    uint8 net input, scale)."""

    def __init__(self, path: str, net_w: int, net_h: int, threads: int = 3,
                 capacity: int = 16, frame_step: int = 1,
                 frame_offset: int = 0):
        self._lib = _load()
        self._handle = self._lib.vp_create2(
            path.encode(), threads, capacity, net_w, net_h, frame_step,
            frame_offset)
        if not self._handle:
            raise IOError(f"cannot open video: {path}")
        self.net_w = net_w
        self.net_h = net_h
        w = ctypes.c_int()
        h = ctypes.c_int()
        self._lib.vp_size(self._handle, ctypes.byref(w), ctypes.byref(h))
        self.frame_size = (w.value, h.value)      # (w, h)
        self.fps = float(self._lib.vp_fps(self._handle))
        self.frame_count = int(self._lib.vp_frame_count(self._handle))

    def next(self, timeout_ms: int = 10000, want_frame: bool = True
             ) -> Optional[Tuple[int, Optional[np.ndarray], np.ndarray,
                                 float]]:
        """-> (seq, frame BGR uint8, net_input uint8, scale); None at EOF.

        want_frame=False skips the original-frame copy (~2.7 MB per HD
        frame) and yields frame=None — the keypoint-only path (no
        rendering / image output) never touches the full-size pixels."""
        net = np.empty((self.net_h, self.net_w, 3), np.uint8)
        if want_frame:
            frame = np.empty((self.frame_size[1], self.frame_size[0], 3),
                             np.uint8)
            frame_ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        else:
            frame = None
            frame_ptr = None
        scale = ctypes.c_double()
        seq = self._lib.vp_next(
            self._handle, net.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            frame_ptr, ctypes.byref(scale), timeout_ms)
        if seq == -3:
            return None
        if seq < 0:
            raise TimeoutError("native video pump: timeout")
        return int(seq), frame, net, float(scale.value)

    def __iter__(self):
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    def iter_net_only(self):
        """Iterate (seq, None, net_input, scale) without frame copies."""
        while True:
            item = self.next(want_frame=False)
            if item is None:
                return
            yield item

    def next_batch(self, n: int, timeout_ms: int = 10000,
                   out: Optional[np.ndarray] = None
                   ) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        """Pop up to n in-order net inputs into ONE contiguous buffer.

        -> (count, net [n, net_h, net_w, 3] uint8, scales [n] f64) with
        count <= n (short on timeout), or None at EOF with nothing left.
        One GIL-releasing C call per device batch replaces n per-frame
        calls + an np.stack copy; `out` (same shape/dtype) is filled in
        place when given, so the device upload buffer can be reused."""
        if out is None:
            out = np.empty((n, self.net_h, self.net_w, 3), np.uint8)
        scales = np.empty((n,), np.float64)
        count = self._lib.vp_next_batch(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            scales.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, timeout_ms)
        if count == -3:
            return None
        return int(count), out, scales

    def close(self) -> None:
        if self._handle:
            self._lib.vp_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

