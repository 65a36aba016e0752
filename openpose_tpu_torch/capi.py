"""Python half of the port's C ABI binding
(openpose_tpu_torch/native/c_api.cpp).

The reference ships a Unity plugin exposing a C ABI over its C++ core
(src/openpose/unity/unityBinding.cpp:459-675: _OPConfigure*, _OPRun, output
via registered callback).  Counterpart of `openpose_tpu/capi.py`: the
compute stays in the port's `Wrapper` (on the card unless the config names
another "device") behind the same flat C surface, through an embedded
CPython layer: the shim resolves these functions by name and marshals
images in / keypoints out as contiguous buffers.  Build the shim with
`utils/native_build.py::build_capi`.

Handle registry keyed by integer ids; all functions are exception-safe
(the C side turns raised exceptions into error codes + op_last_error()).
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_HANDLES: Dict[int, "object"] = {}
# The C header advertises any-thread calls; Wrapper.process/render mutate
# per-handle state (tracker, _prev_hand_rects), so serialize per handle.
_HANDLE_LOCKS: Dict[int, threading.Lock] = {}
_NEXT_ID = [1]


def _get(handle: int) -> Tuple["object", threading.Lock]:
    with _LOCK:
        return _HANDLES[handle], _HANDLE_LOCKS[handle]


def create(config_json: str) -> int:
    """Create a Wrapper from a JSON config; returns a handle id.

    Recognized keys (all optional; reference flag names): model_pose,
    net_resolution ("WxH"), scale_number, scale_gap, number_people_max,
    model_folder, face, hand, face_net_resolution, hand_net_resolution,
    compute_dtype, tracking, and device ("cuda", "cuda:1", "cpu"; the card
    when absent).
    """
    from openpose_tpu_torch.wrapper import (FaceConfig, HandConfig,
                                            PoseConfig, Wrapper)
    from openpose_tpu_torch.params import PoseModel

    cfg = json.loads(config_json) if config_json else {}

    def res(text: str) -> Tuple[int, int]:
        w, h = str(text).lower().split("x")
        return (int(w), int(h))

    pose = PoseConfig(
        model=PoseModel(cfg.get("model_pose", "BODY_25")),
        net_resolution=res(cfg.get("net_resolution", "-1x368")),
        scale_number=int(cfg.get("scale_number", 1)),
        scale_gap=float(cfg.get("scale_gap", 0.25)),
        number_people_max=int(cfg.get("number_people_max", -1)),
        model_folder=cfg.get("model_folder"),
        compute_dtype=cfg.get("compute_dtype", "bfloat16"),
        tracking=int(cfg.get("tracking", -1)),
    )
    face = FaceConfig(enable=bool(cfg.get("face", False)),
                      net_resolution=int(cfg.get("face_net_resolution", 368)))
    hand = HandConfig(enable=bool(cfg.get("hand", False)),
                      net_resolution=int(cfg.get("hand_net_resolution", 368)))
    wrapper = Wrapper(pose, face, hand, device=cfg.get("device"))
    with _LOCK:
        handle = _NEXT_ID[0]
        _NEXT_ID[0] += 1
        _HANDLES[handle] = wrapper
        _HANDLE_LOCKS[handle] = threading.Lock()
    return handle


def process(handle: int, image_bytes: bytes, height: int, width: int,
            frame_id: int = 0) -> Tuple[bytes, int, int]:
    """Run the pipeline on a HxWx3 uint8 BGR image given as raw bytes.

    Returns (keypoints_f32_bytes, num_people, num_parts); keypoints are
    (x, y, score) triples, people-major.
    """
    wrapper, lock = _get(handle)
    image = np.frombuffer(image_bytes, np.uint8).reshape(height, width, 3)
    with lock:
        datum = wrapper.process(image, frame_id)
    kp = datum.pose_keypoints
    if kp is None or kp.size == 0:
        return b"", 0, 0
    kp = np.ascontiguousarray(kp, np.float32)
    return kp.tobytes(), int(kp.shape[0]), int(kp.shape[1])


def render(handle: int, image_bytes: bytes, height: int, width: int,
           frame_id: int = 0) -> bytes:
    """Like process() but returns the rendered overlay frame (uint8 BGR)."""
    wrapper, lock = _get(handle)
    image = np.frombuffer(image_bytes, np.uint8).reshape(height, width, 3)
    with lock:
        datum = wrapper.process(image, frame_id)
        out = wrapper.render(datum)
    return np.ascontiguousarray(out, np.uint8).tobytes()


def destroy(handle: int) -> None:
    with _LOCK:
        _HANDLES.pop(handle, None)
        _HANDLE_LOCKS.pop(handle, None)
