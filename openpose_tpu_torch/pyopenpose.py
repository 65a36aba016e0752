"""Drop-in compatibility shim for the reference Python API (`pyopenpose`).

Mirrors python/openpose/openpose_python.cpp (module functions at 316-338,
WrapperPython at 81-214, Datum bindings at 375-410) so scripts written
against the original bindings port with an import change:

    # import pyopenpose as op
    from openpose_tpu_torch import pyopenpose as op

    params = {"model_folder": "models/", "net_resolution": "-1x368"}
    opWrapper = op.WrapperPython()
    opWrapper.configure(params)
    opWrapper.start()
    datum = op.Datum()
    datum.cvInputData = image_bgr
    opWrapper.emplaceAndPop(op.VectorDatum([datum]))
    print(datum.poseKeypoints)   # numpy [people, 25, 3]

Config keys follow the reference gflags names (openpose_python.cpp re-parses
the dict through gflags).  Unsupported keys raise with a clear message.

Counterpart of `openpose_tpu/pyopenpose.py` over the port's `Wrapper`, on
the card unless `WrapperPython` is given another `device`.  Unlike the
original, a datum is rendered only when `render_pose` (default 1) is
nonzero, as the CLI does; at 0 `cvOutputData` is the input frame, so no
OpenCV is needed.  `execute()` passes each param as one `--key=value`
token, so a value that starts with "-" (the default "-1x368") reaches the
CLI as a value.
"""

from __future__ import annotations

import collections
import enum
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from openpose_tpu_torch.params import PoseModel, POSE_MODEL_INFO

__all__ = [
    "Datum", "VectorDatum", "WrapperPython", "ThreadManagerMode",
    "Point", "Rectangle", "PoseModel",
    "init_int", "init_argv", "get_gpu_number", "get_images_on_directory",
    "getPoseBodyPartMapping", "getPoseNumberBodyParts", "getPosePartPairs",
    "getPoseMapIndex",
]


class Point:
    """op::Point<int> binding (openpose_python.cpp:418-424)."""

    def __init__(self, x: int = 0, y: int = 0):
        self.x, self.y = x, y

    def __repr__(self):
        return f"[{self.x}, {self.y}]"

    def __eq__(self, other):
        return (self.x, self.y) == (other.x, other.y)


class Rectangle:
    """op::Rectangle<float> binding (openpose_python.cpp:407-416)."""

    def __init__(self, x: float = 0.0, y: float = 0.0,
                 width: float = 0.0, height: float = 0.0):
        self.x, self.y, self.width, self.height = x, y, width, height

    def __repr__(self):
        return f"[{self.x}, {self.y}, {self.width}, {self.height}]"

    def __iter__(self):                 # unpacks like the tuple rects used
        return iter((self.x, self.y, self.width, self.height))


class ThreadManagerMode(enum.IntEnum):
    """include/openpose/thread/enumClasses.hpp:10-21."""

    Asynchronous = 0
    AsynchronousIn = 1
    AsynchronousOut = 2
    Synchronous = 3


class Datum:
    """Field-for-field mirror of the reference Datum bindings
    (openpose_python.cpp:375-405; include/openpose/core/datum.hpp:19-260).

    Keypoint arrays are numpy in input-image pixel coordinates; 3-D fields
    are filled by the 3-D reconstruction paths; geometry fields
    (scaleInputToNetInputs..scaleNetToOutput) are filled by emplaceAndPop.
    """

    def __init__(self):
        # ids / provenance (datum.hpp:24-45)
        self.id: int = 0
        self.subId: int = 0
        self.subIdMax: int = 0
        self.name: str = ""
        self.frameNumber: int = 0
        # input/output images (datum.hpp:47-95)
        self.cvInputData: Optional[np.ndarray] = None
        self.inputNetData: Optional[List[np.ndarray]] = None
        self.outputData: Optional[np.ndarray] = None
        self.cvOutputData: Optional[np.ndarray] = None
        self.cvOutputData3D: Optional[np.ndarray] = None
        # body (datum.hpp:97-136)
        self.poseKeypoints: Optional[np.ndarray] = None
        self.poseIds: Optional[np.ndarray] = None
        self.poseScores: Optional[np.ndarray] = None
        self.poseHeatMaps: Optional[np.ndarray] = None
        self.poseCandidates: Optional[List] = None
        # face (datum.hpp:138-160)
        self.faceRectangles: Optional[List] = None
        self.faceKeypoints: Optional[np.ndarray] = None
        self.faceHeatMaps: Optional[np.ndarray] = None
        # hands (datum.hpp:162-186)
        self.handRectangles: Optional[List] = None
        self.handKeypoints: List[Optional[np.ndarray]] = [None, None]
        self.handHeatMaps: List[Optional[np.ndarray]] = [None, None]
        # 3-D (datum.hpp:188-205)
        self.poseKeypoints3D: Optional[np.ndarray] = None
        self.faceKeypoints3D: Optional[np.ndarray] = None
        self.handKeypoints3D: List[Optional[np.ndarray]] = [None, None]
        self.cameraMatrix: Optional[np.ndarray] = None
        self.cameraExtrinsics: Optional[np.ndarray] = None
        self.cameraIntrinsics: Optional[np.ndarray] = None
        # net-output injection hook (datum.hpp:212-217)
        self.poseNetOutput: Optional[np.ndarray] = None
        # scale/size bookkeeping (datum.hpp:223-250)
        self.scaleInputToNetInputs: List[float] = []
        self.netInputSizes: List[Point] = []
        self.scaleInputToOutput: float = 1.0
        self.netOutputSize: Point = Point()
        self.scaleNetToOutput: float = 1.0
        self.elementRendered: tuple = (0, "")


def VectorDatum(datums: List[Datum]) -> List[Datum]:
    """The reference wraps datums in an opaque vector; a list works here."""
    return list(datums)


# ------------------------------------------------------------------ #
# Module-level init functions (openpose_python.cpp:33-59): the reference
# writes the dict/argv into gflags globals that a later configure() reads.
_GLOBAL_PARAMS: Dict = {}


def init_int(params: Dict) -> None:
    """Store params globally (the reference sets gflags from the dict)."""
    _GLOBAL_PARAMS.update(params)


def init_argv(argv: List[str]) -> None:
    """Parse ``--flag value`` / ``--flag`` argv pairs into global params."""
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            key = arg[2:]
            if "=" in key:
                key, value = key.split("=", 1)
                _GLOBAL_PARAMS[key] = value
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                _GLOBAL_PARAMS[key] = argv[i + 1]
                i += 1
            else:
                _GLOBAL_PARAMS[key] = True
        i += 1


def get_gpu_number() -> int:
    """CUDA devices visible to the process (getGpuNumber)."""
    return torch.cuda.device_count()


_IMAGE_EXTENSIONS = (".bmp", ".dib", ".pbm", ".pgm", ".ppm", ".sr", ".ras",
                     ".jpg", ".jpeg", ".png", ".tiff", ".tif")


def get_images_on_directory(directory_path: str) -> List[str]:
    """Sorted image paths in a directory (getImagesFromDirectory,
    utilities/fileSystem.cpp Extensions::Images)."""
    out = sorted(
        os.path.join(directory_path, f)
        for f in os.listdir(directory_path)
        if f.lower().endswith(_IMAGE_EXTENSIONS))
    return out


class WrapperPython:
    def __init__(self, mode: int = ThreadManagerMode.Asynchronous,
                 device: Union[str, torch.device, None] = None):
        """device: where the nets run; the card when None."""
        self._mode = ThreadManagerMode(mode)
        self._device = device
        self._params: Dict = {}
        self._wrapper = None
        self._id_extractor = None
        self._queue: "collections.deque[List[Datum]]" = collections.deque()

    def configure(self, params: Optional[Dict] = None) -> None:
        merged = dict(_GLOBAL_PARAMS)
        merged.update(params or {})
        self._params = merged

    def start(self) -> None:
        from openpose_tpu_torch.wrapper import (FaceConfig, HandConfig,
                                                PoseConfig, Wrapper)
        p = self._params

        def res(key, default):
            text = p.get(key, default)
            w, h = str(text).lower().split("x")
            return (int(w), int(h))

        model = PoseModel(p.get("model_pose", "BODY_25"))
        pose = PoseConfig(
            enable=bool(p.get("body", 1)),
            model=model,
            net_resolution=res("net_resolution", "-1x368"),
            scale_number=int(p.get("scale_number", 1)),
            scale_gap=float(p.get("scale_gap", 0.25)),
            maximize_positives=bool(p.get("maximize_positives", False)),
            caffemodel=p.get("caffemodel_path") or None,
            model_folder=p.get("model_folder") or None,
            number_people_max=int(p.get("number_people_max", -1)),
            part_candidates=bool(p.get("part_candidates", False)),
            render_threshold=float(p.get("render_threshold", 0.05)))
        face = FaceConfig(enable=bool(p.get("face", False)),
                          detector=int(p.get("face_detector", 0)),
                          caffemodel=p.get("face_caffemodel_path") or None)
        hand = HandConfig(enable=bool(p.get("hand", False)),
                          detector=int(p.get("hand_detector", 0)),
                          caffemodel=p.get("hand_caffemodel_path") or None,
                          scale_number=int(p.get("hand_scale_number", 1)),
                          scale_range=float(p.get("hand_scale_range", 0.4)))
        self._wrapper = Wrapper(pose=pose, face=face, hand=hand,
                                device=self._device)
        self._render = int(p.get("render_pose", 1)) != 0
        self._keep_heatmaps = any(
            bool(p.get(k)) for k in ("heatmaps_add_parts",
                                     "heatmaps_add_bkg",
                                     "heatmaps_add_PAFs"))
        if p.get("identification"):
            from openpose_tpu_torch.tracking.person_id import (
                PersonIdExtractor)
            self._id_extractor = PersonIdExtractor(
                device=self._wrapper.device)

    def stop(self) -> None:
        self._wrapper = None
        self._queue.clear()

    # -------------------------------------------------------------- #
    def _process_one(self, datum: Datum) -> None:
        if datum.cvInputData is None:
            raise ValueError("datum.cvInputData is empty")
        face_rects = ([tuple(r) for r in datum.faceRectangles]
                      if datum.faceRectangles else None)
        # handRectangles is a (left, right) Rectangle pair per person
        # (openpose_python.cpp / datum.hpp:166-172)
        hand_rects = ([(tuple(pair[0]), tuple(pair[1]))
                       for pair in datum.handRectangles]
                      if datum.handRectangles else None)
        d = self._wrapper.process(
            datum.cvInputData, datum.id, datum.name,
            keep_heatmaps=self._keep_heatmaps,
            face_rectangles=face_rects, hand_rectangles=hand_rects,
            pose_net_output=datum.poseNetOutput)
        datum.poseKeypoints = d.pose_keypoints
        datum.poseScores = d.pose_scores
        datum.poseCandidates = d.part_candidates
        datum.faceKeypoints = d.face_keypoints
        datum.faceRectangles = d.face_rectangles
        datum.handKeypoints = [d.hand_left_keypoints,
                               d.hand_right_keypoints]
        datum.handRectangles = d.hand_rectangles
        datum.frameNumber = datum.frameNumber or datum.id
        # geometry bookkeeping (datum.hpp:223-250)
        datum.scaleInputToNetInputs = list(d.scale_input_to_net)
        datum.netInputSizes = [Point(int(w), int(h))
                               for w, h in d.net_input_sizes]
        datum.netOutputSize = Point(*map(int, d.net_output_size))
        datum.scaleNetToOutput = d.scale_net_to_output
        datum.scaleInputToOutput = 1.0   # output = input resolution here
        if d.heatmaps is not None:
            # reference layout is CHW (poseHeatMaps, datum.hpp:117-126)
            datum.poseHeatMaps = np.ascontiguousarray(
                np.transpose(np.asarray(d.heatmaps), (2, 0, 1)))
        if self._id_extractor is not None and d.pose_keypoints is not None:
            datum.poseIds = self._id_extractor.extract_ids(
                d.pose_keypoints, datum.cvInputData)
        if self._render:
            datum.cvOutputData = self._wrapper.render(d)
            datum.elementRendered = (0, "pose")
        else:                       # the CLI's frame at --render_pose 0
            datum.cvOutputData = datum.cvInputData
        datum.outputData = datum.cvOutputData

    def emplaceAndPop(self, datums: List[Datum]) -> bool:
        """Synchronous process of one datum vector (openpose_python.cpp:221)."""
        if self._wrapper is None:
            raise RuntimeError("call start() before emplaceAndPop()")
        for datum in datums:
            self._process_one(datum)
        return True

    def waitAndEmplace(self, datums: List[Datum]) -> bool:
        """Queue a datum vector for processing (openpose_python.cpp:232)."""
        if self._wrapper is None:
            raise RuntimeError("call start() before waitAndEmplace()")
        self._queue.append(list(datums))
        return True

    def waitAndPop(self, datums: List[Datum]) -> bool:
        """Pop the oldest queued vector, processed, into `datums`
        (openpose_python.cpp:243).  Returns False when nothing is queued."""
        if self._wrapper is None:
            raise RuntimeError("call start() before waitAndPop()")
        if not self._queue:
            return False
        batch = self._queue.popleft()
        for datum in batch:
            self._process_one(datum)
        datums[:] = batch
        return True

    def execute(self) -> int:
        """Run the full CLI-style pipeline from the configured params until
        the producer is exhausted (the reference's WrapperPython::exec,
        openpose_python.cpp:205-214: blocks processing --image_dir/--video
        with all output writers).  Params map 1:1 to the CLI flag surface;
        returns the CLI exit code."""
        from openpose_tpu_torch import cli
        argv = []
        for key, value in self._params.items():
            flag = f"--{key}"
            if isinstance(value, bool):
                if value:
                    argv.append(flag)
            else:
                # one token: a value such as "-1x368" is not taken for a flag
                argv.append(f"{flag}={value}")
        return cli.main(argv, device=self._device)


# Model info helpers (openpose_python.cpp:60-80)
def getPoseBodyPartMapping(pose_model: str) -> Dict[int, str]:
    from openpose_tpu_torch import params as _p
    return {
        "BODY_25": dict(_p.BODY_25_PARTS),
        "COCO_18": dict(_p.COCO_18_PARTS),
        "MPI_15": dict(_p.MPI_15_PARTS),
        "MPI_15_4": dict(_p.MPI_15_PARTS),
    }[pose_model]


def getPoseNumberBodyParts(pose_model: str) -> int:
    return POSE_MODEL_INFO[PoseModel(pose_model)].num_parts


def getPosePartPairs(pose_model: str) -> List[int]:
    return list(POSE_MODEL_INFO[PoseModel(pose_model)].pairs)


def getPoseMapIndex(pose_model: str) -> List[int]:
    return list(POSE_MODEL_INFO[PoseModel(pose_model)].map_idx)


# PoseModel enum values are exported at module level like pybind's
# export_values() (openpose_python.cpp:330-337).
BODY_25 = PoseModel.BODY_25
COCO_18 = PoseModel.COCO_18
MPI_15 = PoseModel.MPI_15
MPI_15_4 = PoseModel.MPI_15_4
BODY_25B = PoseModel.BODY_25B
BODY_135 = PoseModel.BODY_135
