"""Model-zoo parameters: part names, limb pairs, PAF map indices, thresholds.

Re-derivation of the reference's model parameter tables
(reference: src/openpose/pose/poseParameters.cpp:7-757 and
include/openpose/pose/poseParametersRender.hpp:16-115). Only the supported
production models are included (BODY_25, COCO_18, MPI_15, MPI_15_4); the
reference's experimental variants (BODY_19*/23/25B/D/E/135, CAR_*) have no
published weights and are intentionally out of scope (documented in README).

The port's own copy of `openpose_tpu/params.py` (host code, no framework):
the port imports nothing of the JAX package, and
`tests/test_torch_standalone.py` holds the two copies to each other.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Tuple

# Reference: include/openpose/pose/poseParameters.hpp:11-14.  127 = 32*4 - 1
# (OpenCL alignment in the reference; we keep the value for parity of outputs).
POSE_MAX_PEOPLE = 127


class PoseModel(enum.Enum):
    """Supported pose models (reference: include/openpose/pose/enumClasses.hpp:9-30).

    The first four are the models the reference ships weights/prototxts
    for; the rest are the reference's experimental enum values, exposed for
    API parity but without bundled topologies (the reference's own tables
    carry placeholder paths for them, poseParameters.cpp:377-391) —
    selecting one raises with guidance to --prototxt_path, which loads any
    custom Caffe topology."""

    BODY_25 = "BODY_25"
    COCO_18 = "COCO_18"
    MPI_15 = "MPI_15"
    MPI_15_4 = "MPI_15_4"
    # experimental (enumClasses.hpp:14-29): no shipped weights anywhere
    BODY_19 = "BODY_19"
    BODY_19_X2 = "BODY_19_X2"
    BODY_19N = "BODY_19N"
    BODY_19E = "BODY_19E"
    BODY_25B = "BODY_25B"
    BODY_25D = "BODY_25D"
    BODY_25E = "BODY_25E"
    BODY_23 = "BODY_23"
    BODY_135 = "BODY_135"
    CAR_12 = "CAR_12"
    CAR_22 = "CAR_22"

    @property
    def experimental(self) -> bool:
        return self not in (PoseModel.BODY_25, PoseModel.COCO_18,
                            PoseModel.MPI_15, PoseModel.MPI_15_4)


# Part name tables (reference: src/openpose/pose/poseParameters.cpp:7-73).
BODY_25_PARTS: Dict[int, str] = {
    0: "Nose", 1: "Neck", 2: "RShoulder", 3: "RElbow", 4: "RWrist",
    5: "LShoulder", 6: "LElbow", 7: "LWrist", 8: "MidHip", 9: "RHip",
    10: "RKnee", 11: "RAnkle", 12: "LHip", 13: "LKnee", 14: "LAnkle",
    15: "REye", 16: "LEye", 17: "REar", 18: "LEar", 19: "LBigToe",
    20: "LSmallToe", 21: "LHeel", 22: "RBigToe", 23: "RSmallToe", 24: "RHeel",
    25: "Background",
}

COCO_18_PARTS: Dict[int, str] = {
    0: "Nose", 1: "Neck", 2: "RShoulder", 3: "RElbow", 4: "RWrist",
    5: "LShoulder", 6: "LElbow", 7: "LWrist", 8: "RHip", 9: "RKnee",
    10: "RAnkle", 11: "LHip", 12: "LKnee", 13: "LAnkle", 14: "REye",
    15: "LEye", 16: "REar", 17: "LEar", 18: "Background",
}

MPI_15_PARTS: Dict[int, str] = {
    0: "Head", 1: "Neck", 2: "RShoulder", 3: "RElbow", 4: "RWrist",
    5: "LShoulder", 6: "LElbow", 7: "LWrist", 8: "RHip", 9: "RKnee",
    10: "RAnkle", 11: "LHip", 12: "LKnee", 13: "LAnkle", 14: "Chest",
    15: "Background",
}

# Face: 70 keypoints; Hand: 21 keypoints (reference: models/face/pose_deploy.prototxt
# final 71 ch = 70 parts + bkg; models/hand/pose_deploy.prototxt 22 ch = 21 + bkg).
FACE_NUMBER_PARTS = 70
HAND_NUMBER_PARTS = 21

# Limb pair lists (part index pairs scored against the PAF channels).
# Reference: src/openpose/pose/poseParameters.cpp:416-422 (POSE_BODY_PART_PAIRS).
_BODY_25_PAIRS = (
    1, 8, 1, 2, 1, 5, 2, 3, 3, 4, 5, 6, 6, 7, 8, 9, 9, 10, 10, 11, 8, 12,
    12, 13, 13, 14, 1, 0, 0, 15, 15, 17, 0, 16, 16, 18, 2, 17, 5, 18,
    14, 19, 19, 20, 14, 21, 11, 22, 22, 23, 11, 24,
)
_COCO_18_PAIRS = (
    1, 2, 1, 5, 2, 3, 3, 4, 5, 6, 6, 7, 1, 8, 8, 9, 9, 10, 1, 11, 11, 12,
    12, 13, 1, 0, 0, 14, 14, 16, 0, 15, 15, 17, 2, 16, 5, 17,
)
# MPI uses the render pairs for connection too (POSE_MPI_PAIRS_RENDER_GPU,
# reference: include/openpose/pose/poseParametersRender.hpp:70-71).
_MPI_15_PAIRS = (
    0, 1, 1, 2, 2, 3, 3, 4, 1, 5, 5, 6, 6, 7, 1, 14, 14, 8, 8, 9, 9, 10,
    14, 11, 11, 12, 12, 13,
)

# PAF channel index map: for pair k, the X/Y PAF channels are
# map_idx[2k], map_idx[2k+1] offset by (#parts + bkg) in the net output tensor.
# Reference: src/openpose/pose/poseParameters.cpp:253-279 (POSE_MAP_INDEX).
_BODY_25_MAP_IDX = (
    0, 1, 14, 15, 22, 23, 16, 17, 18, 19, 24, 25, 26, 27, 6, 7, 2, 3, 4, 5,
    8, 9, 10, 11, 12, 13, 30, 31, 32, 33, 36, 37, 34, 35, 38, 39, 20, 21,
    28, 29, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
)
_COCO_18_MAP_IDX = (
    12, 13, 20, 21, 14, 15, 16, 17, 22, 23, 24, 25, 0, 1, 2, 3, 4, 5, 6, 7,
    8, 9, 10, 11, 28, 29, 30, 31, 34, 35, 32, 33, 36, 37, 18, 19, 26, 27,
)
_MPI_15_MAP_IDX = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27,
)

# Render pairs differ from connection pairs for BODY_25/COCO (no ear-shoulder
# links; reference: include/openpose/pose/poseParametersRender.hpp:16-47).
_BODY_25_RENDER_PAIRS = (
    1, 8, 1, 2, 1, 5, 2, 3, 3, 4, 5, 6, 6, 7, 8, 9, 9, 10, 10, 11, 8, 12,
    12, 13, 13, 14, 1, 0, 0, 15, 15, 17, 0, 16, 16, 18,
    14, 19, 19, 20, 14, 21, 11, 22, 22, 23, 11, 24,
)
_COCO_18_RENDER_PAIRS = (
    1, 2, 1, 5, 2, 3, 3, 4, 5, 6, 6, 7, 1, 8, 8, 9, 9, 10, 1, 11, 11, 12,
    12, 13, 1, 0, 0, 14, 14, 16, 0, 15, 15, 17,
)

# Keypoint colors, RGB triples per part (reference render color tables,
# include/openpose/pose/poseParametersRender.hpp:19-115; stored as (R,G,B)).
BODY_25_COLORS = (
    (255, 0, 85), (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
    (170, 255, 0), (85, 255, 0), (0, 255, 0), (255, 0, 0), (0, 255, 85),
    (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255), (0, 0, 255),
    (255, 0, 170), (170, 0, 255), (255, 0, 255), (85, 0, 255), (0, 0, 255),
    (0, 0, 255), (0, 0, 255), (0, 255, 255), (0, 255, 255), (0, 255, 255),
)
COCO_18_COLORS = (
    (255, 0, 85), (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
    (170, 255, 0), (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170),
    (0, 255, 255), (0, 170, 255), (0, 85, 255), (0, 0, 255), (255, 0, 170),
    (170, 0, 255), (255, 0, 255), (85, 0, 255),
)
MPI_15_COLORS = (
    (255, 0, 85), (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
    (170, 255, 0), (85, 255, 0), (43, 255, 0), (0, 255, 0), (0, 255, 85),
    (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255), (0, 0, 255),
)


@dataclasses.dataclass(frozen=True)
class PoseModelInfo:
    """Static description of one pose model family."""

    name: str
    num_parts: int
    has_background: bool
    pairs: Tuple[int, ...]           # flattened (A, B) part-index pairs
    map_idx: Tuple[int, ...]         # flattened PAF channel indices (pre-offset)
    render_pairs: Tuple[int, ...]
    colors: Tuple[Tuple[int, int, int], ...]
    stride: int = 8                  # net output stride (poseParameters.cpp:630-641)
    spec: str = ""                   # topology spec name in models/specs/

    @property
    def num_pairs(self) -> int:
        return len(self.pairs) // 2

    @property
    def heatmap_channels(self) -> int:
        """Total net-output channels: parts + bkg + 2*PAF-pairs-channels."""
        return self.num_parts + (1 if self.has_background else 0) + len(self.map_idx)

    @property
    def paf_channel_offset(self) -> int:
        """Offset of PAF channels in net output (= parts + background)."""
        return self.num_parts + (1 if self.has_background else 0)


POSE_MODEL_INFO: Dict[PoseModel, PoseModelInfo] = {
    PoseModel.BODY_25: PoseModelInfo(
        name="BODY_25", num_parts=25, has_background=True,
        pairs=_BODY_25_PAIRS, map_idx=_BODY_25_MAP_IDX,
        render_pairs=_BODY_25_RENDER_PAIRS, colors=BODY_25_COLORS,
        spec="body_25"),
    PoseModel.COCO_18: PoseModelInfo(
        name="COCO_18", num_parts=18, has_background=True,
        pairs=_COCO_18_PAIRS, map_idx=_COCO_18_MAP_IDX,
        render_pairs=_COCO_18_RENDER_PAIRS, colors=COCO_18_COLORS,
        spec="coco_18"),
    PoseModel.MPI_15: PoseModelInfo(
        name="MPI_15", num_parts=15, has_background=True,
        pairs=_MPI_15_PAIRS, map_idx=_MPI_15_MAP_IDX,
        render_pairs=_MPI_15_PAIRS, colors=MPI_15_COLORS,
        spec="mpi_15"),
    PoseModel.MPI_15_4: PoseModelInfo(
        name="MPI_15_4", num_parts=15, has_background=True,
        pairs=_MPI_15_PAIRS, map_idx=_MPI_15_MAP_IDX,
        render_pairs=_MPI_15_PAIRS, colors=MPI_15_COLORS,
        spec="mpi_15_4"),
}


@dataclasses.dataclass(frozen=True)
class ConnectParams:
    """Default grouping thresholds (reference: poseParameters.cpp:677-756)."""

    nms_threshold: float
    inter_min_above_threshold: float
    inter_threshold: float
    min_subset_cnt: int
    min_subset_score: float


def default_connect_params(model: PoseModel, maximize_positives: bool = False) -> ConnectParams:
    """Reference: getPoseDefault* in src/openpose/pose/poseParameters.cpp:677-756."""
    if model == PoseModel.MPI_15:
        nms = 0.6
    elif model == PoseModel.MPI_15_4:
        nms = 0.3
    else:
        nms = 0.02 if maximize_positives else 0.05
    inter_thresh = (
        0.01 if model in (PoseModel.MPI_15, PoseModel.MPI_15_4)
        else (0.01 if maximize_positives else 0.05))
    return ConnectParams(
        nms_threshold=nms,
        inter_min_above_threshold=0.75 if maximize_positives else 0.95,
        inter_threshold=inter_thresh,
        min_subset_cnt=2 if maximize_positives else 3,
        min_subset_score=0.05 if maximize_positives else 0.4,
    )


# Face/hand decode thresholds (reference: faceExtractorCaffe.cpp / handExtractorCaffe.cpp
# use a 0.5 confidence threshold on the per-channel argmax score only for rendering;
# keypoints are emitted regardless).
FACE_NET_RESOLUTION = (368, 368)
HAND_NET_RESOLUTION = (368, 368)
