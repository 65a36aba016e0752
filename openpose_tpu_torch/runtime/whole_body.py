"""Whole body (pose + face + both hands) over a frame batch on one GPU, or
over a device mesh.

Counterpart of `openpose_tpu/runtime/whole_body.py::ShardedWholeBody`:

  frames [B, H, W, 3] uint8 on the device
    -> body stage (`PoseInference`: per-scale resize -> CNN -> merge -> NMS
       -> PAF scoring)
    -> host: greedy assembly, KeepTopNPeople, face and hand rectangles
       (`face/detector.py`, `hand/detector.py`)
    -> face stage (`TopDownInference`: batched crop -> CNN -> argmax)
    -> hand stage (the same; left hands mirrored)
    -> host: crop keypoints mapped back to frame pixels.

With a `mesh` the body, face and hand stages share it: every rank calls
with its own rows of the global batch (`local_rows`), and the host
assembly, KeepTopNPeople and the map-back run on each rank for its own
frames.

Each stage is a span (`utils/profiler.py::TRACE`, off unless turned on):
`wholebody.body`, `wholebody.face`, `wholebody.hand`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from openpose_tpu_torch.face.detector import detect_faces
from openpose_tpu_torch.hand.detector import detect_hands
from openpose_tpu_torch.models.zoo import Model
from openpose_tpu_torch.parallel.inference import (
    PoseInference, TopDownInference)
from openpose_tpu_torch.params import (
    FACE_NUMBER_PARTS, HAND_NUMBER_PARTS, PoseModel)
from openpose_tpu_torch.utils.profiler import TRACE


@dataclasses.dataclass
class WholeBodyResult:
    """Per-frame whole-body keypoints, all in frame pixel coordinates."""

    pose_keypoints: np.ndarray          # [people, parts, 3]
    pose_scores: np.ndarray             # [people]
    face_keypoints: Optional[np.ndarray] = None        # [people, 70, 3]
    hand_left_keypoints: Optional[np.ndarray] = None   # [people, 21, 3]
    hand_right_keypoints: Optional[np.ndarray] = None  # [people, 21, 3]


class WholeBodyInference:
    """Batched whole-body cascade on one device, or on this rank's rows
    over a mesh."""

    def __init__(self, pose_model: Model,
                 face_model: Optional[Model] = None,
                 hand_model: Optional[Model] = None,
                 frame_hw: Optional[Tuple[int, int]] = (368, 656),
                 net_hw: Tuple[int, int] = (368, 656),
                 people_cap: int = 8,
                 scale_number: int = 1, scale_gap: float = 0.25,
                 max_peaks: int = 127,
                 face_net_size: int = 368, hand_net_size: int = 368,
                 device: Union[str, torch.device, None] = None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 mesh=None, **body_kwargs):
        """body_kwargs go to the body's `PoseInference` (thresholds,
        net_bypass; a net_bypass body needs frame_hw=None).  mesh: one
        `parallel.mesh.make_mesh` mesh for all three stages."""
        self.people_cap = people_cap
        self.body = PoseInference(
            pose_model, net_hw=net_hw, device=device, max_peaks=max_peaks,
            compute_dtype=compute_dtype, scale_number=scale_number,
            scale_gap=scale_gap, frame_hw=frame_hw, mesh=mesh, **body_kwargs)
        self.device, self.mesh = self.body.device, mesh
        self.local_rows = self.body.local_rows
        self.face = TopDownInference(
            face_model, face_net_size, people_cap, self.device,
            compute_dtype, mesh) if face_model is not None else None
        # hands: 2 crops per person (left mirrored, then right)
        self.hand = TopDownInference(
            hand_model, hand_net_size, 2 * people_cap, self.device,
            compute_dtype, mesh) if hand_model is not None else None
        self._pose_enum = PoseModel(pose_model.info.name)

    def __call__(self, frames: Union[np.ndarray, torch.Tensor],
                 net_output=None) -> List[WholeBodyResult]:
        """frames [B, H, W, 3] BGR uint8 (this rank's rows over a mesh).
        net_output: optional
        [B, net_h/8, net_w/8, C] injected in place of the body CNN (needs a
        net_bypass body); the face and hand stages still crop `frames`
        around the people assembled from it."""
        frames = torch.as_tensor(frames).to(self.device, non_blocking=True)
        results = self.body_stage(frames, net_output)
        self.face_stage(frames, results)
        self.hand_stage(frames, results)
        return results

    def body_stage(self, frames: torch.Tensor,
                   net_output=None) -> List[WholeBodyResult]:
        """Body net, fetch, assembly and KeepTopNPeople per frame."""
        with TRACE.span("wholebody.body"):
            return self._body_stage(frames, net_output)

    def _body_stage(self, frames: torch.Tensor,
                    net_output) -> List[WholeBodyResult]:
        if net_output is not None:
            if not self.body.net_bypass:
                raise ValueError("net_output injection needs a "
                                 "net_bypass=True body stage")
            out = self.body(net_output)
        else:
            out = self.body(frames)
        peaks, scores = self.body.fetch(*out)
        results = []
        for i in range(frames.shape[0]):
            kp, person_scores = self.body.assemble(peaks[i], scores[i])
            if kp.shape[0] > self.people_cap:
                # KeepTopNPeople (src/openpose/core/keepTopNPeople.cpp)
                order = np.argsort(person_scores)[::-1][:self.people_cap]
                kp, person_scores = kp[order], person_scores[order]
            results.append(WholeBodyResult(kp, person_scores))
        return results

    def face_rects(self, pose_keypoints: np.ndarray) -> List[tuple]:
        """(rect, mirror) per face crop of one frame's people."""
        return [(r, False) for r in
                detect_faces(pose_keypoints, self._pose_enum)]

    def hand_rects(self, pose_keypoints: np.ndarray) -> List[tuple]:
        """(rect, mirror) per hand crop: (left, mirrored), then right, for
        each person."""
        flat = []
        for left, right in detect_hands(pose_keypoints, self._pose_enum):
            flat += [(left, True), (right, False)]
        return flat

    def face_stage(self, frames: torch.Tensor,
                   results: List[WholeBodyResult]) -> None:
        if self.face is None:
            return
        with TRACE.span("wholebody.face"):
            rects = [self.face_rects(r.pose_keypoints) for r in results]
            for res, kp in zip(results, self.face.extract(
                    frames, rects, FACE_NUMBER_PARTS)):
                res.face_keypoints = kp

    def hand_stage(self, frames: torch.Tensor,
                   results: List[WholeBodyResult]) -> None:
        if self.hand is None:
            return
        with TRACE.span("wholebody.hand"):
            rects = [self.hand_rects(r.pose_keypoints) for r in results]
            for res, kp in zip(results, self.hand.extract(
                    frames, rects, HAND_NUMBER_PARTS)):
                # interleaved (left, right) per person
                res.hand_left_keypoints = kp[0::2]
                res.hand_right_keypoints = kp[1::2]
