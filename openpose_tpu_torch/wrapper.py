"""User-facing facade: configure once, process frames (the reference's
WrapperT / WrapperStruct* API surface, include/openpose/wrapper/wrapper.hpp:36
and wrapperStruct{Pose,Face,Hand,Input,Output}.hpp) as plain dataclasses + a
Wrapper class with a synchronous `process()`.

Counterpart of `openpose_tpu/wrapper.py`: the same configs, `Datum` and
cascade, over the port's extractors.  The device work runs on the card
unless the caller names another `device`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.face.detector import detect_faces
from openpose_tpu_torch.face.extractor import FaceExtractor
from openpose_tpu_torch.hand.detector import detect_hands, track_hand
from openpose_tpu_torch.hand.extractor import HandExtractor
from openpose_tpu_torch.models import zoo
from openpose_tpu_torch.params import PoseModel
from openpose_tpu_torch.pose.extractor import PoseExtractor


@dataclasses.dataclass
class PoseConfig:
    """~ WrapperStructPose."""

    enable: bool = True
    model: PoseModel = PoseModel.BODY_25
    net_resolution: Tuple[int, int] = (-1, 368)   # (w, h); -1 = from aspect
    net_resolution_dynamic: float = 1.0           # ~ --net_resolution_dynamic:
                                                  # clip auto width to
                                                  # ratio*656*(h/368); <=0 off
    scale_number: int = 1
    scale_gap: float = 0.25
    maximize_positives: bool = False
    caffemodel: Optional[str] = None              # converted weights source
    model_folder: Optional[str] = None            # ~ --model_folder layout
    prototxt: Optional[str] = None                # ~ --prototxt_path override
    compute_dtype: str = "bfloat16"
    number_people_max: int = -1                   # ~ --number_people_max
    render_threshold: float = 0.05
    alpha_keypoint: float = 1.0                   # ~ --alpha_pose (blending)
    blend_original: bool = True                   # ~ !--disable_blending
    tracking: int = -1                            # ~ --tracking: CNN every
                                                  # N+1 frames, LK in between
    part_candidates: bool = False                 # ~ --part_candidates
    top_down_refinement: bool = False             # ~ reference compile-time
                                                  # TOP_DOWN_REFINEMENT pass


@dataclasses.dataclass
class FaceConfig:
    """~ WrapperStructFace."""

    enable: bool = False
    caffemodel: Optional[str] = None
    net_resolution: int = 368                     # ~ --face_net_resolution
    # ~ --face_detector (flags.hpp:143): 0 body-keypoint geometry,
    # 1 OpenCV Haar cascade, 2 rectangles provided by the caller
    # (process(face_rectangles=...)), 3 invalid for face
    detector: int = 0
    detector_threshold: float = 0.25
    render_threshold: float = 0.4
    # ~ --face_render: -1 follow render_pose, 0 none, >0 render
    render: int = -1
    alpha_keypoint: float = 1.0                   # ~ --face_alpha_pose


@dataclasses.dataclass
class HandConfig:
    """~ WrapperStructHand."""

    enable: bool = False
    caffemodel: Optional[str] = None
    net_resolution: int = 368                     # ~ --hand_net_resolution
    scale_number: int = 1
    scale_range: float = 0.4
    tracking: bool = False
    # ~ --hand_detector: 0 body geometry, 2 provided rectangles,
    # 3 body geometry + previous-frame tracking (same as tracking=True)
    detector: int = 0
    detector_threshold: float = 0.03
    render_threshold: float = 0.2
    # ~ --hand_render: -1 follow render_pose, 0 none, >0 render
    render: int = -1
    alpha_keypoint: float = 1.0                   # ~ --hand_alpha_pose


@dataclasses.dataclass
class Datum:
    """The unit of pipeline data (reference include/openpose/core/datum.hpp:19).

    All keypoints are in input-image pixel coordinates.
    """

    id: int = 0
    sub_id: int = 0
    name: str = ""
    frame: Optional[np.ndarray] = None
    pose_keypoints: Optional[np.ndarray] = None       # [P, parts, 3]
    pose_scores: Optional[np.ndarray] = None          # [P]
    part_candidates: Optional[List[np.ndarray]] = None  # per part [k, 3]
    pose_ids: Optional[np.ndarray] = None             # [P] person ids
    face_rectangles: Optional[List] = None
    face_keypoints: Optional[np.ndarray] = None       # [P, 70, 3]
    hand_rectangles: Optional[List] = None
    hand_left_keypoints: Optional[np.ndarray] = None  # [P, 21, 3]
    hand_right_keypoints: Optional[np.ndarray] = None
    pose_keypoints_3d: Optional[np.ndarray] = None    # [P, parts, 4]
    face_keypoints_3d: Optional[np.ndarray] = None
    hand_left_keypoints_3d: Optional[np.ndarray] = None
    hand_right_keypoints_3d: Optional[np.ndarray] = None
    heatmaps: Optional[np.ndarray] = None
    camera_matrix: Optional[np.ndarray] = None        # [3, 4] for 3-D views
    output_frame: Optional[np.ndarray] = None
    # Scale/size bookkeeping (datum.hpp:223-250)
    scale_input_to_net: tuple = ()                    # per scale
    net_input_sizes: tuple = ()                       # per scale (w, h)
    net_output_size: tuple = (0, 0)                   # (w, h)
    scale_net_to_output: float = 1.0


class Wrapper:
    """Synchronous single-process wrapper around the extractors."""

    def __init__(self, pose: Optional[PoseConfig] = None,
                 face: Optional[FaceConfig] = None,
                 hand: Optional[HandConfig] = None,
                 profiler=None,
                 device: Union[str, torch.device, None] = None):
        """Each config defaults to a fresh instance and is copied: a Wrapper
        never writes into a config object that a caller, or another
        Wrapper, holds.  device: the card when None (`device.resolve`)."""
        self.device = device_rule.resolve(device)
        pose = dataclasses.replace(pose) if pose else PoseConfig()
        face = dataclasses.replace(face) if face else FaceConfig()
        hand = dataclasses.replace(hand) if hand else HandConfig()
        if hand.detector == 3:              # flags.hpp:146 hand tracking mode
            hand.tracking = True
        self.pose_cfg = pose
        self.face_cfg = face
        self.hand_cfg = hand
        # per-stage keyed timers (reference Profiler wraps each worker's
        # work(); include/openpose/utilities/profiler.hpp:66-100)
        self.profiler = profiler
        dtype = torch.bfloat16 if pose.compute_dtype == "bfloat16" \
            else torch.float32

        self.pose_extractor: Optional[PoseExtractor] = None
        self._pose_tracker = None
        self._prev_pose_scores: Optional[np.ndarray] = None
        if pose.enable:
            model = zoo.load_pose_model(pose.model, device=self.device,
                                        caffemodel=pose.caffemodel,
                                        model_folder=pose.model_folder,
                                        prototxt=pose.prototxt)
            self.pose_extractor = PoseExtractor(
                model, maximize_positives=pose.maximize_positives,
                compute_dtype=dtype, device=self.device)
            if pose.tracking >= 0:
                from openpose_tpu_torch.tracking.tracker import PersonTracker
                self._pose_tracker = PersonTracker(device=self.device)
        self.face_extractor: Optional[FaceExtractor] = None
        if face.enable:
            self.face_extractor = FaceExtractor(
                zoo.load_face_model(device=self.device,
                                    caffemodel=face.caffemodel,
                                    model_folder=pose.model_folder),
                net_size=face.net_resolution, compute_dtype=dtype,
                device=self.device)
        self.hand_extractor: Optional[HandExtractor] = None
        if hand.enable:
            self.hand_extractor = HandExtractor(
                zoo.load_hand_model(device=self.device,
                                    caffemodel=hand.caffemodel,
                                    model_folder=pose.model_folder),
                net_size=hand.net_resolution, compute_dtype=dtype,
                scale_number=hand.scale_number, scale_range=hand.scale_range,
                device=self.device)
        self._prev_hand_rects: List = []
        # Haar-cascade face detection: explicit --face_detector 1, or the
        # reference's automatic fallback when body is disabled
        # (FaceDetectorOpenCV, wrapperAuxiliary.hpp face-detector choice).
        self._haar_detector = None
        if face.enable and (face.detector == 1 or not pose.enable):
            from openpose_tpu_torch.face.haar import FaceDetectorOpenCV
            self._haar_detector = FaceDetectorOpenCV(
                model_folder=pose.model_folder)

    # ------------------------------------------------------------------ #
    def process(self, image: np.ndarray, datum_id: int = 0,
                name: str = "", keep_heatmaps: bool = False,
                face_rectangles: Optional[List] = None,
                hand_rectangles: Optional[List] = None,
                pose_net_output: Optional[np.ndarray] = None) -> Datum:
        """Full cascade on one BGR frame.

        keep_heatmaps: expose the merged net output on datum.heatmaps (the
        reference's --heatmaps_add_* copy-out) at zero extra device cost.
        face_rectangles / hand_rectangles: caller-provided detections for
        detector mode 2 (the reference's Datum::faceRectangles /
        handRectangles injection, e.g. examples 07/08).
        pose_net_output: optional [h/8, w/8, C] tensor substituted for the
        CNN output (Datum::poseNetOutput, datum.hpp:212-217).
        """
        datum = Datum(id=datum_id, name=name, frame=image)
        prof = self.profiler
        if self.pose_extractor is not None:
            if prof is not None:
                prof.timer_init("pose")
            # Tracking stride (reference: poseExtractor.cpp:46-49): run the
            # CNN on every (tracking+1)-th frame, LK-propagate in between.
            run_cnn = (self._pose_tracker is None
                       or datum_id % (self.pose_cfg.tracking + 1) == 0)
            if run_cnn:
                pred = self.pose_extractor.forward(
                    image, self.pose_cfg.net_resolution,
                    self.pose_cfg.scale_number, self.pose_cfg.scale_gap,
                    keep_heatmaps=keep_heatmaps,
                    net_output=pose_net_output,
                    net_resolution_dynamic=self.pose_cfg.net_resolution_dynamic)
                kp, sc = pred.keypoints, pred.scores
                datum.scale_input_to_net = pred.scale_input_to_net
                datum.net_input_sizes = pred.net_input_sizes
                datum.net_output_size = pred.net_output_size
                datum.scale_net_to_output = pred.scale_net_to_output
                if self.pose_cfg.top_down_refinement and kp.shape[0]:
                    from openpose_tpu_torch.pose.refine import refine_prediction
                    pred = refine_prediction(self.pose_extractor, image,
                                             pred)
                    kp, sc = pred.keypoints, pred.scores
                if keep_heatmaps:
                    datum.heatmaps = pred.heatmaps
                if self.pose_cfg.part_candidates and pred.peaks is not None:
                    # All NMS candidates per part, scaled to input pixels
                    # (reference: --part_candidates, poseExtractorNet
                    # getCandidatesCopy semantics).
                    s = pred.scale_net_to_output
                    cands = []
                    for part in range(self.pose_extractor.info.num_parts):
                        k = int(pred.peaks[part, 0, 0])
                        c = pred.peaks[part, 1:k + 1].copy()
                        c[:, :2] *= s
                        cands.append(c)
                    datum.part_candidates = cands
                if self._pose_tracker is not None:
                    self._pose_tracker.observe(kp, image)
                    self._prev_pose_scores = sc
            else:
                kp = self._pose_tracker.track(image)
                sc = self._prev_pose_scores
                if sc is None or sc.shape[0] != kp.shape[0]:
                    sc = np.zeros((kp.shape[0],), np.float32)
            nmax = self.pose_cfg.number_people_max
            if nmax > 0 and kp.shape[0] > nmax:
                order = np.argsort(-sc)[:nmax]   # KeepTopNPeople
                kp, sc = kp[order], sc[order]
            datum.pose_keypoints, datum.pose_scores = kp, sc
            if prof is not None:
                prof.timer_end("pose")

        # Detector mode 2: rectangles provided by the caller.
        if self.face_extractor is not None and self.face_cfg.detector == 2:
            rects = [tuple(r) for r in (face_rectangles or [])]
            datum.face_rectangles = rects
            if rects:
                datum.face_keypoints = self.face_extractor.forward(
                    image.astype(np.float32), rects)
        elif self._haar_detector is not None \
                and self.face_extractor is not None:
            rects = [tuple(r) for r in self._haar_detector.detect_faces(image)]
            datum.face_rectangles = rects
            if rects:
                datum.face_keypoints = self.face_extractor.forward(
                    image.astype(np.float32), rects)

        if self.hand_extractor is not None and self.hand_cfg.detector == 2:
            rects = [tuple(r) for r in (hand_rectangles or [])]
            datum.hand_rectangles = rects
            if rects:
                left, right = self.hand_extractor.forward(
                    image.astype(np.float32), rects)
                datum.hand_left_keypoints = left
                datum.hand_right_keypoints = right

        people_kp = datum.pose_keypoints
        if people_kp is not None and people_kp.size:
            if self.face_extractor is not None and self.face_cfg.detector == 0 \
                    and self._haar_detector is None:
                if prof is not None:
                    prof.timer_init("face")
                datum.face_rectangles = detect_faces(
                    people_kp, self.pose_cfg.model,
                    self.face_cfg.detector_threshold)
                datum.face_keypoints = self.face_extractor.forward(
                    image.astype(np.float32), datum.face_rectangles)
                if prof is not None:
                    prof.timer_end("face")
            if self.hand_extractor is not None \
                    and self.hand_cfg.detector in (0, 3):
                if prof is not None:
                    prof.timer_init("hand")
                rects = detect_hands(people_kp, self.pose_cfg.model,
                                     self.hand_cfg.detector_threshold)
                if self.hand_cfg.tracking and self._prev_hand_rects:
                    rects = [
                        (track_hand(l, [p[0] for p in self._prev_hand_rects]),
                         track_hand(r, [p[1] for p in self._prev_hand_rects]))
                        for l, r in rects]
                datum.hand_rectangles = rects
                left, right = self.hand_extractor.forward(
                    image.astype(np.float32), rects)
                datum.hand_left_keypoints = left
                datum.hand_right_keypoints = right
                self._prev_hand_rects = rects
                if prof is not None:
                    prof.timer_end("hand")
        return datum

    # ------------------------------------------------------------------ #
    def render(self, datum: Datum) -> np.ndarray:
        """Overlay skeletons on a copy of the frame."""
        from openpose_tpu_torch.render import render as r
        frame = (datum.frame.copy() if self.pose_cfg.blend_original
                 else np.zeros_like(datum.frame))
        if datum.pose_keypoints is not None:
            r.render_pose(frame, datum.pose_keypoints, self.pose_cfg.model,
                          self.pose_cfg.render_threshold,
                          alpha=self.pose_cfg.alpha_keypoint)
        # face_render / hand_render: -1 follows the pose render mode, 0 off
        # (flags.hpp:211,217)
        if datum.face_keypoints is not None and self.face_cfg.render != 0:
            r.render_face(frame, datum.face_keypoints,
                          self.face_cfg.render_threshold,
                          alpha=self.face_cfg.alpha_keypoint)
        if (datum.hand_left_keypoints is not None
                or datum.hand_right_keypoints is not None) \
                and self.hand_cfg.render != 0:
            r.render_hands(frame, datum.hand_left_keypoints,
                           datum.hand_right_keypoints,
                           self.hand_cfg.render_threshold,
                           alpha=self.hand_cfg.alpha_keypoint)
        datum.output_frame = frame
        return frame
