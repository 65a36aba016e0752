"""Pose extraction pipeline: image -> people keypoints.

Counterpart of `openpose_tpu/pose/extractor.py`.  Device side, per frame:
per-scale resize + normalize -> CNN -> resize-and-merge of the part
channels -> NMS -> PAF pair scoring (a CUDA kernel on a card: the fused
scorer above 32 peaks, the sampler below).  Host side:
greedy people assembly (`ops/assembly.py`).  The decode and the assembly
are `BodyDecoder`'s, which the batched `parallel/inference.py::PoseInference`
shares.  Geometry follows PoseExtractorCaffe::forwardPass: the merge
target is the scale-0 net input size, and the NMS offset is
0.5 / scale_net_to_output.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.io import json_io
from openpose_tpu_torch.models.zoo import Model
from openpose_tpu_torch.ops import assembly, nms, paf, resize
from openpose_tpu_torch.params import (
    POSE_MAX_PEOPLE, ConnectParams, PoseModel, default_connect_params)
from openpose_tpu_torch.pose import scaler


@dataclasses.dataclass
class PosePrediction:
    """Keypoints in input-image pixel coordinates."""

    keypoints: np.ndarray          # [people, parts, 3] (x, y, score)
    scores: np.ndarray             # [people]
    heatmaps: Optional[np.ndarray] = None   # [h, w, C] merged low-res, all
    #                                         channels (parts + bkg + PAFs)
    # [parts, K+1, 3] in net-output px: the resize-and-merge grid of size
    # net_output_size (the scale-0 net input), before scale_net_to_output
    peaks: Optional[np.ndarray] = None
    scale_net_to_output: float = 1.0
    net_output_size: Tuple[int, int] = (0, 0)   # (w, h)
    scale_input_to_net: Tuple[float, ...] = ()
    net_input_sizes: Tuple[Tuple[int, int], ...] = ()   # [(w, h), ...]

    def people_json(self) -> dict:
        """The frame's people JSON (`io/json_io.py` schema)."""
        return json_io.people_json(pose_keypoints=self.keypoints)


def _no_stage(name):
    return contextlib.nullcontext()


def net_to_output_scale(plan: scaler.ScalePlan,
                        input_wh: Tuple[int, int]) -> float:
    """Net-output px -> input px (poseExtractorCaffe.cpp:306-311): the
    input's size at scale 0, back to the input; 1 where the input already
    has the net's size."""
    s0 = plan.scale_input_to_net[0]
    net_size = (int(s0 * input_wh[0] + 0.5), int(s0 * input_wh[1] + 0.5))
    return scaler.resize_get_scale_factor(net_size, input_wh)


class BodyDecoder:
    """The body decode and assembly of one pose model, shared by
    `PoseExtractor` and `parallel/inference.py::PoseInference`: per-scale
    net outputs -> resize-and-merge of the part channels -> NMS -> PAF pair
    scores on the device, and greedy assembly of one frame on the host,
    with the model's pair tables and one set of connect limits."""

    def __init__(self, info, max_peaks: int, connect: ConnectParams,
                 maximize_positives: bool, device: torch.device):
        self.info = info
        self.max_peaks = max_peaks
        self.connect = connect
        self.maximize_positives = maximize_positives
        self.pairs, map_idx = paf.pair_tables(info)
        self.pairs_dev = torch.from_numpy(self.pairs).to(device)
        self.map_idx_dev = torch.from_numpy(map_idx).to(device)

    def decode(self, sources: Sequence[torch.Tensor],
               scales: Sequence[float], target_hw: Tuple[int, int],
               nms_offset: float, stage=_no_stage,
               nms_threshold: Optional[float] = None,
               inter_threshold: Optional[float] = None):
        """Per-scale net outputs [N, h_s, w_s, C] -> (peaks
        [N, parts, K+1, 3], scores [N, P, K, K]) on the device, merged
        onto target_hw (the scale-0 net input), each step inside
        `stage(name)` (`parallel/graphs.py` captures a graph a stage).
        The thresholds default to `connect`'s; top-down refinement
        (`pose/refine.py`) decodes its crops with lower ones."""
        cp = self.connect
        if nms_threshold is None:
            nms_threshold = cp.nms_threshold
        if inter_threshold is None:
            inter_threshold = cp.inter_threshold
        sources, scales = list(sources), list(scales)
        with stage("pose.decode.merge"):
            merged = resize.upsample_merge(
                [s[..., :self.info.num_parts] for s in sources], scales,
                target_hw)
        with stage("pose.decode.nms"):
            peaks = nms.nms(merged, nms_threshold, self.max_peaks,
                            offset=(nms_offset, nms_offset))
        with stage("pose.decode.paf"):
            scores = paf.paf_scores_multiscale(
                sources, scales, target_hw, peaks, self.pairs_dev,
                self.map_idx_dev, inter_threshold,
                cp.inter_min_above_threshold, nms_threshold)
        return peaks, scores

    def assemble(self, peaks: np.ndarray, scores: np.ndarray,
                 scale_net_to_output: float):
        """Host tail for one frame: peaks [parts, K+1, 3] and scores
        [P, k, k] -> (keypoints [people, parts, 3], person scores)."""
        cp = self.connect
        return assembly.connect_body_parts(
            scores, peaks, self.pairs, self.info.num_parts,
            cp.min_subset_cnt, cp.min_subset_score, scale_net_to_output,
            self.maximize_positives)


class PoseExtractor:
    """Multi-person 2D pose extractor for one pose model."""

    def __init__(self, model: Model, max_peaks: int = POSE_MAX_PEOPLE,
                 maximize_positives: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 connect_params: Optional[ConnectParams] = None,
                 device: Union[str, torch.device, None] = None):
        self.device = device_rule.resolve(device)
        model.net.to(self.device)
        self.model = model
        self.info = model.info
        self.compute_dtype = compute_dtype
        self.decoder = BodyDecoder(
            self.info, max_peaks,
            connect_params or default_connect_params(
                PoseModel(self.info.name), maximize_positives),
            maximize_positives, self.device)

    @property
    def connect(self) -> ConnectParams:
        return self.decoder.connect

    @torch.inference_mode()
    def net_outputs(self, image: torch.Tensor, plan: scaler.ScalePlan,
                    injected: Optional[torch.Tensor] = None
                    ) -> List[torch.Tensor]:
        """image [1, H, W, 3] BGR float 0..255 on the device -> per-scale net
        outputs [1, h_s, w_s, C]; injected: an optional [1, h/8, w/8, C] net
        output that replaces the CNN (the reference's Datum::poseNetOutput
        hook)."""
        if injected is not None:
            return [injected.to(torch.float32)]
        sources = []
        for (w, h), s in zip(plan.net_input_sizes, plan.scale_input_to_net):
            net_in = resize.normalize_vgg(
                resize.resize_fixed_aspect(image, s, (h, w)))
            sources.append(self.model.forward(net_in, self.compute_dtype))
        return sources

    @torch.inference_mode()
    def decode(self, sources: List[torch.Tensor], plan: scaler.ScalePlan,
               nms_offset: float, nms_threshold: Optional[float] = None,
               inter_threshold: Optional[float] = None):
        """`BodyDecoder.decode` onto the plan's scale-0 net input."""
        target_w, target_h = plan.net_input_sizes[0]
        return self.decoder.decode(
            sources, plan.scale_input_to_net, (target_h, target_w),
            nms_offset, nms_threshold=nms_threshold,
            inter_threshold=inter_threshold)

    def assemble(self, peaks_np: np.ndarray, scores_np: np.ndarray,
                 scale_net_to_output: float):
        """Host tail for one frame (device outputs -> people)."""
        return self.decoder.assemble(peaks_np, scores_np, scale_net_to_output)

    def forward(self, image: np.ndarray,
                net_resolution: Tuple[int, int] = (-1, 368),
                scale_number: int = 1, scale_gap: float = 0.25,
                keep_heatmaps: bool = False,
                net_output: Optional[np.ndarray] = None,
                net_resolution_dynamic: float = -1.0) -> PosePrediction:
        """image: [H, W, 3] uint8/float BGR.  net_output: optional
        [h/8, w/8, C] net output that bypasses the CNN.  keep_heatmaps:
        also return the merged low-res map of all channels."""
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(
                f"input image must be [H, W, 3] BGR, got shape {image.shape}")
        in_h, in_w = image.shape[:2]
        plan = scaler.extract_scales(
            (in_w, in_h), net_resolution, scale_number, scale_gap,
            net_resolution_dynamic=net_resolution_dynamic)
        net_out_w, net_out_h = plan.net_input_sizes[0]
        scale_net_to_output = net_to_output_scale(plan, (in_w, in_h))
        nms_offset = float(0.5 / scale_net_to_output)

        img = torch.tensor(np.asarray(image, np.float32)[None],
                           device=self.device)
        injected = None
        if net_output is not None:
            injected = torch.tensor(np.asarray(net_output, np.float32)[None],
                                    device=self.device)
        sources = self.net_outputs(img, plan, injected)
        peaks, scores = self.decode(sources, plan, nms_offset)
        heatmaps = None
        if keep_heatmaps:
            # all channels averaged over scales on the scale-0 low-res grid
            with torch.inference_mode():
                heatmaps = resize.upsample_merge(
                    sources, list(plan.scale_input_to_net),
                    tuple(sources[0].shape[1:3]))[0].cpu().numpy()
        peaks_np = peaks[0].cpu().numpy()
        scores_np = scores[0].cpu().numpy()
        keypoints, person_scores = self.assemble(peaks_np, scores_np,
                                                 scale_net_to_output)
        return PosePrediction(
            keypoints=keypoints, scores=person_scores, heatmaps=heatmaps,
            peaks=peaks_np, scale_net_to_output=scale_net_to_output,
            net_output_size=(net_out_w, net_out_h),
            scale_input_to_net=tuple(plan.scale_input_to_net),
            net_input_sizes=tuple(plan.net_input_sizes))
