"""Batched pose inference on one GPU.

Counterpart of `openpose_tpu/parallel/inference.py::ShardedPoseInference`
without the mesh, single scale: frames arrive pre-sized to the net input,
[B, net_h, net_w, 3] BGR uint8 or float 0..255, and go through CNN ->
resize-and-merge -> NMS -> PAF scoring as one batch, with the model's
default thresholds and the 127-peak budget.  Outputs stay on the device;
`fetch` copies them to the host with the pair scores cut to the smallest
`SCORE_BUCKETS` size that covers the batch's largest peak count.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from openpose_tpu.ops import assembly
from openpose_tpu.params import (
    POSE_MAX_PEOPLE, PoseModel, default_connect_params)
from openpose_tpu_torch.models.zoo import Model
from openpose_tpu_torch.ops import nms, paf, resize


class PoseInference:
    """Batched BODY-model inference on one device."""

    # the [B, P, K, K] scores dominate the device->host volume (1.7 MB per
    # frame at K = 127) while assembly reads only the [:count, :count] corner
    SCORE_BUCKETS = (8, 16, 32, 64)

    def __init__(self, model: Model, net_hw: Tuple[int, int] = (368, 656),
                 device: Union[str, torch.device, None] = None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.device = torch.device(device) if device is not None \
            else model.device
        model.net.to(self.device)
        self.model = model
        self.net_hw = net_hw
        self.compute_dtype = compute_dtype
        info = model.info
        self.num_parts = info.num_parts
        self.connect = default_connect_params(PoseModel(info.name))
        pairs, map_idx = paf.pair_tables(info)
        self._pairs_np = pairs
        self.pairs = torch.from_numpy(pairs).to(self.device)
        self.map_idx = torch.from_numpy(map_idx).to(self.device)

    @torch.inference_mode()
    def __call__(self, images: Union[np.ndarray, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, net_h, net_w, 3] -> (peaks [B, parts, K+1, 3],
        pair scores [B, P, K, K]), both on the device."""
        x = torch.as_tensor(images).to(self.device, non_blocking=True)
        if tuple(x.shape[1:]) != (*self.net_hw, 3):
            raise ValueError(f"images must be [B, {self.net_hw[0]}, "
                             f"{self.net_hw[1]}, 3], got {tuple(x.shape)}")
        source = self.model.forward(
            resize.normalize_vgg(x.to(torch.float32)), self.compute_dtype)
        merged = resize.upsample_merge([source[..., :self.num_parts]], [1.0],
                                       self.net_hw)
        cp = self.connect
        # net-sized inputs: the +0.5 refinement offset is in net pixels
        peaks = nms.nms(merged, cp.nms_threshold, POSE_MAX_PEOPLE)
        scores = paf.paf_scores_multiscale(
            [source], [1.0], self.net_hw, peaks, self.pairs, self.map_idx,
            cp.inter_threshold, cp.inter_min_above_threshold,
            cp.nms_threshold)
        return peaks, scores

    def fetch(self, peaks: torch.Tensor, scores: torch.Tensor
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Device outputs -> host arrays, the score matrix sliced on the
        device to the smallest bucket covering the batch's max peak count."""
        peaks_np = peaks.cpu().numpy()
        max_count = int(peaks_np[:, :, 0, 0].max()) if peaks_np.size else 0
        k = next((b for b in self.SCORE_BUCKETS
                  if max_count <= b < POSE_MAX_PEOPLE), POSE_MAX_PEOPLE)
        return peaks_np, scores[:, :, :k, :k].cpu().numpy()

    def assemble(self, peaks: np.ndarray, scores: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Host tail for one fetched frame: peaks [parts, K+1, 3] and scores
        [P, k, k] -> (keypoints [people, parts, 3] in net pixels, person
        scores [people])."""
        cp = self.connect
        return assembly.connect_body_parts(
            scores, peaks, self._pairs_np, self.num_parts, cp.min_subset_cnt,
            cp.min_subset_score, 1.0)
