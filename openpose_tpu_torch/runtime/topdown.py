"""Top-down (per-person crop) extraction shared by face and hand.

Counterpart of `openpose_tpu/runtime/topdown.py`: the reference loops
crop -> CNN -> decode one person at a time (faceExtractorCaffe.cpp:205-310,
handExtractorCaffe.cpp:305-430); here the crops of one image go through
the batched `TopDownInference` as a batch of one frame: one affine crop,
one CNN forward and one windowed argmax decode.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.models.zoo import Model
from openpose_tpu_torch.parallel.inference import Rect, TopDownInference


class TopDownExtractor:
    """Crop -> net -> argmax decode of one image for one (face or hand)
    model."""

    def __init__(self, model: Model, net_size: int = 368,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device, None] = None):
        self.device = device_rule.resolve(device)
        self.model = model
        self.net_size = net_size
        self.compute_dtype = compute_dtype

    def extract(self, image: np.ndarray, rects: Sequence[Rect],
                mirror: Sequence[bool], num_parts: int) -> np.ndarray:
        """image [H, W, 3] BGR float/uint8; rects and mirror per crop.
        Returns [len(rects), num_parts, 3] keypoints in image coordinates;
        a rect too small to crop yields zeros."""
        batched = TopDownInference(self.model, self.net_size, len(rects),
                                   self.device, self.compute_dtype)
        frame = torch.as_tensor(np.asarray(image, np.float32))[None]
        return batched.extract(frame, [list(zip(rects, mirror))],
                               num_parts)[0]
