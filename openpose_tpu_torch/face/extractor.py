"""Face keypoint extractor: 70 keypoints per face rectangle.

Counterpart of `openpose_tpu/face/extractor.py`
(FaceExtractorCaffe::forwardPass, faceExtractorCaffe.cpp:205-330) with the
per-person loop replaced by one batched crop and forward.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from openpose_tpu_torch.models.zoo import Model
from openpose_tpu_torch.params import FACE_NUMBER_PARTS
from openpose_tpu_torch.runtime.topdown import Rect, TopDownExtractor


class FaceExtractor:
    def __init__(self, model: Model, net_size: int = 368,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device, None] = None):
        self._topdown = TopDownExtractor(model, net_size, compute_dtype,
                                         device)

    def forward(self, image: np.ndarray,
                face_rects: Sequence[Rect]) -> np.ndarray:
        """-> [people, 70, 3] keypoints in image coordinates."""
        return self._topdown.extract(
            image, face_rects, [False] * len(face_rects), FACE_NUMBER_PARTS)
