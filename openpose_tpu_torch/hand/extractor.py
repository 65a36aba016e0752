"""Hand keypoint extractor: 2 x 21 keypoints per person.

Counterpart of `openpose_tpu/hand/extractor.py`
(HandExtractorCaffe::forwardPass, handExtractorCaffe.cpp:305-430): a left
hand is mirrored before the net (cropFrame, ibid:44-74) by a negative
x-scale in its crop transform, so left and right hands run in the same
batched forward.  With scale_number > 1 every hand runs at each scale and
keeps the scale with the best mean score (ibid:390-430).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from openpose_tpu_torch.models.zoo import Model
from openpose_tpu_torch.params import HAND_NUMBER_PARTS
from openpose_tpu_torch.runtime.topdown import Rect, TopDownExtractor


def _recenter(rect: Rect, new_w: float, new_h: float) -> Rect:
    """The rect resized to (new_w, new_h) about its centre."""
    cx = rect[0] + rect[2] / 2.0
    cy = rect[1] + rect[3] / 2.0
    return (cx - new_w / 2.0, cy - new_h / 2.0, new_w, new_h)


class HandExtractor:
    def __init__(self, model: Model, net_size: int = 368,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 scale_number: int = 1, scale_range: float = 0.4,
                 device: Union[str, torch.device, None] = None):
        self._topdown = TopDownExtractor(model, net_size, compute_dtype,
                                         device)
        self.scale_number = scale_number
        self.scale_range = scale_range

    def _run(self, image, rects_lr: Sequence[Tuple[Rect, Rect]]):
        rects: List[Rect] = []
        mirror: List[bool] = []
        for left, right in rects_lr:
            rects += [left, right]
            mirror += [True, False]     # the left hand is mirrored
        kp = self._topdown.extract(image, rects, mirror, HAND_NUMBER_PARTS)
        return kp.reshape(len(rects_lr), 2, HAND_NUMBER_PARTS, 3)

    def forward(self, image: np.ndarray,
                hand_rects: Sequence[Tuple[Rect, Rect]]
                ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (left [people, 21, 3], right [people, 21, 3]) in image
        coordinates."""
        if not hand_rects:
            z = np.zeros((0, HAND_NUMBER_PARTS, 3), np.float32)
            return z, z.copy()
        if self.scale_number <= 1:
            kp = self._run(image, hand_rects)
            return kp[:, 0], kp[:, 1]
        best = None
        init_scale = 1.0 - self.scale_range / 2.0
        for i in range(self.scale_number):
            scale = init_scale + self.scale_range * i / (self.scale_number - 1.0)
            scaled = [tuple(
                _recenter(r, round(r[2] * scale) // 2 * 2,
                          round(r[3] * scale) // 2 * 2) for r in lr)
                for lr in hand_rects]
            kp = self._run(image, scaled)
            if best is None:
                best = kp
            else:
                take = kp[..., 2].mean(axis=-1) > best[..., 2].mean(axis=-1)
                best = np.where(take[..., None, None], kp, best)
        return best[:, 0], best[:, 1]
