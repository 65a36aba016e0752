"""Top-down per-person refinement of bottom-up detections.

Counterpart of `openpose_tpu/pose/refine.py`.  The reference's experimental
TOP_DOWN_REFINEMENT pass (src/openpose/pose/poseExtractorCaffe.cpp:340-618,
compile-time constant, off by default): for every detected person, crop an
expanded ROI, re-run the CNN on the upscaled crop, re-extract people from
the crop, match the refined candidate back to the original person (min
average distance AND max rectangle-IoU must agree, with >= 75% of the
original keypoint count), and replace the keypoints when the average
distance is small enough.

The reference loops people, re-running the net once per ROI; here ALL
eligible ROIs of a frame are cropped in one batched affine crop
(`ops/warp.crop_affine_batch`) and decoded by ONE batched forward +
`PoseExtractor.decode` per crop geometry (at the default 127-peak budget
that is one launch of the fused PAF kernel over all crops), with one copy
to the host per geometry.  One deliberate divergence from the reference:
crops resample the ORIGINAL image with the combined transform instead of
re-resampling the already-resampled net input (single interpolation,
strictly less blur; geometry identical).

The host helpers (`_keypoints_rectangle` ... `_person_rois`,
`_merge_refined`) are the original's NumPy code, but for `_resize_scale`:
the original raises ZeroDivisionError on a person whose ROI is one pixel
wide or high.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from openpose_tpu_torch.ops import resize, warp
from openpose_tpu_torch.pose import scaler

NMS_THRESHOLD_REFINED = 0.02     # poseExtractorCaffe.cpp:457
INTER_THRESHOLD_REFINED = 0.01   # poseExtractorCaffe.cpp:468


def _keypoints_rectangle(kp: np.ndarray, thr: float
                         ) -> Optional[Tuple[float, float, float, float]]:
    """getKeypointsRectangle (utilities/keypoint.cpp:289-339)."""
    valid = kp[:, 2] > thr
    if not valid.any():
        return None
    xs, ys = kp[valid, 0], kp[valid, 1]
    return (float(xs.min()), float(ys.min()),
            float(xs.max() - xs.min()), float(ys.max() - ys.min()))


def _distance_average(a: np.ndarray, b: np.ndarray, thr: float) -> float:
    """getDistanceAverage (keypoint.cpp:476-505): mean distance over parts
    scoring >= thr in BOTH."""
    both = (a[:, 2] >= thr) & (b[:, 2] >= thr)
    if not both.any():
        return float("inf")
    d = np.sqrt(((a[both, :2] - b[both, :2]) ** 2).sum(axis=-1))
    return float(d.mean())


def _rect_iou(ra, rb) -> float:
    """getKeypointsRoi on rectangles (keypoint.cpp:587-633)."""
    if ra is None or rb is None:
        return 0.0
    ax0 = max(ra[0], rb[0])
    ay0 = max(ra[1], rb[1])
    ax1 = min(ra[0] + ra[2], rb[0] + rb[2])
    ay1 = min(ra[1] + ra[3], rb[1] + rb[3])
    if ax0 >= ax1 or ay0 >= ay1:
        return 0.0
    inter = (ax1 - ax0) * (ay1 - ay0)
    union = ra[2] * ra[3] + rb[2] * rb[3] - inter
    return inter / union if union > 0 else 0.0


def _resize_scale(initial: Tuple[int, int], target: Tuple[int, int]) -> float:
    """`scaler.resize_get_scale_factor` in the reference's float arithmetic:
    a ROI side of one pixel gives an infinite ratio, so the other side
    decides, where Python's division by zero would raise (random weights
    produce such people: three keypoints in a line)."""
    with np.errstate(divide="ignore"):
        return float(min(np.float64(target[0] - 1) / np.float64(initial[0] - 1),
                         np.float64(target[1] - 1) / np.float64(initial[1] - 1)))


@dataclasses.dataclass
class _Roi:
    person: int
    rect: Tuple[int, int, int, int]       # net-input coords
    scale_net_to_roi: float
    target: Tuple[int, int]               # (w, h)


def _person_rois(keypoints: np.ndarray, nms_threshold: float,
                 scale_net_to_output: float,
                 net_in_wh: Tuple[int, int]) -> List[_Roi]:
    """Expanded per-person ROIs + target sizes (poseExtractorCaffe.cpp:
    344-412), in scale-0 net-input coordinates."""
    net_w, net_h = net_in_wh
    rois: List[_Roi] = []
    for person in range(keypoints.shape[0]):
        rect = _keypoints_rectangle(keypoints[person], nms_threshold)
        if rect is None:
            continue
        # to net-input coords, expanded 1.4x
        x, y, rw, rh = (v / scale_net_to_output for v in rect)
        rx = int(round(x - 0.2 * rw))
        ry = int(round(y - 0.2 * rh))
        rww = int(round(rw * 1.4))
        rhh = int(round(rh * 1.4))
        # keepRoiInside
        rx = max(0, rx)
        ry = max(0, ry)
        rww = min(rww, net_w - rx)
        rhh = min(rhh, net_h - ry)
        if rww <= 0 or rhh <= 0:
            continue
        # target size (poseExtractorCaffe.cpp:368-385)
        if net_h >= 368 or net_h * net_w >= 135424:
            target = (368, 368)
        else:
            min_side = min(368, min(net_h, net_w))
            max_side = min(368, max(net_h, net_w))
            target = (min_side, max_side) if rww < rhh \
                else (max_side, min_side)
        s = _resize_scale((rww, rhh), target)
        # expand the ROI to consume the padding (cpp:388-407)
        pad_x = int(round((target[0] - 1) / s + 1 - rww))
        pad_y = int(round((target[1] - 1) / s + 1 - rhh))
        if pad_x > 2 or pad_y > 2:
            if pad_x > 2:
                rx -= pad_x // 2
                rww += pad_x
            elif pad_y > 2:
                ry -= pad_y // 2
                rhh += pad_y
            rx = max(0, rx)
            ry = max(0, ry)
            rww = min(rww, net_w - rx)
            rhh = min(rhh, net_h - ry)
            s = _resize_scale((rww, rhh), target)
        if s <= 1.0 or not np.isfinite(s):
            # shrink would lose detail: keep original; a one-pixel ROI
            # has no scale at all
            continue
        rois.append(_Roi(person, (rx, ry, rww, rhh), s, target))
    return rois


def refine_prediction(extractor, image: np.ndarray, pred,
                      people_cap: int = 8):
    """Refine `pred` (a PosePrediction from extractor.forward) in place.

    extractor: PoseExtractor (its model, thresholds and device are reused).
    Returns the refined PosePrediction (same object, keypoints updated).
    """
    kp_all = pred.keypoints
    if kp_all is None or kp_all.shape[0] == 0:
        return pred
    nms_thr = extractor.connect.nms_threshold
    net_w, net_h = pred.net_output_size
    rois = _person_rois(kp_all, nms_thr, pred.scale_net_to_output,
                        (net_w, net_h))[:people_cap]
    if not rois:
        return pred
    # group by target geometry (one batched decode per distinct target)
    by_target = {}
    for roi in rois:
        by_target.setdefault(roi.target, []).append(roi)
    img = torch.as_tensor(image).to(extractor.device).to(torch.float32)
    for target, group in by_target.items():
        tw, th = target
        transforms = np.zeros((len(group), 4), np.float32)
        for i, roi in enumerate(group):
            # dst px -> ORIGINAL image px: through net-input coords
            s_img = pred.scale_net_to_output / roi.scale_net_to_roi
            transforms[i] = (s_img, s_img,
                             roi.rect[0] * pred.scale_net_to_output,
                             roi.rect[1] * pred.scale_net_to_output)
        crops = warp.crop_affine_batch(
            img, torch.from_numpy(transforms).to(extractor.device),
            out_size=(th, tw))
        peaks, scores = _decode_crops(extractor, crops, (th, tw))
        for i, roi in enumerate(group):
            scale_roi_to_out = pred.scale_net_to_output / roi.scale_net_to_roi
            cand_kp, cand_sc = extractor.assemble(peaks[i], scores[i],
                                                  scale_roi_to_out)
            if cand_kp.shape[0] == 0:
                continue
            # +0.5 offset in output px (nms offset 0.5/scaleRoiToOutput,
            # applied host-side) + ROI origin offset
            valid = cand_kp[:, :, 2] > 0
            cand_kp[..., 0] += np.where(
                valid, roi.rect[0] * pred.scale_net_to_output + 0.5, 0.0)
            cand_kp[..., 1] += np.where(
                valid, roi.rect[1] * pred.scale_net_to_output + 0.5, 0.0)
            _merge_refined(kp_all, pred.scores, roi.person, cand_kp,
                           cand_sc, nms_thr)
    return pred


@torch.inference_mode()
def _decode_crops(extractor, crops: torch.Tensor,
                  target_hw: Tuple[int, int]):
    """Batched net forward + `PoseExtractor.decode` on [P, th, tw, 3] crops
    on the device, with the refinement thresholds and no NMS offset.
    Returns host arrays (peaks [P, parts, K+1, 3], scores [P, pairs, K, K])
    from one copy each."""
    th, tw = target_hw
    out = extractor.model.forward(resize.normalize_vgg(crops),
                                  extractor.compute_dtype)
    plan = scaler.ScalePlan((1.0,), ((tw, th),), 1.0, (tw, th))
    peaks, scores = extractor.decode(
        [out], plan, 0.0, nms_threshold=NMS_THRESHOLD_REFINED,
        inter_threshold=INTER_THRESHOLD_REFINED)
    return peaks.cpu().numpy(), scores.cpu().numpy()


def _merge_refined(kp_all: np.ndarray, scores_all: np.ndarray, person: int,
                   cand_kp: np.ndarray, cand_sc: np.ndarray,
                   nms_thr: float) -> bool:
    """Matching + replacement (poseExtractorCaffe.cpp:473-560): the min-
    average-distance and max-rect-IoU candidates must AGREE, carry >= 75%
    of the original keypoint count, and sit within 0.1*|rect corner| avg
    distance (the reference's formula verbatim, quirk included)."""
    orig = kp_all[person]
    n_orig = int((orig[:, 2] > nms_thr).sum())
    best_d, pd = float("inf"), -1
    best_roi, pr = -1.0, -1
    orig_rect = _keypoints_rectangle(orig, nms_thr)
    for c in range(cand_kp.shape[0]):
        n_c = int((cand_kp[c][:, 2] > nms_thr).sum())
        if n_c < 0.75 * n_orig:
            continue
        d = _distance_average(orig, cand_kp[c], nms_thr)
        if d < best_d:
            best_d, pd = d, c
        iou = _rect_iou(orig_rect, _keypoints_rectangle(cand_kp[c], nms_thr))
        if iou > best_roi:
            best_roi, pr = iou, c
    if pd != pr or pd < 0:
        return False
    # reference quirk: threshold uses the rectangle's CORNER coordinates
    ratio = 0.1 * float(np.hypot(orig_rect[0], orig_rect[1])) \
        if orig_rect else 0.0
    if best_d >= ratio:
        return False
    kp_all[person] = cand_kp[pd]
    scores_all[person] = cand_sc[pd]
    return True
