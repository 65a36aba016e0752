"""Self-contained COCO keypoint evaluation (OKS-based AP/AR).

The reference defers AP computation to offline Matlab tooling
(scripts/tests/pose_accuracy_coco_val.sh + the openpose_train repo); here the
standard COCO keypoint metric is built in, mirroring the published
pycocotools.cocoeval algorithm EXACTLY (pycocotools is not installable in
this environment, so the algorithm is re-implemented from its public
specification and validated against a line-faithful oracle transcription in
tests/coco_oracle.py plus hand-derived fixtures):

* OKS (computeOks): e = d^2 / (2*sigma)^2 / (2*(area+eps)), averaged over
  VISIBLE gt keypoints; gts with zero visible keypoints fall back to a
  box-expanded distance (distance outside [bbox - wh, bbox + 2*wh]).
* Matching (evaluateImg): per OKS threshold, detections in descending score
  order each greedily take the best still-free non-ignored gt with
  OKS >= threshold; crowd (iscrowd=1) gts may be matched repeatedly; once a
  detection holds a non-ignored match it never trades down to an ignored gt;
  detections matched to ignored gts are themselves ignored (neither TP nor
  FP).  Gt "ignore" = iscrowd, explicit ignore flag, or num_keypoints == 0.
* Accumulation (accumulate): stable global sort of detections by score,
  precision = tp/(tp+fp) over non-ignored detections only, monotone
  non-increasing envelope, 101-point interpolation at recall 0:0.01:1 with
  searchsorted-left, AP = mean over OKS thresholds 0.50:0.05:0.95; AR =
  mean over thresholds of final recall at max_dets=20 per image.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Official COCO keypoint sigmas (person category, 17 keypoints)
COCO_SIGMAS = np.array([
    .026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
    .107, .107, .087, .087, .089, .089])

OKS_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)


def _gt_bbox(gt: Dict, kp: np.ndarray) -> Optional[np.ndarray]:
    """[x, y, w, h] — the annotation's bbox, else the visible-kp bbox."""
    if "bbox" in gt:
        return np.asarray(gt["bbox"], np.float64)
    vis = kp[:, 2] > 0
    if not vis.any():
        return None
    x0, y0 = kp[vis, 0].min(), kp[vis, 1].min()
    return np.array([x0, y0, kp[vis, 0].max() - x0, kp[vis, 1].max() - y0])


def oks(det_kp: np.ndarray, gt_kp: np.ndarray, gt_area: float,
        gt_bbox: Optional[Sequence[float]] = None,
        sigmas: np.ndarray = COCO_SIGMAS) -> float:
    """pycocotools computeOks for one (det, gt) pair.

    det_kp [K,3] (x, y, _), gt_kp [K,3] (x, y, visibility).  For gts with no
    visible keypoint the distance is measured outside the expanded bbox
    (bbox - wh .. bbox + 2*wh) and averaged over ALL K keypoints.
    """
    var = (sigmas * 2.0) ** 2
    vis = gt_kp[:, 2] > 0
    if vis.any():
        dx = det_kp[:, 0] - gt_kp[:, 0]
        dy = det_kp[:, 1] - gt_kp[:, 1]
        e = (dx ** 2 + dy ** 2) / var / (gt_area + np.spacing(1)) / 2.0
        e = e[vis]
    else:
        if gt_bbox is None:
            return 0.0
        bx, by, bw, bh = gt_bbox
        x0, x1 = bx - bw, bx + 2.0 * bw
        y0, y1 = by - bh, by + 2.0 * bh
        dx = (np.maximum(0.0, x0 - det_kp[:, 0])
              + np.maximum(0.0, det_kp[:, 0] - x1))
        dy = (np.maximum(0.0, y0 - det_kp[:, 1])
              + np.maximum(0.0, det_kp[:, 1] - y1))
        e = (dx ** 2 + dy ** 2) / var / (gt_area + np.spacing(1)) / 2.0
    return float(np.sum(np.exp(-e)) / e.shape[0])


def _prepare_gt(gt: Dict) -> Dict:
    kp = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
    n_vis = int(gt.get("num_keypoints", int(np.count_nonzero(kp[:, 2] > 0))))
    iscrowd = int(gt.get("iscrowd", 0))
    ignore = bool(gt.get("ignore", 0)) or iscrowd == 1 or n_vis == 0
    return {"kp": kp, "area": float(gt.get("area", 1.0)),
            "bbox": _gt_bbox(gt, kp), "iscrowd": iscrowd, "ignore": ignore}


def evaluate(detections: List[Dict], ground_truth: List[Dict],
             max_dets: int = 20,
             sigmas: np.ndarray = COCO_SIGMAS) -> Dict[str, float]:
    """detections: [{image_id, keypoints (3K floats), score}]
    ground_truth: [{image_id, keypoints (3K floats, flag=visibility), area,
                    (optional) iscrowd, bbox, num_keypoints, ignore}]
    Returns {AP, AP50, AP75, AR}.
    """
    gts_by_image: Dict[int, List[Dict]] = {}
    for gt in ground_truth:
        gts_by_image.setdefault(int(gt["image_id"]), []).append(gt)
    dets_by_image: Dict[int, List[Dict]] = {}
    for det in detections:
        dets_by_image.setdefault(int(det["image_id"]), []).append(det)

    n_thr = len(OKS_THRESHOLDS)
    all_scores: List[float] = []
    all_tp: List[np.ndarray] = []      # matched to non-ignored gt [n_thr]
    all_ignore: List[np.ndarray] = []  # detection ignored [n_thr]
    total_gt = 0

    # sorted image order so tie-broken global sort is deterministic and
    # matches pycocotools' per-image concatenation order
    for image_id in sorted(set(gts_by_image) | set(dets_by_image)):
        raw_gts = gts_by_image.get(image_id, [])
        gts = [_prepare_gt(g) for g in raw_gts]
        # non-ignored gts first (stable), as pycocotools sorts by _ignore
        order = sorted(range(len(gts)), key=lambda i: gts[i]["ignore"])
        gts = [gts[i] for i in order]
        total_gt += sum(0 if g["ignore"] else 1 for g in gts)
        dets = sorted(dets_by_image.get(image_id, []),
                      key=lambda d: -float(d["score"]))[:max_dets]
        if not dets:
            continue
        det_kps = [np.asarray(d["keypoints"], np.float64).reshape(-1, 3)
                   for d in dets]
        ious = np.zeros((len(dets), len(gts)))
        for gi, g in enumerate(gts):
            for di in range(len(dets)):
                ious[di, gi] = oks(det_kps[di], g["kp"], g["area"],
                                   g["bbox"], sigmas)
        tp = np.zeros((len(dets), n_thr))
        dt_ig = np.zeros((len(dets), n_thr), bool)
        for ti, thr in enumerate(OKS_THRESHOLDS):
            gt_match = np.full(len(gts), -1)
            for di in range(len(dets)):
                best = min(thr, 1.0 - 1e-10)
                m = -1
                for gi, g in enumerate(gts):
                    # already claimed and not a (re-matchable) crowd gt
                    if gt_match[gi] >= 0 and not g["iscrowd"]:
                        continue
                    # holding a non-ignored match: stop before ignored gts
                    if m > -1 and not gts[m]["ignore"] and g["ignore"]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                gt_match[m] = di
                if gts[m]["ignore"]:
                    dt_ig[di, ti] = True
                else:
                    tp[di, ti] = 1.0
        for di, det in enumerate(dets):
            all_scores.append(float(det["score"]))
            all_tp.append(tp[di])
            all_ignore.append(dt_ig[di])

    if not all_scores or total_gt == 0:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0, "AR": 0.0}

    order = sorted(range(len(all_scores)), key=lambda i: -all_scores[i])
    tps = np.stack([all_tp[i] for i in order])          # [D, n_thr]
    igs = np.stack([all_ignore[i] for i in order])      # [D, n_thr]
    fps = (tps == 0) & ~igs
    cum_tp = np.cumsum(tps, axis=0)
    cum_fp = np.cumsum(fps, axis=0)
    recall = cum_tp / total_gt
    precision = cum_tp / (cum_tp + cum_fp + np.spacing(1))
    aps = np.zeros(n_thr)
    for ti in range(n_thr):
        p = precision[:, ti].copy()
        for i in range(len(p) - 2, -1, -1):             # monotone envelope
            p[i] = max(p[i], p[i + 1])
        rc = recall[:, ti]
        idx = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
        q = np.where(idx < len(p), p[np.minimum(idx, len(p) - 1)], 0.0)
        aps[ti] = q.mean()
    ar = recall[-1].mean()
    return {"AP": float(aps.mean()), "AP50": float(aps[0]),
            "AP75": float(aps[5]), "AR": float(ar)}


def evaluate_files(detections_json: str, annotations_json: str
                   ) -> Dict[str, float]:
    """detections: the `--write_coco_json` output (`io/json_io.py`);
    annotations: COCO person_keypoints_val*.json.  Gts with num_keypoints=0
    or iscrowd=1 participate as ignore regions (pycocotools semantics)."""
    with open(detections_json) as f:
        dets = json.load(f)
    with open(annotations_json) as f:
        coco = json.load(f)
    return evaluate(dets, coco["annotations"])
