"""Viola-Jones Haar-cascade face detector (body-free fallback).

Rebuild of FaceDetectorOpenCV (reference:
src/openpose/face/faceDetectorOpenCV.cpp:33-66), which wraps
cv::CascadeClassifier over ``haarcascade_frontalface_alt.xml``.  Counterpart
of `openpose_tpu/face/haar.py`, without OpenCV: the gray conversion, the
pyramid step and the bilinear resize that the original takes from cv2 are
NumPy here (`_bgr_to_gray`, `_pyr_down`, `_resize_linear`, each within one
gray level of the cv2 routine).  The cascade is evaluated directly:
integral-image rectangle sums computed for ALL sliding windows of a scale at once (NumPy vectorized), stage by stage, with
surviving windows compacted between stages — the same boosted-stump cascade
semantics as OpenCV's HaarEvaluator/CascadeClassifierImpl
(stump value = sum_i w_i * rectsum_i, compared against
node_threshold * window_std * norm_area; stage sum of leaf values compared
against the stage threshold).

Host-side NumPy is the right tool here: this detector only runs when body
keypoints are disabled or the caller asks for it, on <=640x360 grayscale frames (the reference pyrDowns
to that size before detecting), and the cascade rejects ~95% of windows in
the first two stages.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence, Tuple

import numpy as np

# The reference ships the cascade inside its model folder
# (models/face/haarcascade_frontalface_alt.xml, consumed by
# faceDetectorOpenCV.cpp:33-37); system OpenCV installs are the fallback.
CASCADE_RELATIVE = "face/haarcascade_frontalface_alt.xml"
DEFAULT_CASCADE_PATHS = (
    "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt.xml",
    "/usr/local/share/opencv4/haarcascades/haarcascade_frontalface_alt.xml",
)


@dataclasses.dataclass
class HaarCascade:
    """Parsed stump-based Haar cascade (BOOST / HAAR / maxCatCount=0)."""

    window: Tuple[int, int]                 # (h, w) of the base window
    stage_thresholds: np.ndarray            # [n_stages] f32
    stage_bounds: np.ndarray                # [n_stages + 1] stump index ranges
    stump_feature: np.ndarray               # [n_stumps] int32 feature index
    stump_threshold: np.ndarray             # [n_stumps] f32
    stump_leaves: np.ndarray                # [n_stumps, 2] f32 (left, right)
    rects: np.ndarray                       # [n_features, 3, 5] (x,y,w,h,weight);
                                            # unused third rect has weight 0


def parse_cascade(path: str) -> HaarCascade:
    """Parse an OpenCV new-format (type_id=opencv-cascade-classifier) XML."""
    root = ET.parse(path).getroot()
    casc = root.find("cascade")
    if casc is None or casc.findtext("featureType", "").strip() != "HAAR":
        raise ValueError(f"not a HAAR cascade: {path}")
    h = int(casc.findtext("height").strip())
    w = int(casc.findtext("width").strip())

    stage_thresholds: List[float] = []
    bounds = [0]
    feats: List[int] = []
    thrs: List[float] = []
    leaves: List[Tuple[float, float]] = []
    for stage in casc.find("stages"):
        stage_thresholds.append(float(stage.findtext("stageThreshold").strip()))
        for weak in stage.find("weakClassifiers"):
            nodes = weak.findtext("internalNodes").split()
            lv = weak.findtext("leafValues").split()
            if len(nodes) != 4 or len(lv) != 2:
                raise ValueError("only stump-based cascades are supported")
            # internalNodes: left right featureIdx threshold
            feats.append(int(nodes[2]))
            thrs.append(float(nodes[3]))
            leaves.append((float(lv[0]), float(lv[1])))
        bounds.append(len(feats))

    rects = np.zeros((0, 3, 5), np.float32)
    feat_list = []
    for feat in casc.find("features"):
        rr = np.zeros((3, 5), np.float32)
        for i, r in enumerate(feat.find("rects")):
            vals = [float(v) for v in r.text.split()]
            rr[i] = vals  # x y w h weight
        feat_list.append(rr)
    rects = np.stack(feat_list)

    return HaarCascade(
        window=(h, w),
        stage_thresholds=np.asarray(stage_thresholds, np.float32),
        stage_bounds=np.asarray(bounds, np.int32),
        stump_feature=np.asarray(feats, np.int32),
        stump_threshold=np.asarray(thrs, np.float32),
        stump_leaves=np.asarray(leaves, np.float32),
        rects=rects,
    )


def _find_default_cascade(model_folder: Optional[str] = None
                          ) -> Optional[str]:
    candidates: List[str] = []
    if model_folder:
        candidates.append(os.path.join(model_folder, CASCADE_RELATIVE))
    candidates.extend(DEFAULT_CASCADE_PATHS)
    for p in candidates:
        if os.path.exists(p):
            return p
    return None


def _bgr_to_gray(image: np.ndarray) -> np.ndarray:
    """cv::cvtColor(BGR2GRAY) on uint8: 15-bit fixed-point weights."""
    b, g, r = (image[..., c].astype(np.int64) for c in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15) \
        .astype(np.uint8)


def _pyr_down(gray: np.ndarray) -> np.ndarray:
    """cv::pyrDown on uint8: the separable 1-4-6-4-1 kernel over a
    reflect-101 border, every second pixel, rounded once at the end."""
    k = np.array([1, 4, 6, 4, 1], np.int64)
    out_h, out_w = (gray.shape[0] + 1) // 2, (gray.shape[1] + 1) // 2
    pad = np.pad(gray.astype(np.int64), 2, mode="reflect")
    rows = sum(k[i] * pad[i:i + 2 * out_h:2] for i in range(5))
    both = sum(k[i] * rows[:, i:i + 2 * out_w:2] for i in range(5))
    return ((both + 128) >> 8).astype(np.uint8)


def _resize_linear(gray: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """cv::resize(INTER_LINEAR) on uint8: pixel centres aligned, taps
    clamped to the image, rounded to the nearest level."""
    sw, sh = size_wh
    h, w = gray.shape

    def taps(out_n, in_n):
        src = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
        lo = np.floor(src)
        d = src - lo
        i0 = np.clip(lo, 0, in_n - 1).astype(np.int64)
        i1 = np.clip(lo + 1, 0, in_n - 1).astype(np.int64)
        return i0, i1, d

    y0, y1, dy = taps(sh, h)
    x0, x1, dx = taps(sw, w)
    img = gray.astype(np.float64)
    rows = img[y0] * (1 - dy)[:, None] + img[y1] * dy[:, None]
    out = rows[:, x0] * (1 - dx) + rows[:, x1] * dx
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def _integral(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-padded integral images of img and img^2 (summed-area tables)."""
    img = img.astype(np.float64)
    ii = np.zeros((img.shape[0] + 1, img.shape[1] + 1))
    sq = np.zeros_like(ii)
    np.cumsum(np.cumsum(img, 0), 1, out=ii[1:, 1:])
    np.cumsum(np.cumsum(img * img, 0), 1, out=sq[1:, 1:])
    return ii, sq


def _rect_sums(ii: np.ndarray, ys: np.ndarray, xs: np.ndarray,
               rect: np.ndarray) -> np.ndarray:
    """Sum of ii over rect (x,y,w,h) offset by window corners (ys, xs)."""
    x, y, rw, rh = int(rect[0]), int(rect[1]), int(rect[2]), int(rect[3])
    y0, x0 = ys + y, xs + x
    y1, x1 = y0 + rh, x0 + rw
    return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]


def _detect_single_scale(casc: HaarCascade, ii: np.ndarray, sq: np.ndarray,
                         step: int) -> Tuple[np.ndarray, np.ndarray]:
    """Run the cascade over every (step-strided) window of one image scale.

    Returns (ys, xs) of accepted windows (top-left corners).
    """
    wh, ww = casc.window
    ih, iw = ii.shape[0] - 1, ii.shape[1] - 1
    if ih < wh or iw < ww:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    gy = np.arange(0, ih - wh + 1, step)
    gx = np.arange(0, iw - ww + 1, step)
    ys, xs = (a.reshape(-1) for a in np.meshgrid(gy, gx, indexing="ij"))

    # Variance normalization over the (1,1,w-2,h-2) norm rect, matching
    # OpenCV HaarEvaluator::setWindow: nf = area*sqsum - sum^2 (= area^2*var),
    # compare values against node_threshold * sqrt(nf).
    nrect = np.array([1, 1, ww - 2, wh - 2], np.float32)
    area = float((ww - 2) * (wh - 2))
    s = _rect_sums(ii, ys, xs, nrect)
    s2 = _rect_sums(sq, ys, xs, nrect)
    nf = area * s2 - s * s
    norm = np.sqrt(np.maximum(nf, 0.0))
    norm = np.where(nf > 0, norm, 1.0)

    for si in range(len(casc.stage_thresholds)):
        lo, hi = int(casc.stage_bounds[si]), int(casc.stage_bounds[si + 1])
        if ys.size == 0:
            break
        stage_sum = np.zeros(ys.shape, np.float64)
        for k in range(lo, hi):
            fi = int(casc.stump_feature[k])
            val = np.zeros(ys.shape, np.float64)
            for r in casc.rects[fi]:
                if r[4] != 0.0:
                    val += r[4] * _rect_sums(ii, ys, xs, r)
            right = val >= casc.stump_threshold[k] * norm
            stage_sum += np.where(right, casc.stump_leaves[k, 1],
                                  casc.stump_leaves[k, 0])
        keep = stage_sum >= casc.stage_thresholds[si]
        ys, xs, norm = ys[keep], xs[keep], norm[keep]
    return ys, xs


def group_rectangles(rects: Sequence[Tuple[float, float, float, float]],
                     min_neighbors: int = 3, eps: float = 0.2
                     ) -> List[Tuple[float, float, float, float]]:
    """Cluster similar rectangles and average each cluster, keeping clusters
    with > min_neighbors members (OpenCV groupRectangles semantics: two rects
    are similar when their corner deltas are within
    eps * 0.5 * (min(w1,w2) + min(h1,h2)))."""
    n = len(rects)
    if n == 0:
        return []
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    arr = np.asarray(rects, np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            delta = eps * 0.5 * (min(arr[i, 2], arr[j, 2]) +
                                 min(arr[i, 3], arr[j, 3]))
            if (abs(arr[i, 0] - arr[j, 0]) <= delta and
                    abs(arr[i, 1] - arr[j, 1]) <= delta and
                    abs(arr[i, 0] + arr[i, 2] - arr[j, 0] - arr[j, 2]) <= delta
                    and
                    abs(arr[i, 1] + arr[i, 3] - arr[j, 1] - arr[j, 3]) <= delta):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    clusters = {}
    for i in range(n):
        clusters.setdefault(find(i), []).append(i)
    out = []
    for members in clusters.values():
        if len(members) > min_neighbors:
            m = arr[members].mean(axis=0)
            out.append((float(m[0]), float(m[1]), float(m[2]), float(m[3])))
    return out


def detect_multiscale(gray: np.ndarray, casc: Optional[HaarCascade] = None,
                      scale_factor: float = 1.2, min_neighbors: int = 3,
                      cascade_path: Optional[str] = None
                      ) -> List[Tuple[float, float, float, float]]:
    """detectMultiScale equivalent: image pyramid (cascade at base scale on a
    downscaled image per level), grouped results in original coordinates."""
    if casc is None:
        path = cascade_path or _find_default_cascade()
        if path is None:
            raise FileNotFoundError(
                "no haarcascade_frontalface_alt.xml found; pass cascade_path")
        casc = parse_cascade(path)
    gray = np.asarray(gray)
    if gray.ndim == 3:
        gray = _bgr_to_gray(gray)
    h, w = gray.shape
    wh, ww = casc.window
    all_rects = []
    factor = 1.0
    while factor * wh <= h and factor * ww <= w:
        sw, sh = int(round(w / factor)), int(round(h / factor))
        if sh < wh or sw < ww:
            break
        scaled = _resize_linear(gray, (sw, sh))
        ii, sq = _integral(scaled)
        step = 1 if factor > 2.0 else 2
        ys, xs = _detect_single_scale(casc, ii, sq, step)
        for y, x in zip(ys, xs):
            all_rects.append((x * factor, y * factor,
                              ww * factor, wh * factor))
        factor *= scale_factor
    return group_rectangles(all_rects, min_neighbors)


class FaceDetectorOpenCV:
    """Drop-in equivalent of the reference FaceDetectorOpenCV: detect faces
    without body keypoints and enlarge each box 1.5x about its center
    (reference: src/openpose/face/faceDetectorOpenCV.cpp:38-62)."""

    def __init__(self, cascade_path: Optional[str] = None,
                 model_folder: Optional[str] = None):
        path = cascade_path or _find_default_cascade(model_folder)
        if path is None:
            raise FileNotFoundError(
                "haarcascade_frontalface_alt.xml not found under "
                f"--model_folder/{CASCADE_RELATIVE} or system OpenCV "
                "locations; pass cascade_path")
        self.cascade = parse_cascade(path)

    def detect_faces(self, image: np.ndarray) -> np.ndarray:
        """image: HWC BGR uint8/float.  Returns [faces, 4] (x, y, w, h)."""
        gray = _bgr_to_gray(image.astype(np.uint8))
        multiplier = 1.0
        while gray.shape[0] * gray.shape[1] > 640 * 360:
            gray = _pyr_down(gray)
            multiplier *= 2.0
        faces = detect_multiscale(gray, self.cascade, 1.2, 3)
        out = np.zeros((len(faces), 4), np.float32)
        for i, (x, y, fw, fh) in enumerate(faces):
            out[i] = ((x - 0.25 * fw) * multiplier,
                      (y - 0.25 * fh) * multiplier,
                      1.5 * fw * multiplier, 1.5 * fh * multiplier)
        return out
