"""PAF line-integral pair scoring.

Counterpart of `openpose_tpu/ops/paf.py`.  For every limb pair (A, B) and
every peak combination (i, j), sample the PAF along the A->B segment, count
the samples whose projection on the unit AB vector exceeds
`inter_threshold`, and average them when enough of the line agrees
(the reference's pafScoreKernel, bodyPartConnectorBase.cu).

* `paf_scores`: the full-resolution backend, gathering from a materialized
  merged heatmap `[N, H, W, C]`.
* `paf_scores_multiscale`: the production path.  The merged 8x-upsampled PAF
  at an integer pixel is a 4x4-tap Catmull-Rom combination of each scale's
  low-res net output, evaluated without materializing the upsample.  It
  calls the kernel wrapper (`paf_cuda`), which launches the hand-written
  kernel on a CUDA tensor and runs `paf_scores_multiscale_reference`, the
  kernel's plain PyTorch version, on a CPU tensor.

The JAX package's `fast_peaks` tier ladder and its occupancy routing between
the Pallas kernel and the tap-matrix backend are TPU tuning and are not
ported.  Output: [N, P, K, K] float32.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

MAX_LINE_SAMPLES = 25


def _line_geometry(peaks: torch.Tensor, pairs: torch.Tensor,
                   hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Per-(pair, i, j) line quantities and float sample pixels [..., L]."""
    h, w = hw
    counts = peaks[:, :, 0, 0]                       # [N, parts]
    coords = peaks[:, :, 1:, :]                      # [N, parts, K, 3]
    k = coords.shape[2]
    a_part, b_part = pairs[:, 0].long(), pairs[:, 1].long()
    ca, cb = coords[:, a_part], coords[:, b_part]    # [N, P, K, 3]
    ax, ay = ca[..., 0][..., :, None], ca[..., 1][..., :, None]
    bx, by = cb[..., 0][..., None, :], cb[..., 1][..., None, :]
    vx, vy = bx - ax, by - ay                        # [N, P, K, K]
    linf = torch.maximum(vx.abs(), vy.abs())
    n_samples = torch.clamp(torch.floor(torch.sqrt(5.0 * linf) + 0.5), 5, 25)
    norm = torch.sqrt(vx * vx + vy * vy)
    safe_norm = torch.where(norm > 1e-6, norm, 1.0)

    lm = torch.arange(MAX_LINE_SAMPLES, dtype=torch.float32,
                      device=peaks.device)
    stepx = (vx / n_samples)[..., None]
    stepy = (vy / n_samples)[..., None]
    mx = torch.clamp(torch.floor(ax[..., None] + lm * stepx + 0.5), 0, w - 1)
    my = torch.clamp(torch.floor(ay[..., None] + lm * stepy + 0.5), 0, h - 1)

    ki = torch.arange(k, dtype=torch.float32, device=peaks.device)
    valid = ((ki[:, None] < counts[:, a_part][..., None, None])
             & (ki[None, :] < counts[:, b_part][..., None, None]))
    return dict(mx=mx, my=my, ux=vx / safe_norm, uy=vy / safe_norm,
                n_samples=n_samples, norm=norm, valid=valid)


def _finalize(proj: torch.Tensor, geo: Dict[str, torch.Tensor],
              hw: Tuple[int, int], inter_threshold: float,
              inter_min_above_threshold: float,
              default_nms_threshold: float) -> torch.Tensor:
    """Per-sample projections [..., L] -> pair scores.  The samples are
    summed one at a time in line order, as the CUDA kernel sums them."""
    h, w = hw
    cnt = torch.zeros_like(geo["norm"])
    ssum = torch.zeros_like(geo["norm"])
    for l in range(MAX_LINE_SAMPLES):
        above = (proj[..., l] > inter_threshold) & (l < geo["n_samples"])
        cnt = cnt + above.to(torch.float32)
        ssum = ssum + torch.where(above, proj[..., l], 0.0)
    accepted = cnt / geo["n_samples"] > inter_min_above_threshold
    score = torch.where(accepted, ssum / torch.clamp(cnt, min=1.0), -1.0)
    close_thr = float(np.sqrt(float(w * h)) / 150.0)
    fallback = ~accepted & (geo["norm"] < close_thr)
    score = torch.where(fallback, default_nms_threshold + 1e-6, score)
    score = torch.where(geo["norm"] > 1e-6, score, -1.0)
    return torch.where(geo["valid"], score, -1.0)


def paf_scores(heatmaps: torch.Tensor, peaks: torch.Tensor,
               pairs: torch.Tensor, map_idx: torch.Tensor,
               inter_threshold: float, inter_min_above_threshold: float,
               default_nms_threshold: float) -> torch.Tensor:
    """Full-resolution backend: gather from a materialized [N, H, W, C] map;
    map_idx [P, 2] holds absolute PAF channel indices."""
    heat = heatmaps.to(torch.float32)
    n, h, w, c = heat.shape
    geo = _line_geometry(peaks, pairs, (h, w))
    flat = (geo["my"] * w + geo["mx"]).long()        # [N, P, K, K, L]
    p = pairs.shape[0]
    heat_c = heat.permute(0, 3, 1, 2).reshape(n, c, h * w)
    flat2 = flat.reshape(n, p, -1)
    vals = []
    for col in (0, 1):
        chan = heat_c[:, map_idx[:, col].long()]     # [N, P, H*W]
        vals.append(torch.gather(chan, 2, flat2).reshape(flat.shape))
    proj = geo["ux"][..., None] * vals[0] + geo["uy"][..., None] * vals[1]
    return _finalize(proj, geo, (h, w), inter_threshold,
                     inter_min_above_threshold, default_nms_threshold)


def _cubic_taps(coord: torch.Tensor, in_size: int, scale: float):
    """Catmull-Rom taps and weights of integer target coordinates.

    Tap source coordinate src = coord / scale + (0.5 / scale - 0.5), the
    formula of the TPU kernel (`paf_pallas.py`) and of the CUDA kernel;
    `paf.py::_tap_matrix` in the JAX package writes (coord + 0.5) / scale -
    0.5, equal in exact arithmetic.  t1 = clamp(floor(src), 0, in-1), the
    other taps clamped, dx measured from the clamped t1."""
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which can differ from the kernel's division in the last bit
    divisor = torch.tensor(np.float32(scale), device=coord.device)
    src = coord / divisor + float(np.float32(0.5 / scale - 0.5))
    t1 = torch.clamp(torch.floor(src), 0, in_size - 1)
    d = src - t1
    d2 = d * d
    d3 = d2 * d
    weights = (-0.5 * d3 + d2 - 0.5 * d,
               1.5 * d3 - 2.5 * d2 + 1.0,
               -1.5 * d3 + 2.0 * d2 + 0.5 * d,
               0.5 * d3 - 0.5 * d2)
    t1i = t1.long()
    t2i = torch.clamp(t1i + 1, max=in_size - 1)
    taps = (torch.clamp(t1i - 1, min=0), t1i, t2i,
            torch.clamp(t2i + 1, max=in_size - 1))
    return taps, weights


def _scale_factors(sources: Sequence[torch.Tensor],
                   scale_ratios: Sequence[float],
                   target_hw: Tuple[int, int]):
    """Per-scale ((th / h0) / rel, (tw / w0) / rel), rel = s_i / s_0."""
    th, tw = target_hw
    h0, w0 = sources[0].shape[1], sources[0].shape[2]
    out = []
    for ratio in scale_ratios:
        rel = ratio / scale_ratios[0]
        out.append(((th / h0) / rel, (tw / w0) / rel))
    return out


def paf_scores_multiscale_reference(
        sources: Sequence[torch.Tensor], scale_ratios: Sequence[float],
        target_hw: Tuple[int, int], peaks: torch.Tensor, pairs: torch.Tensor,
        map_idx: torch.Tensor, inter_threshold: float,
        inter_min_above_threshold: float,
        default_nms_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of the PAF scoring kernel (`paf_cuda`).

    Same function, same operation order: for each sample, 4 row taps of 4
    column-tap sums per map, summed over scales, projected on the unit AB
    vector, then divided by the number of scales.  Combinations past the
    largest peak count score -1 by construction, so only the leading block
    is computed (which reads the counts on the host)."""
    n, p, k = peaks.shape[0], pairs.shape[0], peaks.shape[2] - 1
    used = min(k, int(peaks[:, :, 0, 0].max())) if peaks.numel() else 0
    out = torch.full((n, p, k, k), -1.0, device=peaks.device)
    if used > 0:
        out[:, :, :used, :used] = _reference_block(
            sources, scale_ratios, target_hw, peaks[:, :, :used + 1], pairs,
            map_idx, inter_threshold, inter_min_above_threshold,
            default_nms_threshold)
    return out


def _reference_block(sources, scale_ratios, target_hw, peaks, pairs, map_idx,
                     inter_threshold, inter_min_above_threshold,
                     default_nms_threshold) -> torch.Tensor:
    th, tw = target_hw
    geo = _line_geometry(peaks, pairs, (th, tw))
    n, p = geo["mx"].shape[:2]
    valx = torch.zeros_like(geo["mx"])
    valy = torch.zeros_like(geo["mx"])
    for src, (scale_h, scale_w) in zip(
            sources, _scale_factors(sources, scale_ratios, target_hw)):
        hs, ws = src.shape[1], src.shape[2]
        chans = src.to(torch.float32).permute(0, 3, 1, 2)   # [N, C, hs, ws]
        ty, wy = _cubic_taps(geo["my"], hs, scale_h)
        tx, wx = _cubic_taps(geo["mx"], ws, scale_w)
        for col, val in ((0, valx), (1, valy)):
            low = chans[:, map_idx[:, col].long()].reshape(n, p, hs * ws)
            v = torch.zeros_like(val)
            for r in range(4):
                acc = None
                for c in range(4):
                    idx = (ty[r] * ws + tx[c]).reshape(n, p, -1)
                    term = wx[c] * torch.gather(low, 2, idx).reshape(val.shape)
                    acc = term if acc is None else acc + term
                v = v + wy[r] * acc
            val += v
    proj = (geo["ux"][..., None] * valx + geo["uy"][..., None] * valy) \
        * float(np.float32(1.0 / len(sources)))
    return _finalize(proj, geo, target_hw, inter_threshold,
                     inter_min_above_threshold, default_nms_threshold)


def paf_scores_multiscale(
        sources: Sequence[torch.Tensor], scale_ratios: Sequence[float],
        target_hw: Tuple[int, int], peaks: torch.Tensor, pairs: torch.Tensor,
        map_idx: torch.Tensor, inter_threshold: float,
        inter_min_above_threshold: float,
        default_nms_threshold: float) -> torch.Tensor:
    """Pair scores from per-scale low-res net outputs [N, h_s, w_s, C].

    The sampled value is the mean over scales of the Catmull-Rom upsample
    that `resize.upsample_merge` would produce at that pixel.  The kernel
    wrapper takes CUDA tensors to the kernel (and raises on anything it
    cannot take) and CPU tensors to the plain version."""
    # imported here: the wrapper's CPU route is this module's plain version
    from openpose_tpu_torch.ops import paf_cuda
    return paf_cuda.paf_scores_fused(
        sources, scale_ratios, target_hw, peaks, pairs, map_idx,
        inter_threshold, inter_min_above_threshold, default_nms_threshold)


def pair_tables(info) -> Tuple[np.ndarray, np.ndarray]:
    """(pairs [P, 2], absolute map_idx [P, 2]) int32 tables for a model;
    map_idx is offset by parts + background as in BodyPartConnectorCaffe.
    Raises if an entry indexes outside the model's parts or channels."""
    pairs = np.asarray(info.pairs, np.int32).reshape(-1, 2)
    midx = (np.asarray(info.map_idx, np.int32).reshape(-1, 2)
            + info.paf_channel_offset)
    if ((pairs < 0) | (pairs >= info.num_parts)).any() \
            or ((midx < 0) | (midx >= info.heatmap_channels)).any():
        raise ValueError(f"{info.name}: pairs or map_idx index outside the "
                         f"{info.num_parts} parts or {info.heatmap_channels} "
                         f"channels")
    return pairs, midx
