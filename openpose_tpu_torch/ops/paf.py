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
  low-res net output, evaluated without materializing the upsample, by one
  of two backends, each with a hand-written kernel (`paf_cuda`):
  - fused (max_peaks > 32): geometry, sampling and scoring in one kernel;
    plain version `paf_scores_multiscale_reference`;
  - sampled (max_peaks <= 32, the people-capped budgets): geometry and
    scoring in torch ops around the sampling kernel; plain version of the
    sampler `sample_bicubic_scales_reference`.

The JAX package's `fast_peaks` tier ladder is TPU tuning and is not ported:
its output equals the untiered one.  Output: [N, P, K, K] float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

MAX_LINE_SAMPLES = 25
# `paf_scores_multiscale` takes the fused kernel above this peak budget and
# the sampled backend at or below it (the JAX package's rule, `paf.py:212`)
FUSED_MIN_PEAKS = 32
# samples per block of pairs in the sampled backend (64 MB per float32
# temporary)
SAMPLED_BLOCK_SAMPLES = 1 << 24


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
              default_nms_threshold: float,
              in_order: bool = True) -> torch.Tensor:
    """Per-sample projections [..., L] -> pair scores.  in_order: the
    samples are summed one at a time in line order, as the fused CUDA
    kernel sums them (its plain version must, to stay bit-equal); else in
    one reduction, a handful of launches instead of 125, for the sampled
    backend, which is held to no kernel's order."""
    h, w = hw
    if in_order:
        cnt = torch.zeros_like(geo["norm"])
        ssum = torch.zeros_like(geo["norm"])
        for l in range(MAX_LINE_SAMPLES):
            above = (proj[..., l] > inter_threshold) & (l < geo["n_samples"])
            cnt = cnt + above.to(torch.float32)
            ssum = ssum + torch.where(above, proj[..., l], 0.0)
    else:
        lm = torch.arange(MAX_LINE_SAMPLES, device=proj.device)
        above = (proj > inter_threshold) & (lm < geo["n_samples"][..., None])
        cnt = above.sum(dim=-1).to(torch.float32)
        ssum = torch.where(above, proj, 0.0).sum(dim=-1)
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


def _taps_from_source(src: torch.Tensor, in_size: int):
    """Catmull-Rom taps and weights at float source coordinates:
    t1 = clamp(floor(src), 0, in-1), the other taps clamped to the map, dx
    measured from the clamped t1 (cubicSequentialData + cubicInterpolate)."""
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


def _divisor(scale: float, device: torch.device) -> torch.Tensor:
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which can differ from the kernels' division in the last bit
    return torch.tensor(np.float32(scale), device=device)


def _cubic_taps(coord: torch.Tensor, in_size: int, scale: float):
    """Taps of integer target coordinates (held in float32) with the source
    coordinate of the fused TPU kernel (`paf_pallas.py::_paf_fused_kernel`)
    and of the fused CUDA kernel: src = coord / scale + (0.5 / scale - 0.5)."""
    src = coord / _divisor(scale, coord.device) \
        + float(np.float32(0.5 / scale - 0.5))
    return _taps_from_source(src, in_size)


def _half_pixel_taps(coord: torch.Tensor, in_size: int, scale: float):
    """Taps of integer target coordinates with the source coordinate of the
    TPU sampler (`paf_pallas.py::_tap_weights_t`), of `paf.py::_tap_matrix`
    and of the CUDA sampler: src = (coord + 0.5) / scale - 0.5.  Equal to
    `_cubic_taps`'s formula in exact arithmetic only."""
    src = (coord.to(torch.float32) + 0.5) / _divisor(scale, coord.device) - 0.5
    return _taps_from_source(src, in_size)


def _tap_sum(low: torch.Tensor, taps_y, wy, taps_x, wx,
             ws: int) -> torch.Tensor:
    """low [N, P, hs * ws] planes sampled at taps shaped [N, P, ...]: for
    each of the 4 rows, the sum of its 4 column taps in order, then the
    rows summed in order (the CUDA kernels' `sample_map`)."""
    n, p = low.shape[:2]
    out = None
    for r in range(4):
        acc = None
        for c in range(4):
            idx = taps_y[r] * ws + taps_x[c]
            val = torch.gather(low, 2, idx.reshape(n, p, -1)).reshape(idx.shape)
            term = wx[c] * val
            acc = term if acc is None else acc + term
        out = wy[r] * acc if out is None else out + wy[r] * acc
    return out


def sample_bicubic_reference(low_xy: torch.Tensor, my: torch.Tensor,
                             mx: torch.Tensor, scale_h: float,
                             scale_w: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sampling kernel (`paf_cuda.sample_bicubic`),
    the port of `paf_pallas.py::sample_bicubic_pallas` batched over frames.

    low_xy [N, P, 2, hs, ws] float32 (each pair's PAF x and y planes);
    my, mx [N, P, S] int32 pixels of the 8x-upsampled target grid.  Returns
    (vx, vy) [N, P, S]: the Catmull-Rom upsample of the planes at those
    pixels, target pixel c read at source (c + 0.5) / scale - 0.5."""
    n, p, _, hs, ws = low_xy.shape
    ty, wy = _half_pixel_taps(my, hs, scale_h)
    tx, wx = _half_pixel_taps(mx, ws, scale_w)
    low = low_xy.to(torch.float32).reshape(n, p, 2, hs * ws)
    return (_tap_sum(low[:, :, 0], ty, wy, tx, wx, ws),
            _tap_sum(low[:, :, 1], ty, wy, tx, wx, ws))


def sample_bicubic_scales_reference(
        lows: Sequence[torch.Tensor], my: torch.Tensor, mx: torch.Tensor,
        scales: Sequence[Tuple[float, float]]
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sampling kernel's multi-scale entry
    (`paf_cuda.sample_bicubic_scales`): `sample_bicubic_reference` of each
    scale's planes lows[s] [N, P, 2, hs, ws] by scales[s] = (scale_h,
    scale_w), summed in scale order."""
    acc_x = acc_y = None
    for low_xy, (scale_h, scale_w) in zip(lows, scales):
        vx, vy = sample_bicubic_reference(low_xy, my, mx, scale_h, scale_w)
        acc_x = vx if acc_x is None else acc_x + vx
        acc_y = vy if acc_y is None else acc_y + vy
    return acc_x, acc_y


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
            val += _tap_sum(low, ty, wy, tx, wx, ws)
    proj = (geo["ux"][..., None] * valx + geo["uy"][..., None] * valy) \
        * float(np.float32(1.0 / len(sources)))
    return _finalize(proj, geo, target_hw, inter_threshold,
                     inter_min_above_threshold, default_nms_threshold)


def sampler_args(sources: Sequence[torch.Tensor],
                 scale_ratios: Sequence[float], target_hw: Tuple[int, int],
                 geo: Dict[str, torch.Tensor], map_idx: torch.Tensor):
    """The sampler's arguments for the sampled backend, all scales at once:
    (lows, my, mx, scales) with lows[s] [N, P, 2, hs, ws] the x/y planes of
    the pairs of `geo` (`_line_geometry`) by their map_idx rows, my, mx
    [N, P, K * K * L] int32 and scales[s] = (scale_h, scale_w)."""
    n, p = geo["my"].shape[:2]
    my = geo["my"].to(torch.int32).reshape(n, p, -1)
    mx = geo["mx"].to(torch.int32).reshape(n, p, -1)
    mi = map_idx.long()
    lows = []
    for src in sources:
        chans = src.to(torch.float32).permute(0, 3, 1, 2)   # [N, C, hs, ws]
        lows.append(torch.stack([chans[:, mi[:, 0]], chans[:, mi[:, 1]]],
                                dim=2).contiguous())
    return lows, my, mx, _scale_factors(sources, scale_ratios, target_hw)


def paf_scores_sampled(
        sources: Sequence[torch.Tensor], scale_ratios: Sequence[float],
        target_hw: Tuple[int, int], peaks: torch.Tensor, pairs: torch.Tensor,
        map_idx: torch.Tensor, inter_threshold: float,
        inter_min_above_threshold: float,
        default_nms_threshold: float) -> torch.Tensor:
    """The unfused backend, counterpart of the non-Pallas branch of
    `paf.py::_multiscale_impl`: line geometry, then the sampler
    (`paf_cuda.sample_bicubic_scales`: every pair's x/y maps of all scales
    in one launch, summed over scales in order), scaled by 1 / n_scales,
    then the same finalize.

    Blocked over pairs, as JAX's `lax.map` is, so that the per-sample
    temporaries stay near `SAMPLED_BLOCK_SAMPLES` (at K = 127, batch 8 one
    pair alone has 3.2M samples)."""
    from openpose_tpu_torch.ops import paf_cuda
    n, p, k = peaks.shape[0], pairs.shape[0], peaks.shape[2] - 1
    block = max(1, SAMPLED_BLOCK_SAMPLES // max(1, n * k * k * MAX_LINE_SAMPLES))
    inv = float(np.float32(1.0 / len(sources)))
    out = []
    for p0 in range(0, p, block):
        geo = _line_geometry(peaks, pairs[p0:p0 + block], target_hw)
        shape = geo["mx"].shape                        # [N, p, K, K, L]
        acc_x, acc_y = paf_cuda.sample_bicubic_scales(*sampler_args(
            sources, scale_ratios, target_hw, geo, map_idx[p0:p0 + block]))
        proj = (geo["ux"][..., None] * (acc_x * inv).reshape(shape)
                + geo["uy"][..., None] * (acc_y * inv).reshape(shape))
        out.append(_finalize(proj, geo, target_hw, inter_threshold,
                             inter_min_above_threshold,
                             default_nms_threshold, in_order=False))
    return torch.cat(out, dim=1)


def paf_scores_multiscale(
        sources: Sequence[torch.Tensor], scale_ratios: Sequence[float],
        target_hw: Tuple[int, int], peaks: torch.Tensor, pairs: torch.Tensor,
        map_idx: torch.Tensor, inter_threshold: float,
        inter_min_above_threshold: float,
        default_nms_threshold: float,
        use_fused: Optional[bool] = None) -> torch.Tensor:
    """Pair scores from per-scale low-res net outputs [N, h_s, w_s, C].

    The sampled value is the mean over scales of the Catmull-Rom upsample
    that `resize.upsample_merge` would produce at that pixel.  `use_fused`
    picks the backend: the fused kernel (`paf_cuda.paf_scores_fused`) or
    the sampled one (`paf_scores_sampled`); None applies the JAX package's
    rule, fused when max_peaks > `FUSED_MIN_PEAKS` (`paf.py:212`).  This is
    the one place that routes between the two; each kernel wrapper then
    takes CUDA tensors to its kernel and CPU tensors to its plain version."""
    if use_fused is None:
        use_fused = peaks.shape[2] - 1 > FUSED_MIN_PEAKS
    if not use_fused:
        return paf_scores_sampled(
            sources, scale_ratios, target_hw, peaks, pairs, map_idx,
            inter_threshold, inter_min_above_threshold,
            default_nms_threshold)
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
