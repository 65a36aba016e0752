"""NMS peak extraction: 3x3 local maxima + 7x7 sub-pixel refinement.

Counterpart of `openpose_tpu/ops/nms.py::nms`, with the reference's
semantics (nmsBase.cpp / nmsBase.cu):

* interior pixels (1 < x < W-2, 1 < y < H-2): a peak iff above the
  threshold and strictly greater than all 8 neighbours;
* first inner ring (x == 1 | x == W-2 | y == 1 | y == H-2): ``>=`` against
  the neighbours, with missing neighbours taken as the threshold;
* no other pixel is a peak.  A pixel of the outer ring that lies on an
  inner-ring line is a candidate by the ``>=`` rule: (y=0, x=1) is one;
* peaks in row-major order, capped at `max_peaks`;
* refinement: score-weighted centroid of max(heat, 0) over the 7x7 window
  clipped at the map edge, plus `offset`; the reported score is the raw
  peak value.  Empty slots are zero.

Output: [N, C, max_peaks+1, 3] float32, the count in [n, c, 0, 0].

* `plain`: PyTorch operations, the arithmetic the kernels are held to bit
  for bit.  The JAX version's TPU shapes (tier ladder, band matmuls,
  searchsorted compaction) are not carried over: compaction is a
  cumulative sum of the peak mask plus a scatter into the slots, and
  refinement gathers the 49 window values per peak: no sort, and no host
  synchronisation.
* `nms`: on a float32 CUDA tensor (`fuses`), the hand-written kernels of
  `kernels/nms.cu`, which replace no TPU kernel (the JAX package's NMS is
  plain jnp): one pass over the NHWC maps marks each row's peaks a channel
  in a bit mask, a block a part then counts and scans the rows and places
  the peaks of the rows below the cap in row-major order with their 7x7
  windows; the windows' three sums are PyTorch's own `sum(-1)`, as in
  `plain`, and a last kernel divides and adds the offset.  Elsewhere (CPU
  tensors, other dtypes) it runs `plain`.  On a CUDA tensor it launches
  the kernels or raises; it never falls back.  Each call counts
  `nms.fused` or `nms.plain` in the tracer (`utils/profiler.py::TRACE`)
  when it runs on the host (an eager call or a graph's capture);
  `nms.launches` counts the kernels' calls on the device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from openpose_tpu_torch.kernels import build
from openpose_tpu_torch.utils.profiler import TRACE

FUSED, PLAIN = "nms.fused", "nms.plain"
WINDOW = 49             # the 7x7 refinement window's samples


def fuses(heatmaps: torch.Tensor) -> bool:
    """Whether `nms` launches the kernels on heatmaps: a float32 CUDA
    tensor."""
    return heatmaps.is_cuda and heatmaps.dtype == torch.float32


def nms(heatmaps: torch.Tensor, threshold: float, max_peaks: int = 127,
        offset: Tuple[float, float] = (0.5, 0.5)) -> torch.Tensor:
    """Peaks of [N, H, W, C] part heatmaps -> [N, C, max_peaks+1, 3]:
    `plain`'s result, computed by the kernels where `fuses(heatmaps)`."""
    if not fuses(heatmaps):
        TRACE.count(PLAIN)
        return plain(heatmaps, threshold, max_peaks, offset)
    TRACE.count(FUSED)
    heat = heatmaps.contiguous()
    if heat.data_ptr() % 16:        # the kernel copies 16-byte pieces
        heat = heat.clone()
    return _fused(heat, threshold, max_peaks, offset)


def _fused(heat: torch.Tensor, threshold: float, max_peaks: int,
           offset: Tuple[float, float]) -> torch.Tensor:
    if heat.ndim != 4:
        raise ValueError(f"heatmaps must be [N, H, W, C], got "
                         f"{tuple(heat.shape)}")
    if max_peaks < 0:
        raise ValueError(f"max_peaks must be >= 0, got {max_peaks}")
    n, h, w, c = heat.shape
    peaks = heat.new_empty((n, c, max_peaks + 1, 3))
    # the windows of max(heat, 0) and their products with x and with y
    windows = [heat.new_empty((n, c, max_peaks, WINDOW)) for _ in range(3)]
    # each row's peaks a channel, a bit a pixel
    masks = heat.new_empty((n, c, h, -(-w // 32)), dtype=torch.int32)
    _place(heat, masks, threshold, peaks, windows)
    _refine_slots([t.sum(-1) for t in windows], peaks, offset)
    return peaks


def _place(heat: torch.Tensor, masks: torch.Tensor, threshold: float,
           peaks: torch.Tensor, windows: Sequence[torch.Tensor]) -> None:
    """`nms_mark_kernel` and `nms_place_kernel`: the header and values of
    peaks, and the windows, for the kept slots."""
    n, h, w, c = heat.shape
    lib = build.library()
    code = lib.nms_peaks_launch(
        heat.data_ptr(), masks.data_ptr(), peaks.data_ptr(),
        *(t.data_ptr() for t in windows), n, h, w, c, peaks.shape[2] - 1,
        threshold, heat.device.index or 0,
        torch.cuda.current_stream(heat.device).cuda_stream)
    build.check(lib, code, "nms kernels launch")
    nms.launches += 1


def _refine_slots(sums: Sequence[torch.Tensor], peaks: torch.Tensor,
                  offset: Tuple[float, float]) -> None:
    """`nms_refine_kernel`: each kept slot's x and y from the windows'
    sums [N, C, K]: sum(w * x) / (sum(w) > 0 ? sum(w) : 1) + offset."""
    lib = build.library()
    code = lib.nms_refine_launch(
        *(t.data_ptr() for t in sums), peaks.data_ptr(), sums[0].numel(),
        peaks.shape[2] - 1, offset[0], offset[1], peaks.device.index or 0,
        torch.cuda.current_stream(peaks.device).cuda_stream)
    build.check(lib, code, "nms_refine_kernel launch")


nms.launches = 0


def plain(heatmaps: torch.Tensor, threshold: float, max_peaks: int = 127,
          offset: Tuple[float, float] = (0.5, 0.5)) -> torch.Tensor:
    """Peaks of [N, H, W, C] part heatmaps -> [N, C, max_peaks+1, 3] in
    PyTorch operations."""
    heat = heatmaps.to(torch.float32).permute(0, 3, 1, 2)   # [N, C, H, W]
    n, c, h, w = heat.shape
    padded = F.pad(heat, (1, 1, 1, 1), value=float(threshold))
    gt_all = torch.ones_like(heat, dtype=torch.bool)
    ge_all = torch.ones_like(heat, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = padded[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            gt_all &= heat > nb
            ge_all &= heat >= nb
    ys = torch.arange(h, device=heat.device)[:, None]
    xs = torch.arange(w, device=heat.device)[None, :]
    interior = (xs > 1) & (xs < w - 2) & (ys > 1) & (ys < h - 2)
    inner = (xs == 1) | (xs == w - 2) | (ys == 1) | (ys == h - 2)
    is_peak = (heat > threshold) & ((interior & gt_all) | (inner & ge_all))

    # Compaction: the k-th peak in row-major order goes to slot k-1; peaks
    # past the cap and non-peaks go to a dump slot that is then dropped.
    flat = is_peak.reshape(n, c, h * w)
    rank = torch.cumsum(flat, dim=-1, dtype=torch.int32)     # 1-based
    slot = torch.where(flat & (rank <= max_peaks), rank - 1, max_peaks).long()
    pix = torch.arange(h * w, device=heat.device).expand(n, c, h * w)
    peak_idx = torch.zeros((n, c, max_peaks + 1), dtype=torch.long,
                           device=heat.device)
    peak_idx.scatter_(2, slot, pix)
    peak_idx = peak_idx[:, :, :max_peaks]
    count = torch.clamp(rank[:, :, -1], max=max_peaks)       # [N, C]
    valid = (torch.arange(max_peaks, device=heat.device)
             < count[:, :, None])                            # [N, C, K]
    peak_idx = torch.where(valid, peak_idx, 0)

    x_ref, y_ref, value = _refine(heat, peak_idx, offset)
    peaks = torch.stack([x_ref, y_ref, value], dim=-1)
    peaks = torch.where(valid[..., None], peaks, 0.0)
    header = torch.zeros((n, c, 1, 3), dtype=torch.float32, device=heat.device)
    header[:, :, 0, 0] = count.to(torch.float32)
    return torch.cat([header, peaks], dim=2)


def _refine(heat: torch.Tensor, peak_idx: torch.Tensor,
            offset: Tuple[float, float]):
    """7x7 score-weighted centroid of max(heat, 0) around each peak.

    heat [N, C, H, W]; peak_idx [N, C, K] flat pixel indices.  Zero padding
    of the positive part adds nothing to the sums, which clips the window
    at the map edge like the reference's skipped samples."""
    n, c, h, w = heat.shape
    r = 3
    wp = w + 2 * r
    hpos = F.pad(torch.clamp(heat, min=0.0), (r, r, r, r)).reshape(n, c, -1)
    py = torch.div(peak_idx, w, rounding_mode="floor")
    px = peak_idx - py * w
    d = torch.arange(-r, r + 1, device=heat.device)
    dy = d.repeat_interleave(2 * r + 1)                      # [49]
    dx = d.repeat(2 * r + 1)
    wy = py[..., None] + dy                                  # [N, C, K, 49]
    wx = px[..., None] + dx
    window = torch.gather(
        hpos, 2, ((wy + r) * wp + (wx + r)).reshape(n, c, -1)
    ).reshape(wy.shape)
    s = window.sum(-1)
    sx = (window * wx.to(torch.float32)).sum(-1)
    sy = (window * wy.to(torch.float32)).sum(-1)
    denom = torch.where(s > 0, s, 1.0)
    value = torch.gather(heat.reshape(n, c, -1), 2, peak_idx)
    return sx / denom + offset[0], sy / denom + offset[1], value
