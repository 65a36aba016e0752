"""Per-channel argmax decode of single-person (face, hand) net outputs.

Counterpart of `openpose_tpu/ops/maximum.py` (maximumBase.cpp:7-55): for
each channel, the (x, y) of the first row-major maximum and its value.
`channel_argmax_refined` gives the argmax of the 8x Catmull-Rom upsample
from a window around the coarse peak instead of the full upsample, exactly
as the JAX function does (the two differ from a full upsample only near the
border or for far secondary modes, and the port holds the windowed result).
`torch.argmax` returns the first maximum, as `jnp.argmax` does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openpose_tpu_torch.ops import resize


def channel_argmax(heatmaps: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, C, 3] (x, y, score), first max in row-major order."""
    n, h, w, c = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(n, c, h * w)
    idx = torch.argmax(flat, dim=-1)
    score = torch.gather(flat, 2, idx[..., None])[..., 0]
    x = (idx % w).to(torch.float32)
    y = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    return torch.stack([x, y, score.to(torch.float32)], dim=-1)


_WIN = 9            # map-px window, half-width 4 around the coarse peak


def _win_params(upsample: int):
    """(up_lo, up_n): local upsampled px j in [up * c + up_lo,
    up * c + up_lo + up_n), +-1.5..2.5 map px around the coarse peak."""
    return -(3 * upsample) // 2, 4 * upsample


@functools.lru_cache(maxsize=None)
def _window_cubic_matrix(upsample: int) -> np.ndarray:
    """[up_n, _WIN] Catmull-Rom weights: local upsampled px u (global
    j = upsample * c + up_lo + u) sampled at map coordinate
    (j + 0.5) / up - 0.5, relative to window row 0 (map row c - 4).  All
    taps fall inside the window, so the matrix does not depend on c."""
    up_lo, up_n = _win_params(upsample)
    u = np.arange(up_n, dtype=np.float64)
    rel = (u + up_lo + 0.5) / upsample - 0.5 + (_WIN - 1) / 2
    t1 = np.floor(rel).astype(np.int64)
    if (t1 - 1).min() < 0 or (t1 + 2).max() >= _WIN:
        raise ValueError(f"cubic taps escape the {_WIN}-px window for "
                         f"upsample={upsample}")
    w4 = resize._cubic_weights(rel - t1, a=-0.5)
    mat = np.zeros((up_n, _WIN), dtype=np.float64)
    for i in range(4):
        np.add.at(mat, (np.arange(up_n), t1 - 1 + i), w4[:, i])
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window_cubic_tensor(upsample: int, device: torch.device) -> torch.Tensor:
    """`_window_cubic_matrix` on a device, copied there once (a copy from
    host memory on every call would wait for the card)."""
    return torch.from_numpy(_window_cubic_matrix(upsample)).to(device)


def channel_argmax_refined(maps: torch.Tensor,
                           upsample: int = 8) -> torch.Tensor:
    """[N, h, w, C] net-output maps -> [N, C, 3] (x, y, score) in upsampled
    (crop) pixels: coarse per-channel argmax, a 9x9 map window around it
    (edge-clamped), Catmull-Rom-upsampled to 32x32 covering +-2 map px,
    then the window's argmax.  float32 throughout."""
    n, h, w, c = maps.shape
    chw = maps.to(torch.float32).permute(0, 3, 1, 2)         # [n, c, h, w]
    idx = torch.argmax(chw.reshape(n, c, h * w), dim=-1)
    cx = idx % w                                             # [n, c]
    cy = torch.div(idx, w, rounding_mode="floor")

    offs = torch.arange(-(_WIN // 2), _WIN // 2 + 1, device=maps.device)
    ys = torch.clamp(cy[..., None] + offs, 0, h - 1)         # [n, c, 9]
    xs = torch.clamp(cx[..., None] + offs, 0, w - 1)
    rows = torch.gather(chw, 2, ys[..., None].expand(n, c, _WIN, w))
    patch = torch.gather(rows, 3, xs[:, :, None, :].expand(n, c, _WIN, _WIN))

    up_lo, up_n = _win_params(upsample)
    wmat = _window_cubic_tensor(upsample, maps.device)
    resize._require_full_f32(patch)
    up = torch.matmul(torch.matmul(wmat, patch), wmat.T)     # [n, c, U, U]
    uflat = up.reshape(n, c, up_n * up_n)
    uidx = torch.argmax(uflat, dim=-1)
    score = torch.gather(uflat, 2, uidx[..., None])[..., 0]
    uy = torch.div(uidx, up_n, rounding_mode="floor")
    ux = uidx % up_n
    x = torch.clamp(cx * upsample + up_lo + ux, 0, w * upsample - 1)
    y = torch.clamp(cy * upsample + up_lo + uy, 0, h * upsample - 1)
    return torch.stack([x.to(torch.float32), y.to(torch.float32), score],
                       dim=-1)
