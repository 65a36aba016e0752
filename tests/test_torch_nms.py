"""Port NMS vs the scalar oracle and the JAX package (CPU, float32).

Counts must be equal and the raw peak scores (which pick out the peak
pixels) exact; refined x/y agree to the JAX suite's rtol = atol = 1e-4
(7x7 centroid sums in another order)."""

import numpy as np
import pytest
import torch

from openpose_tpu.ops import nms as jnms
from openpose_tpu_torch import synthetic
from openpose_tpu_torch.ops import nms, paf, resize
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
from tests import oracle


def _random_heat(h, w, n_blobs, seed):
    rng = np.random.RandomState(seed)
    heat = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(n_blobs):
        cy, cx = rng.uniform(2, h - 3), rng.uniform(2, w - 3)
        amp = rng.uniform(0.3, 1.0)
        heat += amp * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 4.0)
    heat += rng.uniform(-0.02, 0.02, heat.shape).astype(np.float32)
    return heat.astype(np.float32)


def _port(heat, threshold=0.05, max_peaks=127, offset=(0.5, 0.5)):
    return nms.nms(torch.from_numpy(heat[None, :, :, None]), threshold,
                   max_peaks, offset)[0, 0].numpy()


def _assert_same_peaks(got, want):
    assert got[0, 0] == want[0, 0], "peak count mismatch"
    n = int(want[0, 0])
    np.testing.assert_array_equal(got[1:n + 1, 2], want[1:n + 1, 2])
    np.testing.assert_allclose(got[1:n + 1], want[1:n + 1],
                               rtol=1e-4, atol=1e-4)
    assert not got[n + 1:].any(), "empty slots must be zero"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_oracle(seed):
    heat = _random_heat(40, 56, 6, seed)
    _assert_same_peaks(_port(heat), oracle.nms_oracle(heat, 0.05, 127))


@pytest.mark.parametrize("seed", [0, 3])
def test_full_budget_matches_oracle_and_jax(seed):
    heat = _random_heat(72, 104, 110, seed)
    want = oracle.nms_oracle(heat, 0.05, 127)
    assert want[0, 0] > 48
    got = _port(heat)
    _assert_same_peaks(got, want)
    jax_out = np.asarray(jnms.nms(heat[None, :, :, None], 0.05, 127,
                                  fast_peaks=()))[0, 0]
    _assert_same_peaks(got, jax_out)


def test_border_rules():
    heat = np.zeros((12, 12), np.float32)
    heat[1, 1] = 0.5                  # first inner ring: >= rule
    assert _port(heat, max_peaks=10)[0, 0] == 1
    heat2 = np.zeros((12, 12), np.float32)
    heat2[0, 5] = 0.9                 # outer ring: never a peak
    assert _port(heat2, max_peaks=10)[0, 0] == 0
    heat3 = np.zeros((12, 12), np.float32)
    heat3[5, 5] = heat3[5, 6] = 0.7   # interior plateau: strict > fails
    assert _port(heat3, max_peaks=10)[0, 0] == 0


def test_max_peaks_cap_keeps_row_major_order():
    heat = np.zeros((30, 30), np.float32)
    for y in range(2, 28, 3):
        for x in range(2, 28, 3):
            heat[y, x] = 1.0
    got = _port(heat, max_peaks=5)
    np.testing.assert_allclose(got, oracle.nms_oracle(heat, 0.05, 5),
                               atol=1e-5)


def test_batched_channels_and_offset_match_jax():
    """[N, H, W, C] input with a non-default offset, per (n, c) slot layout."""
    heat = np.stack([np.stack([_random_heat(24, 40, 4, 10 * b + c)
                               for c in range(3)], -1) for b in range(2)])
    want = np.asarray(jnms.nms(heat, 0.1, 16, offset=(1.25, 1.25),
                               fast_peaks=()))
    got = nms.nms(torch.from_numpy(heat), 0.1, 16, (1.25, 1.25)).numpy()
    assert got.shape == want.shape == (2, 3, 17, 3)
    np.testing.assert_array_equal(got[:, :, 0], want[:, :, 0])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scene, lo, hi", [
    ("noise", 127, 127), ("crowd_32", 16, 40), ("people_8", 4, 12)],
    ids=["noise", "crowd_32", "people_8"])
def test_worst_case_fills_every_part_at_the_published_size(scene, lo, hi):
    """BODY_25 net outputs at 368x656 (46x82 maps), merged and NMS'd at
    0.05 with 127 slots: uniform noise in [-1, 1) fills all 127 slots of
    every part, while rendered people give far fewer peaks a part (a crowd
    of 32 `random_people`, or 8)."""
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    hw = (368, 656)
    if scene == "noise":
        src = np.random.RandomState(3).uniform(
            -1, 1, (1, hw[0] // 8, hw[1] // 8, info.heatmap_channels))
    else:
        n, spacing = (32, 30.0) if scene == "crowd_32" else (8, 90.0)
        people = synthetic.random_people(np.random.RandomState(100), n, hw,
                                         min_spacing=spacing)
        pairs, map_idx = paf.pair_tables(info)
        src = synthetic.make_targets(people[None], pairs, map_idx, hw,
                                     info.num_parts, info.heatmap_channels)
    src = torch.from_numpy(np.asarray(src, np.float32))
    merged = resize.resize_bicubic(src[..., :info.num_parts], hw)
    counts = nms.nms(merged, 0.05, 127)[0, :, 0, 0]
    if scene == "noise":
        assert bool((counts == 127).all()), counts
    else:
        assert lo <= float(counts.mean()) <= hi, counts
