"""Port PAF scoring vs the JAX package (CPU, float32).

`paf_scores_multiscale_reference` is the plain version of the CUDA kernel;
on CPU tensors `paf_scores_multiscale` and the kernel wrapper run it.  It is
held against the JAX Pallas kernel in interpret mode at HIGHEST precision
and against the JAX tap-matrix backend, at the JAX suite's tolerance rtol =
1e-4, atol = 1e-5 (the JAX paths contract the taps as matrix products, in
another summation order).  The scenes are those of the JAX suite's
`TestPafFused`, whose samples sit away from the 0.05 threshold edge.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openpose_tpu.ops import paf as jpaf
from openpose_tpu.params import POSE_MODEL_INFO, PoseModel
from openpose_tpu_torch.ops import paf, paf_cuda
from tests import oracle


def _scene(counts, max_peaks, seed=3, near_pair=False, batch=2):
    rng = np.random.RandomState(seed)
    n_parts = len(counts)
    c = n_parts + 1 + 6
    hs, ws = 11, 15
    th, tw = hs * 8, ws * 8
    src = rng.uniform(-1, 1, (batch, hs, ws, c)).astype(np.float32)
    peaks = np.zeros((batch, n_parts, max_peaks + 1, 3), np.float32)
    for b in range(batch):
        for part, cnt in enumerate(counts):
            peaks[b, part, 0, 0] = cnt
            for k in range(cnt):
                peaks[b, part, k + 1] = (rng.uniform(1, tw - 2),
                                         rng.uniform(1, th - 2),
                                         rng.uniform(0.1, 1.0))
    if near_pair:
        # close-keypoint fallback: |AB| < sqrt(W*H)/150
        peaks[0, 1, 1, :2] = peaks[0, 0, 1, :2] + 0.3
    pairs = np.array([[0, 1], [1, 2], [2, 0]], np.int32)
    map_idx = np.array([[n_parts + 1, n_parts + 2],
                        [n_parts + 3, n_parts + 4],
                        [n_parts + 1, n_parts + 4]], np.int32)
    return src, peaks, pairs, map_idx, (th, tw)


def _jax(sources, ratios, hw, peaks, pairs, map_idx, use_pallas):
    return np.asarray(jpaf.paf_scores_multiscale(
        tuple(jnp.asarray(s) for s in sources), tuple(ratios), hw,
        jnp.asarray(peaks), jnp.asarray(pairs), jnp.asarray(map_idx),
        0.05, 0.5, 0.05, fast_peaks=0, use_pallas=use_pallas,
        precision=jax.lax.Precision.HIGHEST))


def _port(sources, ratios, hw, peaks, pairs, map_idx):
    return paf.paf_scores_multiscale(
        [torch.from_numpy(s) for s in sources], ratios, hw,
        torch.from_numpy(peaks), torch.from_numpy(pairs),
        torch.from_numpy(map_idx), 0.05, 0.5, 0.05).numpy()


@pytest.mark.parametrize("counts,near", [
    ([4, 3, 2], False),          # typical sparse
    ([4, 3, 2], True),           # close-keypoint fallback branch
    ([12, 12, 12], False),       # saturated (== max_peaks)
    ([0, 3, 2], False),          # empty part
])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_reference_matches_jax(counts, near, use_pallas):
    src, peaks, pairs, map_idx, hw = _scene(counts, 12, near_pair=near)
    want = _jax([src], [1.0], hw, peaks, pairs, map_idx, use_pallas)
    got = _port([src], [1.0], hw, peaks, pairs, map_idx)
    assert got.shape == want.shape == (2, 3, 12, 12)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_reference_two_scales_matches_jax(use_pallas):
    rng = np.random.RandomState(11)
    src, peaks, pairs, map_idx, hw = _scene([5, 4, 3], 8)
    src2 = rng.uniform(-1, 1, (2, 8, 11, src.shape[-1])).astype(np.float32)
    args = ([src, src2], [1.0, 0.73], hw, peaks, pairs, map_idx)
    want = _jax(*args, use_pallas)
    np.testing.assert_allclose(_port(*args), want, rtol=1e-4, atol=1e-5)


def test_validity_and_close_keypoint_rules():
    """On an all-zero PAF no line is accepted: a pair closer than
    sqrt(W*H)/150 scores nms_threshold + 1e-6, a farther one -1, a
    coincident one (|AB| <= 1e-6) -1, and slots past the counts -1."""
    th, tw = 88, 120
    src = np.zeros((1, 11, 15, 6), np.float32)
    peaks = np.zeros((1, 2, 4, 3), np.float32)
    peaks[0, :, 0, 0] = (3, 2)
    peaks[0, 0, 1:4, :2] = [(10, 10), (40, 40), (70, 20)]
    peaks[0, 1, 1:3, :2] = [(10.4, 10.3), (70, 20)]
    pairs = np.array([[0, 1]], np.int32)
    map_idx = np.array([[3, 4]], np.int32)
    got = _port([src], [1.0], (th, tw), peaks, pairs, map_idx)[0, 0]
    assert np.sqrt(0.4 ** 2 + 0.3 ** 2) < np.sqrt(th * tw) / 150
    assert got[0, 0] == np.float32(0.05 + 1e-6)
    assert got[0, 1] == got[1, 0] == got[1, 1] == -1.0
    assert got[2, 1] == -1.0             # coincident peaks
    assert (got[:, 2] == -1.0).all()     # j >= count_B


def test_full_resolution_backend_matches_jax_and_oracle():
    h, w = 46, 46
    rng = np.random.RandomState(3)
    n_parts, max_peaks = 3, 8
    heat = rng.uniform(-1, 1, (1, h, w, n_parts + 1 + 4)).astype(np.float32)
    peaks = np.zeros((1, n_parts + 1, max_peaks + 1, 3), np.float32)
    counts = [3, 2, 4, 0]
    for part, cnt in enumerate(counts):
        peaks[0, part, 0, 0] = cnt
        for k in range(cnt):
            peaks[0, part, k + 1] = (rng.uniform(1, w - 2),
                                     rng.uniform(1, h - 2),
                                     rng.uniform(0.1, 1.0))
    pairs = np.array([[0, 1], [1, 2]], np.int32)
    map_idx = np.array([[4, 5], [6, 7]], np.int32)
    got = paf.paf_scores(torch.from_numpy(heat), torch.from_numpy(peaks),
                         torch.from_numpy(pairs), torch.from_numpy(map_idx),
                         0.05, 0.5, 0.05).numpy()
    want = np.asarray(jpaf.paf_scores(heat, peaks, pairs, map_idx,
                                      0.05, 0.5, 0.05))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for pi, (pa, pb) in enumerate(pairs):
        for i in range(counts[pa]):
            for j in range(counts[pb]):
                np.testing.assert_allclose(got[0, pi, i, j], oracle.paf_score_oracle(
                    peaks[0, pa, i + 1, 0], peaks[0, pa, i + 1, 1],
                    peaks[0, pb, j + 1, 0], peaks[0, pb, j + 1, 1],
                    heat[0, :, :, map_idx[pi, 0]],
                    heat[0, :, :, map_idx[pi, 1]], 0.05, 0.5, 0.05),
                    rtol=1e-4, atol=1e-5)


def test_analytic_sampling_matches_materialized_upsample():
    """Sampling the low-res maps == sampling their 2-scale upsample-merge
    (the JAX suite's cross-backend check and tolerance)."""
    from openpose_tpu_torch.ops import resize
    rng = np.random.RandomState(7)
    n_parts, max_peaks = 2, 6
    c = n_parts + 1 + 4
    th, tw = 96, 128
    sources = [rng.uniform(-1, 1, (1, 12, 16, c)).astype(np.float32),
               rng.uniform(-1, 1, (1, 8, 12, c)).astype(np.float32)]
    ratios = [1.0, 0.71]
    peaks = np.zeros((1, n_parts + 1, max_peaks + 1, 3), np.float32)
    for part, cnt in enumerate([4, 3, 0]):
        peaks[0, part, 0, 0] = cnt
        for k in range(cnt):
            peaks[0, part, k + 1] = (rng.uniform(1, tw - 2),
                                     rng.uniform(1, th - 2),
                                     rng.uniform(0.1, 1.0))
    pairs = np.array([[0, 1], [1, 0]], np.int32)
    map_idx = np.array([[3, 4], [5, 6]], np.int32)
    merged = resize.upsample_merge([torch.from_numpy(s) for s in sources],
                                   ratios, (th, tw))
    want = paf.paf_scores(merged, torch.from_numpy(peaks),
                          torch.from_numpy(pairs), torch.from_numpy(map_idx),
                          0.05, 0.5, 0.05).numpy()
    got = _port(sources, ratios, (th, tw), peaks, pairs, map_idx)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    src, peaks, pairs, map_idx, hw = _scene([4, 3, 2], 12)
    before = paf_cuda.paf_scores_fused.launches
    got = paf_cuda.paf_scores_fused(
        [torch.from_numpy(src)], [1.0], hw, torch.from_numpy(peaks),
        torch.from_numpy(pairs), torch.from_numpy(map_idx), 0.05, 0.5, 0.05)
    assert paf_cuda.paf_scores_fused.launches == before
    want = _jax([src], [1.0], hw, peaks, pairs, map_idx, use_pallas=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("change,match", [
    ("k129", "max_peaks"), ("pairs_i64", "pairs"),
    ("src_f64", "sources"), ("peaks_strided", "contiguous"),
    ("map_idx_range", "outside"),
])
def test_wrapper_input_checks(change, match):
    """Shapes, dtypes and layout are checked on every call; table values
    where the tables are built (a per-call check would sync the host)."""
    src, peaks, pairs, map_idx, _ = _scene([4, 3, 2], 12)
    src_t, peaks_t = torch.from_numpy(src), torch.from_numpy(peaks)
    pairs_t, map_t = torch.from_numpy(pairs), torch.from_numpy(map_idx)
    if change == "map_idx_range":
        info = POSE_MODEL_INFO[PoseModel.BODY_25]
        bad = dataclasses.replace(info, map_idx=(info.map_idx[0] + 100,)
                                  + tuple(info.map_idx[1:]))
        with pytest.raises(ValueError, match=match):
            paf.pair_tables(bad)
        paf_cuda._check_inputs([src_t], peaks_t, pairs_t,
                               map_t + src.shape[-1])   # passes: no sync
        return
    if change == "k129":
        peaks_t = torch.zeros(2, 3, 130, 3)
    elif change == "pairs_i64":
        pairs_t = pairs_t.long()
    elif change == "src_f64":
        src_t = src_t.double()
    else:
        peaks_t = torch.zeros(2, 3, 3, 13).transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        paf_cuda._check_inputs([src_t], peaks_t, pairs_t, map_t)


def test_pair_tables_equal():
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    for got, want in zip(paf.pair_tables(info), jpaf.pair_tables(info)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
