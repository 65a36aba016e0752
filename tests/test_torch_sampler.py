"""Port bicubic sampler and sampled PAF backend vs the JAX package (CPU).

`paf.sample_bicubic_reference` is the plain version of the CUDA sampler; on
CPU tensors `paf_cuda.sample_bicubic` runs it.  It is held to the JAX
Pallas sampler in interpret mode at HIGHEST precision and to the
`_tap_matrix` einsum at the JAX suite's tolerance rtol = 1e-4, atol = 1e-5
(`tests/test_ops.py`): the JAX paths contract the taps as matrix products,
in another summation order.  The sampled backend is held to JAX's
`paf_scores_multiscale(use_pallas=False, fast_peaks=0)` at the same
tolerance, on scenes whose projections stay away from the 0.05 threshold.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openpose_tpu.ops import paf as jpaf
from openpose_tpu.ops.paf_pallas import sample_bicubic_pallas
from openpose_tpu_torch.ops import paf, paf_cuda


def _sampler_scene(seed=11, p=3, hs=12, ws=16, s=700, scale=8.0):
    rng = np.random.RandomState(seed)
    th, tw = int(round(hs * scale)), int(round(ws * scale))
    low = rng.uniform(-1, 1, (p, 2, hs, ws)).astype(np.float32)
    my = rng.randint(0, th, (p, s)).astype(np.int32)
    mx = rng.randint(0, tw, (p, s)).astype(np.int32)
    my[:, :2], mx[:, :2] = (0, th - 1), (0, tw - 1)   # the grid's edges
    return low, my, mx


def _port_sample(low, my, mx, scale_h, scale_w):
    vx, vy = paf_cuda.sample_bicubic(
        torch.from_numpy(low[None]), torch.from_numpy(my[None]),
        torch.from_numpy(mx[None]), scale_h, scale_w)
    return vx[0].numpy(), vy[0].numpy()


@pytest.mark.parametrize("hs,ws,s,scale", [
    (12, 16, 700, 8.0),              # the JAX suite's scene
    (9, 16, 2048 + 5, 8.0 / 0.75),   # a 4-scale plan's 0.75 scale, ragged S
])
def test_sampler_matches_pallas_interpret(hs, ws, s, scale):
    low, my, mx = _sampler_scene(hs=hs, ws=ws, s=s, scale=scale)
    want = sample_bicubic_pallas(
        jnp.asarray(low), jnp.asarray(my), jnp.asarray(mx), scale, scale,
        interpret=True, precision=jax.lax.Precision.HIGHEST)
    got = _port_sample(low, my, mx, scale, scale)
    for g, w in zip(got, want):
        assert g.shape == (3, s)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_sampler_matches_tap_matrix_einsum():
    low, my, mx = _sampler_scene(seed=5, hs=11, ws=15, s=500, scale=7.3)
    wrow = np.asarray(jpaf._tap_matrix(jnp.asarray(my), 11, 7.3))
    wcol = np.asarray(jpaf._tap_matrix(jnp.asarray(mx), 15, 7.3))
    got = _port_sample(low, my, mx, 7.3, 7.3)
    for c in (0, 1):
        want = np.einsum("psh,phw,psw->ps", wrow, low[:, c], wcol)
        np.testing.assert_allclose(got[c], want, rtol=1e-4, atol=1e-5)


def test_sampler_is_batched_over_frames_and_handles_off_grid_pixels():
    """Frames are independent; pixels off the target grid take the clamped
    taps with dx measured from the clamped tap, as `_tap_matrix` does."""
    rng = np.random.RandomState(2)
    low = rng.uniform(-1, 1, (2, 3, 2, 6, 7)).astype(np.float32)
    my = rng.randint(-20, 70, (2, 3, 40)).astype(np.int32)
    mx = rng.randint(-20, 80, (2, 3, 40)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (low, my, mx)]
    vx, vy = paf.sample_bicubic_reference(*args, 8.0, 8.0)
    for b in range(2):
        one = paf.sample_bicubic_reference(*(a[b:b + 1] for a in args),
                                           8.0, 8.0)
        np.testing.assert_array_equal(one[0][0].numpy(), vx[b].numpy())
        np.testing.assert_array_equal(one[1][0].numpy(), vy[b].numpy())
        wrow = np.asarray(jpaf._tap_matrix(jnp.asarray(my[b]), 6, 8.0))
        wcol = np.asarray(jpaf._tap_matrix(jnp.asarray(mx[b]), 7, 8.0))
        want = np.einsum("psh,phw,psw->ps", wrow, low[b, :, 0], wcol)
        np.testing.assert_allclose(vx[b].numpy(), want, rtol=1e-4, atol=1e-5)


def test_sampler_wrapper_on_cpu_runs_plain_version_without_launch():
    low, my, mx = _sampler_scene()
    before = paf_cuda.sample_bicubic_scales.launches
    got = _port_sample(low, my, mx, 8.0, 8.0)
    assert paf_cuda.sample_bicubic_scales.launches == before
    want = paf.sample_bicubic_reference(
        torch.from_numpy(low[None]), torch.from_numpy(my[None]),
        torch.from_numpy(mx[None]), 8.0, 8.0)
    np.testing.assert_array_equal(got[0], want[0][0].numpy())


@pytest.mark.parametrize("change,match", [
    ("low_4d", "low_xy"), ("low_f64", "low_xy"), ("my_i64", "my"),
    ("mx_shape", "mx"), ("strided", "contiguous"),
])
def test_sampler_wrapper_input_checks(change, match):
    low = torch.zeros(2, 3, 2, 6, 7)
    my = torch.zeros(2, 3, 10, dtype=torch.int32)
    mx = torch.zeros(2, 3, 10, dtype=torch.int32)
    if change == "low_4d":
        low = low[0]
    elif change == "low_f64":
        low = low.double()
    elif change == "my_i64":
        my = my.long()
    elif change == "mx_shape":
        mx = torch.zeros(2, 3, 11, dtype=torch.int32)
    else:
        my = torch.zeros(2, 10, 3, dtype=torch.int32).transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        paf_cuda._check_sampler_inputs([low], my, mx)


@pytest.mark.parametrize("n_scales", [1, 2, 4])
def test_multi_scale_sampler_is_the_in_order_sum(n_scales):
    """The multi-scale entry (one launch for all scales on a card) equals
    the per-scale samplers summed in scale order, bit for bit, through the
    wrapper and through its plain version; one scale is `sample_bicubic`."""
    rng = np.random.RandomState(5)
    sizes = [(12, 16), (9, 12), (6, 8), (3, 4)][:n_scales]
    scales = [(96 / h, 128 / w) for h, w in sizes]
    lows = [torch.from_numpy(rng.uniform(-1, 1, (2, 3, 2, h, w))
                             .astype(np.float32)) for h, w in sizes]
    my = torch.from_numpy(rng.randint(-5, 101, (2, 3, 77)).astype(np.int32))
    mx = torch.from_numpy(rng.randint(-5, 133, (2, 3, 77)).astype(np.int32))
    want_x = want_y = None
    for low, (sh, sw) in zip(lows, scales):
        vx, vy = paf.sample_bicubic_reference(low, my, mx, sh, sw)
        want_x = vx if want_x is None else want_x + vx
        want_y = vy if want_y is None else want_y + vy
    for fn in (paf.sample_bicubic_scales_reference,
               paf_cuda.sample_bicubic_scales):
        got_x, got_y = fn(lows, my, mx, scales)
        np.testing.assert_array_equal(got_x.numpy(), want_x.numpy())
        np.testing.assert_array_equal(got_y.numpy(), want_y.numpy())
    if n_scales == 1:
        one = paf_cuda.sample_bicubic(lows[0], my, mx, *scales[0])
        np.testing.assert_array_equal(one[0].numpy(), want_x.numpy())


def test_multi_scale_sampler_input_checks():
    low = torch.zeros(2, 3, 2, 6, 7)
    my = torch.zeros(2, 3, 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="scales"):
        paf_cuda.sample_bicubic_scales([low, low], my, my, [(8.0, 8.0)])
    with pytest.raises(ValueError, match="scales supported"):
        paf_cuda._check_sampler_inputs([low] * 9, my, my)
    with pytest.raises(ValueError, match="one N, P"):
        paf_cuda._check_sampler_inputs([low, torch.zeros(2, 4, 2, 3, 4)],
                                       my, my)


def test_sampler_args_gathers_every_scale():
    """`paf.sampler_args`: each scale's planes are the pairs' x and y
    channels, NCHW, and the scales are `_scale_factors`."""
    sources, ratios, hw, peaks, pairs, map_idx = _paf_scene([5, 4, 6], 8, 3)
    srcs = [torch.from_numpy(s) for s in sources]
    geo = paf._line_geometry(torch.from_numpy(peaks),
                             torch.from_numpy(pairs), hw)
    lows, my, mx, scales = paf.sampler_args(srcs, ratios, hw, geo,
                                            torch.from_numpy(map_idx))
    assert scales == paf._scale_factors(srcs, ratios, hw)
    assert my.shape == mx.shape == (2, 3, 8 * 8 * 25) and my.dtype == torch.int32
    for low, src in zip(lows, sources):
        assert low.is_contiguous()
        for p in range(3):
            for c in (0, 1):
                np.testing.assert_array_equal(low[:, p, c].numpy(),
                                              src[..., map_idx[p, c]])


def _paf_scene(counts, max_peaks, n_scales, seed=3, batch=2):
    """Peaks placed at random, maps whose lines stay off the threshold:
    low-res x/y maps of constant direction, one per pair, so every sample's
    projection sits near 0 or near +-1, far from 0.05."""
    rng = np.random.RandomState(seed)
    n_parts = len(counts)
    c = n_parts + 1 + 6
    sizes = [(11, 15), (8, 11), (6, 8)][:n_scales]
    ratios = [1.0, 0.73, 0.55][:n_scales]
    th, tw = 88, 120
    peaks = np.zeros((batch, n_parts, max_peaks + 1, 3), np.float32)
    for b in range(batch):
        for part, cnt in enumerate(counts):
            peaks[b, part, 0, 0] = cnt
            peaks[b, part, 1:cnt + 1, 0] = rng.uniform(1, tw - 2, cnt)
            peaks[b, part, 1:cnt + 1, 1] = rng.uniform(1, th - 2, cnt)
            peaks[b, part, 1:cnt + 1, 2] = rng.uniform(0.1, 1.0, cnt)
    sources = []
    for hs, ws in sizes:
        src = rng.uniform(-0.2, 0.2, (batch, hs, ws, c)).astype(np.float32)
        for ch in range(n_parts + 1, c, 2):
            ang = rng.uniform(0, 2 * np.pi)
            src[..., ch] = np.cos(ang)
            src[..., ch + 1] = np.sin(ang)
        sources.append(src)
    pairs = np.array([[0, 1], [1, 2], [2, 0]], np.int32)
    map_idx = np.array([[n_parts + 1, n_parts + 2],
                        [n_parts + 3, n_parts + 4],
                        [n_parts + 5, n_parts + 6]], np.int32)
    return sources, ratios, (th, tw), peaks, pairs, map_idx


@pytest.mark.parametrize("n_scales", [1, 3])
def test_sampled_backend_matches_jax(n_scales):
    sources, ratios, hw, peaks, pairs, map_idx = _paf_scene(
        [16, 9, 12], 16, n_scales)
    want = np.asarray(jpaf.paf_scores_multiscale(
        tuple(jnp.asarray(s) for s in sources), tuple(ratios), hw,
        jnp.asarray(peaks), jnp.asarray(pairs), jnp.asarray(map_idx),
        0.05, 0.5, 0.05, use_pallas=False, fast_peaks=0))
    got = paf.paf_scores_sampled(
        [torch.from_numpy(s) for s in sources], ratios, hw,
        torch.from_numpy(peaks), torch.from_numpy(pairs),
        torch.from_numpy(map_idx), 0.05, 0.5, 0.05).numpy()
    assert got.shape == want.shape == (2, 3, 16, 16)
    assert (want > 0).sum() > 20 and (want == -1).sum() > 20
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sampled_backend_blocks_over_pairs(monkeypatch):
    """Pair blocks of any size give the same scores as one block."""
    sources, ratios, hw, peaks, pairs, map_idx = _paf_scene([5, 4, 6], 8, 2)
    args = ([torch.from_numpy(s) for s in sources], ratios, hw,
            torch.from_numpy(peaks), torch.from_numpy(pairs),
            torch.from_numpy(map_idx), 0.05, 0.5, 0.05)
    whole = paf.paf_scores_sampled(*args)
    monkeypatch.setattr(paf, "SAMPLED_BLOCK_SAMPLES", 1)
    np.testing.assert_array_equal(paf.paf_scores_sampled(*args).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("k,use_fused,want", [
    (16, None, "sampled"), (32, None, "sampled"), (33, None, "fused"),
    (127, None, "fused"), (16, True, "fused"), (127, False, "sampled"),
])
def test_routing_rule(monkeypatch, k, use_fused, want):
    """None routes by the JAX rule max_peaks > 32; an explicit value is
    honored."""
    called = []
    monkeypatch.setattr(paf_cuda, "paf_scores_fused",
                        lambda *a: called.append("fused"))
    monkeypatch.setattr(paf, "paf_scores_sampled",
                        lambda *a: called.append("sampled"))
    paf.paf_scores_multiscale([torch.zeros(1, 4, 4, 5)], [1.0], (32, 32),
                              torch.zeros(1, 2, k + 1, 3),
                              torch.zeros(1, 2, dtype=torch.int32),
                              torch.zeros(1, 2, dtype=torch.int32),
                              0.05, 0.95, 0.05, use_fused=use_fused)
    assert called == [want]


def test_backends_agree():
    """The fused and sampled backends score the same scene alike (two tap
    formulas, equal in exact arithmetic)."""
    sources, ratios, hw, peaks, pairs, map_idx = _paf_scene([7, 8, 6], 8, 2)
    args = ([torch.from_numpy(s) for s in sources], ratios, hw,
            torch.from_numpy(peaks), torch.from_numpy(pairs),
            torch.from_numpy(map_idx), 0.05, 0.5, 0.05)
    fused = paf.paf_scores_multiscale(*args, use_fused=True).numpy()
    sampled = paf.paf_scores_multiscale(*args, use_fused=False).numpy()
    np.testing.assert_allclose(sampled, fused, rtol=1e-4, atol=1e-5)


def test_finalize_in_one_reduction_matches_in_order():
    """The sampled backend sums a line's samples in one reduction; the
    fused kernel's plain version one at a time.  Same counts, sums equal to
    float32 rounding (1e-6 on means of values below 1)."""
    sources, ratios, hw, peaks, pairs, _ = _paf_scene([7, 8, 6], 8, 1)
    geo = paf._line_geometry(torch.from_numpy(peaks), torch.from_numpy(pairs),
                             hw)
    proj = torch.from_numpy(np.random.RandomState(4).uniform(
        -0.5, 1.0, tuple(geo["mx"].shape)).astype(np.float32))
    args = (proj, geo, hw, 0.05, 0.5, 0.05)
    want = paf._finalize(*args)
    got = paf._finalize(*args, in_order=False)
    assert (want > 0).sum() > 20 and (want == -1).sum() > 20
    np.testing.assert_array_equal(got.numpy() == -1, want.numpy() == -1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
