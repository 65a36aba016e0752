"""Port NMS vs the scalar oracle and the JAX package (CPU, float32).

Counts must be equal and the raw peak scores (which pick out the peak
pixels) exact; refined x/y agree to the JAX suite's rtol = atol = 1e-4
(7x7 centroid sums in another order).

The NMS kernels (`kernels/nms.cu`) run only on a card.  Here `nms.nms`
on CPU tensors takes the plain version and counts `nms.plain`; a numpy
model of the kernels (a bit mask of each row's peaks a channel, the row
counts, their exclusive scan a part, each kept peak's rank by x in its
row, capped at max_peaks) stands in for the launches under the wrapper's
own PyTorch steps and is held bit-equal to the plain version on every
scene; on a card the kernels themselves are (skipped here; pytest does
not run on the card's machine, where `chip_smoke.py --nms` holds them to
the plain version)."""

import numpy as np
import pytest
import torch

from openpose_tpu.ops import nms as jnms
from openpose_tpu_torch import synthetic
from openpose_tpu_torch.ops import nms, paf, resize
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
from openpose_tpu_torch.utils.profiler import TRACE
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


# --- the kernels' placement (kernels/nms.cu) ---------------------------------

def _merged(src, hw):
    return resize.resize_bicubic(torch.from_numpy(np.asarray(
        src, np.float32)), hw).numpy()


def _people_maps(n_people, seed, hw=(368, 656)):
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    people = synthetic.random_people(np.random.RandomState(seed), n_people,
                                     hw)
    pairs, map_idx = paf.pair_tables(info)
    src = synthetic.make_targets(people[None], pairs, map_idx, hw,
                                 info.num_parts, info.heatmap_channels)
    return _merged(src[..., :info.num_parts], hw)


def _edge_values(seed, thr):
    """Noise with NaN, infinities, both zeros, the threshold itself and huge
    values scattered over it, and a plateau at the threshold."""
    rng = np.random.RandomState(seed)
    heat = rng.uniform(-1, 1, (2, 20, 24, 5)).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, thr, 1e30,
                        -1e30, 3.4e38], np.float32)
    at = rng.randint(0, heat.size, 80)
    heat.flat[at] = special[rng.randint(0, special.size, at.size)]
    heat[1, 3:6, 3:6, 2] = np.float32(thr)
    return heat


def _one(heat2d):
    return heat2d[None, :, :, None]


def _corner():
    heat = np.zeros((12, 12), np.float32)
    heat[0, 1] = 0.5        # outer ring on an inner-ring line: a candidate
    return _one(heat)


def _plateaus():
    heat = np.zeros((1, 16, 16, 2), np.float32)
    heat[0, 5:8, 5:8] = 0.7
    heat[0, 1, 1:4] = 0.4
    heat[0, 0, :, 1] = 0.6
    heat[0, 14, 3:5, 0] = 0.3
    return heat


def _grid():
    heat = np.zeros((30, 30), np.float32)
    heat[2:28:3, 2:28:3] = 1.0
    return _one(heat)


def _tiny(h, w):
    return np.random.RandomState(10 * h + w).uniform(
        -0.2, 1.0, (2, h, w, 3)).astype(np.float32)


# name -> (maps [N, H, W, C], threshold, max_peaks, offset)
SCENES = {
    **{f"blobs_{s}": (lambda s=s: _one(_random_heat(40, 56, 6, s)), 0.05,
                      127, (0.5, 0.5)) for s in range(3)},
    "full_budget": (lambda: _one(_random_heat(72, 104, 110, 0)), 0.05, 127,
                    (0.5, 0.5)),
    "y0_x1_candidate": (_corner, 0.05, 10, (0.5, 0.5)),
    "plateaus": (_plateaus, 0.05, 8, (0.5, 0.5)),
    "cap_row_major": (_grid, 0.05, 5, (0.5, 0.5)),
    "batched_offset": (lambda: np.stack([np.stack(
        [_random_heat(24, 40, 4, 10 * b + c) for c in range(3)], -1)
        for b in range(2)]), 0.1, 16, (1.25, 1.25)),
    **{f"tiny_{h}x{w}": (lambda h=h, w=w: _tiny(h, w), 0.05, 4, (0.5, 0.5))
       for h, w in ((1, 1), (1, 5), (2, 3), (3, 3), (4, 5), (5, 5), (5, 2))},
    "edge_values": (lambda: _edge_values(1, 0.05), 0.05, 127, (0.5, 0.5)),
    "edge_values_thr0": (lambda: _edge_values(2, 0.0), 0.0, 7, (0.0, 0.0)),
    "no_slots": (lambda: _edge_values(3, 0.05), 0.05, 0, (0.5, 0.5)),
    "wide_rows": (lambda: np.random.RandomState(4).uniform(
        -1, 1, (2, 6, 1100, 3)).astype(np.float32), 0.05, 127, (0.5, 0.5)),
    "people_3_368x656": (lambda: _people_maps(3, 7), 0.05, 127, (0.5, 0.5)),
    "noise_368x656": (lambda: _merged(np.random.RandomState(3).uniform(
        -1, 1, (1, 46, 82, 25)), (368, 656)), 0.05, 127, (0.5, 0.5)),
}


def _kernel_placement(heat, threshold, max_peaks):
    """The kernels' placement in numpy: each row's peaks a channel as a bit
    mask, x % 32 of word x // 32 (nms_mark_kernel; the test is the plain
    version's, thr outside the map), each row's count, the counts'
    exclusive scan a part (each row's first slot), and, for the rows whose
    first slot lies below max_peaks, each peak's rank by x in its row
    (nms_place_kernel).  Returns (kept [N, C], pixel [N, C, K]: each kept
    slot's y * W + x)."""
    thr = np.float32(threshold)
    n, h, w, c = heat.shape
    padded = np.pad(heat, ((0, 0), (1, 1), (1, 1), (0, 0)),
                    constant_values=thr)
    gt = np.ones(heat.shape, bool)
    ge = np.ones(heat.shape, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nb = padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                gt &= heat > nb
                ge &= heat >= nb
    ys, xs = np.arange(h)[:, None, None], np.arange(w)[None, :, None]
    interior = (xs > 1) & (xs < w - 2) & (ys > 1) & (ys < h - 2)
    inner = (xs == 1) | (xs == w - 2) | (ys == 1) | (ys == h - 2)
    peak = (heat > thr) & ((interior & gt) | (inner & ge))
    words = -(-w // 32)
    bits = np.zeros((n, c, h, words * 32), np.uint64)
    bits[..., :w] = peak.transpose(0, 3, 1, 2)
    masks = (bits.reshape(n, c, h, words, 32)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    counts = np.vectorize(lambda m: bin(int(m)).count("1"))(masks).sum(-1) \
        if masks.size else np.zeros((n, c, h), np.int64)
    first = np.cumsum(counts, -1) - counts
    kept = np.minimum(counts.sum(-1), max_peaks)
    pixel = np.zeros((n, c, max_peaks), np.int64)
    for i, ch, y in zip(*np.nonzero((first < max_peaks) & (counts > 0))):
        slot = first[i, ch, y]
        for j in range(words):
            for b in range(32):
                if masks[i, ch, y, j] >> b & 1 and slot < max_peaks:
                    pixel[i, ch, slot] = y * w + 32 * j + b
                    slot += 1
    return kept, pixel


def _emulated_launches(monkeypatch):
    """`nms._place` and `nms._refine_slots` done on the CPU: the model's
    slots, their values and windows (the empty slots' windows hold NaN, as
    the kernel leaves them unwritten), and the refine kernel's arithmetic on
    the wrapper's sums."""
    def place(heat, masks, threshold, peaks, windows):
        n, h, w, c = heat.shape
        k = peaks.shape[2] - 1
        kept, pixel = _kernel_placement(heat.numpy(), threshold, k)
        flat = heat.permute(0, 3, 1, 2).reshape(n, c, h * w)
        pos = torch.clamp(heat, min=0.0).permute(0, 3, 1, 2)
        peaks.zero_()
        peaks[:, :, 0, 0] = torch.from_numpy(kept.astype(np.float32))
        for t in windows:
            t.fill_(float("nan"))
        d = np.arange(-3, 4)
        for i, ch in zip(*np.nonzero(kept)):
            for s in range(kept[i, ch]):
                py, px = divmod(int(pixel[i, ch, s]), w)
                peaks[i, ch, 1 + s, 2] = flat[i, ch, pixel[i, ch, s]]
                sy = torch.from_numpy(np.repeat(py + d, 7))
                sx = torch.from_numpy(np.tile(px + d, 7))
                inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
                win = torch.where(inside, pos[i, ch, sy.clamp(0, h - 1),
                                              sx.clamp(0, w - 1)], 0.0)
                windows[0][i, ch, s] = win
                windows[1][i, ch, s] = win * sx.to(torch.float32)
                windows[2][i, ch, s] = win * sy.to(torch.float32)

    def refine(sums, peaks, offset):
        s, sx, sy = sums
        kept = peaks[:, :, 0, 0].long()
        valid = torch.arange(s.shape[2])[None, None] < kept[..., None]
        denom = torch.where(s > 0, s, 1.0)
        peaks[:, :, 1:, 0] = torch.where(valid, sx / denom + offset[0],
                                         peaks[:, :, 1:, 0])
        peaks[:, :, 1:, 1] = torch.where(valid, sy / denom + offset[1],
                                         peaks[:, :, 1:, 1])
    monkeypatch.setattr(nms, "_place", place)
    monkeypatch.setattr(nms, "_refine_slots", refine)


def _same_bits(got, want):
    """Equal bits, any NaN matching any NaN (a NaN's payload is the
    hardware's)."""
    return got.shape == want.shape and bool(
        ((got.view(torch.int32) == want.view(torch.int32))
         | (got.isnan() & want.isnan())).all())


@pytest.fixture
def tracer():
    TRACE.disable()
    TRACE.drain()
    TRACE.enable()
    try:
        yield TRACE
    finally:
        TRACE.disable()
        TRACE.drain()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_cpu_tensors_take_the_plain_version_and_count_it(dtype, tracer):
    heat = torch.from_numpy(_random_heat(24, 40, 4, 5)[None, :, :, None]
                            ).to(dtype)
    launches = nms.nms.launches
    assert not nms.fuses(heat)
    for _ in range(2):
        got = nms.nms(heat, 0.05, 16)
        assert tracer.drain()["counters"] == {nms.PLAIN: 1}
    assert torch.equal(got, nms.plain(heat, 0.05, 16))
    assert nms.nms.launches == launches


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernel_placement_model_is_the_plain_version(scene, monkeypatch):
    """The fused path's own PyTorch steps (`nms._fused`: the scratch, the
    three window sums) around the numpy model of the kernels give the
    plain version's output bit for bit."""
    make, thr, k, offset = SCENES[scene]
    heat = torch.from_numpy(np.ascontiguousarray(make(), np.float32))
    want = nms.plain(heat, thr, k, offset)
    _emulated_launches(monkeypatch)
    got = nms._fused(heat, thr, k, offset)
    assert _same_bits(got, want), scene
    if scene == "noise_368x656":
        assert bool((want[:, :, 0, 0] == 127).all())
    if scene == "y0_x1_candidate":
        assert want[0, 0, 0, 0] == 1 and want[0, 0, 1, 2] == 0.5


@pytest.fixture(scope="module")
def card():
    """The card; the kernel's own checks skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the NMS kernels are CUDA only")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernels_are_the_plain_version_on_the_card(scene, card, tracer):
    make, thr, k, offset = SCENES[scene]
    heat = torch.from_numpy(np.ascontiguousarray(make(), np.float32)).to(card)
    want = nms.plain(heat, thr, k, offset)
    tracer.drain()
    got = nms.nms(heat, thr, k, offset)
    assert tracer.drain()["counters"] == {nms.FUSED: 1}
    assert _same_bits(got, want), scene
