"""The port's tracking modules vs the JAX package (CPU, float32).

The same seeded numpy frames, points and keypoints go through
`openpose_tpu.tracking.*` and `openpose_tpu_torch.tracking.*`.

Tolerances: `pyramidal_lk` points within 1e-3 px with equal `valid` flags
(the same float32 operations; the 21x21 patch sums and the pyramid's
convolutions add in another order); `PersonTracker.track` keypoints within
1e-3 px and equal scores; `PersonIdExtractor.extract_ids` equal ids;
`smooth_trajectories` rtol = atol = 1e-4 (a [T, T] float32 solve).
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from openpose_tpu.tracking import lk as jlk
from openpose_tpu.tracking import person_id as jperson_id
from openpose_tpu.tracking import pose_graph as jpose_graph
from openpose_tpu.tracking import tracker as jtracker
from openpose_tpu_torch import synthetic
from openpose_tpu_torch.tracking import lk, person_id, pose_graph, tracker

HW = (120, 200)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _textured(seed, hw=HW):
    """A smooth random texture, 0..255: gradients everywhere."""
    rng = np.random.RandomState(seed)
    img = ndi.gaussian_filter(rng.uniform(0, 255, hw), 2.0)
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return img.astype(np.float32)


def _shifted(img, dx, dy):
    """The texture moved by (dx, dy) pixels (content at x lands at x + dx)."""
    return ndi.shift(img, (dy, dx), order=3, mode="nearest").astype(np.float32)


def _bgr(gray):
    """A uint8 BGR frame whose channel mean is close to `gray`."""
    g = np.clip(gray, 0, 255)
    return np.stack([g, np.clip(g + 3, 0, 255), np.clip(g - 3, 0, 255)],
                    axis=-1).astype(np.uint8)


def test_pyr_down_matches_jax_and_reflects_without_edge_repeat():
    img = _textured(0, (37, 54))          # odd and even sides
    want = np.asarray(jlk._pyr_down(img))
    got = lk._pyr_down(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (19, 27)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # numpy's "reflect": the edge pixel is not repeated
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16
    rows = np.pad(img, ((2, 2), (0, 0)), mode="reflect")
    blurred = sum(k[i] * rows[i:i + 37] for i in range(5))
    padded = np.pad(blurred, ((0, 0), (2, 2)), mode="reflect")
    np.testing.assert_allclose(got[0, 0], k @ padded[0, :5], rtol=1e-5)


def test_bilinear_patch_matches_jax_per_point():
    img = _textured(1)
    rng = np.random.RandomState(1)
    cx = rng.uniform(-5, HW[1] + 5, 9).astype(np.float32)   # some off the frame
    cy = rng.uniform(-5, HW[0] + 5, 9).astype(np.float32)
    got = lk._bilinear_patch(torch.from_numpy(img), torch.from_numpy(cx),
                             torch.from_numpy(cy), 21).numpy()
    assert got.shape == (9, 21, 21)
    for i in range(9):
        want = np.asarray(jlk._bilinear_patch(img, cx[i], cy[i], 21))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("shift", [(2.25, -1.5), (-6.0, 4.0), (0.0, 0.0)])
def test_pyramidal_lk_matches_jax(shift):
    """Textured frames moved by a known shift; one point whose patch leaves
    the frame, one far outside it, one on the last pixel."""
    prev = _textured(2)
    nxt = _shifted(prev, *shift)
    rng = np.random.RandomState(2)
    pts = np.concatenate([
        np.stack([rng.uniform(20, HW[1] - 20, 24),
                  rng.uniform(20, HW[0] - 20, 24)], axis=1),
        [[3.0, 50.0], [500.0, 20.0], [HW[1] - 1.0, HW[0] - 1.0]],
    ]).astype(np.float32)
    want_pts, want_valid = (np.asarray(a) for a in
                            jlk.pyramidal_lk(prev, nxt, pts))
    got_pts, got_valid = lk.pyramidal_lk(prev, nxt, pts, device="cpu")
    assert got_pts.dtype == torch.float32 and got_valid.dtype == torch.bool
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    assert not want_valid[-3:].any() and want_valid[:24].all()
    np.testing.assert_allclose(got_pts.numpy(), want_pts, atol=1e-3)
    # and the flow is the shift, on the textured interior
    flow = got_pts.numpy()[:24] - pts[:24]
    np.testing.assert_allclose(flow, np.tile(shift, (24, 1)), atol=0.25)


def test_pyramidal_lk_takes_tensors_and_a_flat_frame_is_invalid():
    flat = np.full(HW, 90.0, np.float32)
    pts = np.array([[60.0, 50.0], [100.0, 70.0]], np.float32)
    _, valid = lk.pyramidal_lk(torch.from_numpy(flat), torch.from_numpy(flat),
                               torch.from_numpy(pts), device="cpu")
    want = np.asarray(jlk.pyramidal_lk(flat, flat, pts)[1])
    np.testing.assert_array_equal(valid.numpy(), want)
    assert not valid.any()          # det <= 1e-6: no gradient


def _people_on(hw, seed, n=2):
    rng = np.random.RandomState(seed)
    kp = synthetic.random_people(rng, n, hw, height_range=(60, 90))
    kp[0, 3, 2] = 0.01              # below the confidence threshold
    kp[1, 5, :2] = (2.0, 2.0)       # its patch leaves the frame
    return kp


def test_person_tracker_matches_jax_over_frames():
    base = _textured(3)
    frames = [_bgr(_shifted(base, 1.5 * i, -1.0 * i)) for i in range(4)]
    kp = _people_on(HW, 3)
    jt, pt = jtracker.PersonTracker(), tracker.PersonTracker(device="cpu")
    jt.observe(kp, frames[0])
    pt.observe(kp, frames[0])
    np.testing.assert_array_equal(pt.prev_gray.numpy(), jt.prev_gray)
    for frame in frames[1:]:
        want = jt.track(frame)
        got = pt.track(frame)
        assert got.shape == want.shape == kp.shape
        np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-3)
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
    # a confident keypoint off the frame lost its score; a weak one kept
    # its place
    assert got[1, 5, 2] == 0.0 and kp[1, 5, 2] > 0.05
    np.testing.assert_array_equal(got[0, 3], kp[0, 3])
    moved = got[..., 2] > 0.05
    np.testing.assert_allclose(
        (got[..., :2] - kp[..., :2])[moved].mean(axis=0), [4.5, -3.0],
        atol=0.3)


def test_person_tracker_without_a_base_frame():
    pt, jt = tracker.PersonTracker(device="cpu"), jtracker.PersonTracker()
    frame = _bgr(_textured(4))
    assert pt.track(frame).shape == jt.track(frame).shape == (0, 0, 3)
    pt.observe(np.zeros((0, 25, 3), np.float32), frame)
    assert pt.track(frame).shape == (0, 25, 3)


def test_tracking_pose_extractor_strides_like_jax():
    """CNN on every (tracking + 1)-th frame, LK in between."""
    base = _textured(5)
    frames = [_bgr(_shifted(base, 2.0 * i, 0.0)) for i in range(5)]
    kp = _people_on(HW, 5)

    class Fake:
        device = torch.device("cpu")

        def __init__(self):
            self.calls = 0

        def forward(self, frame, **kwargs):
            self.calls += 1
            out = kp.copy()
            out[..., 0] += 100.0 * self.calls      # tells the CNN frames apart

            class Pred:
                keypoints = out
            return Pred

    fakes = Fake(), Fake()
    mine = tracker.TrackingPoseExtractor(fakes[0], tracking=2)
    theirs = jtracker.TrackingPoseExtractor(fakes[1], tracking=2)
    for frame in frames:
        got, want = mine.forward(frame), theirs.forward(frame)
        np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-3)
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert fakes[0].calls == fakes[1].calls == 2     # frames 0 and 3


def test_person_id_extractor_matches_jax():
    """People drift with the texture, swap their order, one leaves and a
    new one arrives: equal ids and equal tracked keypoints."""
    base = _textured(6, (160, 240))
    hw = (160, 240)
    rng = np.random.RandomState(6)
    people = synthetic.random_people(rng, 3, hw, height_range=(70, 100))
    mine = person_id.PersonIdExtractor(device="cpu")
    theirs = jperson_id.PersonIdExtractor()
    seen = []
    for i in range(5):
        frame = _bgr(_shifted(base, 2.0 * i, 1.0 * i))
        kp = people.copy()
        kp[..., 0] += 2.0 * i
        kp[..., 1] += 1.0 * i
        if i == 2:
            kp = kp[[1, 0, 2]]              # another order
        if i == 3:
            kp = kp[:2]                     # one person gone
        if i == 4:
            new = synthetic.random_people(rng, 1, hw, height_range=(60, 70))
            kp = np.concatenate([kp[[2, 0]], new])
        got = mine.extract_ids(kp, frame)
        want = theirs.extract_ids(kp, frame)
        np.testing.assert_array_equal(got, want)
        seen.append(got.tolist())
        assert mine.entries.keys() == theirs.entries.keys()
        for pid, entry in mine.entries.items():
            np.testing.assert_allclose(entry.keypoints,
                                       theirs.entries[pid].keypoints,
                                       atol=1e-3)
            np.testing.assert_array_equal(entry.status,
                                          theirs.entries[pid].status)
    assert seen[0] == [0, 1, 2] and seen[2] == [1, 0, 2]
    assert seen[3] == [0, 1] and seen[4] == [2, 0, 3]


@pytest.mark.parametrize("t,smoothness", [(3, 4.0), (9, 4.0), (16, 0.5)])
def test_smooth_trajectories_matches_jax(t, smoothness):
    rng = np.random.RandomState(t)
    kp = rng.uniform(0, 300, (t, 3, 25, 3)).astype(np.float32)
    kp[..., 2] = rng.uniform(0.3, 1.0, (t, 3, 25))
    kp[0, 0, :5, 2] = -0.2              # negative scores weigh nothing
    kp[t // 2, 1, :, 2] = 0.0           # a missed detection: inpainted
    want = np.asarray(jpose_graph.smooth_trajectories(kp, smoothness))
    got = pose_graph.smooth_trajectories(torch.from_numpy(kp),
                                         smoothness).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2], kp[..., 2])   # scores pass


def test_smooth_window_and_keyframe_smoother_match_jax():
    rng = np.random.RandomState(9)
    short = rng.uniform(0, 100, (2, 1, 25, 3)).astype(np.float32)
    assert pose_graph.smooth_window(short, device="cpu") is short
    mine = pose_graph.KeyframeSmoother(window=5, device="cpu")
    theirs = jpose_graph.KeyframeSmoother(window=5)
    people = synthetic.random_people(rng, 2, (240, 400),
                                     height_range=(100, 150))
    emitted = []
    for i in range(8):
        kp = people + rng.normal(0, 1.5, people.shape).astype(np.float32)
        kp[..., 2] = people[..., 2]
        kp[..., 0] += 3.0 * i
        if i == 3:
            kp = kp[:1]                       # person 1 missing: inpainted
        if i == 5:
            kp = kp[::-1]                     # slots follow the people
        scores = np.arange(len(kp), dtype=np.float32) + 1
        got, want = mine.push(i, kp, scores), theirs.push(i, kp, scores)
        emitted += list(zip(got, want))
    emitted += list(zip(mine.flush(), theirs.flush()))
    assert [g[0] for g, _ in emitted] == list(range(8))
    for (gi, gkp, gsc), (wi, wkp, wsc) in emitted:
        assert gi == wi and gkp.shape == wkp.shape == (2, 25, 3)
        np.testing.assert_allclose(gkp, wkp, rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(gsc, wsc)
    with pytest.raises(ValueError):
        pose_graph.KeyframeSmoother(window=2, device="cpu")
