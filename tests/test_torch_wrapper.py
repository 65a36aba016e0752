"""The port's `Wrapper` vs the JAX package's (CPU, float32).

One pair of Wrappers (BODY_25 + face + hand, `tracking=1`,
`number_people_max=3`) gets the same frames and the same weights (JAX's,
through the bridge: the port's extractors are built over the converted
models).  Options that `process` reads per call are switched on both
Wrappers between cases, so the nets are built once.

Tolerances: the same people in the same order; pose, face and hand keypoints
within 1e-2 px and scores within 1e-3 (the nets, resizes and tap sums run in
another order; an LK frame adds 1e-3 px); candidates and heatmaps 1e-3;
injected people to 1e-3 px.
"""

import dataclasses

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from openpose_tpu import wrapper as jwrapper
from openpose_tpu.params import PoseModel as JaxPoseModel
from openpose_tpu_torch import synthetic, wrapper
from openpose_tpu_torch.face.extractor import FaceExtractor
from openpose_tpu_torch.hand.extractor import HandExtractor
from openpose_tpu_torch.models import checkpoint, zoo
from openpose_tpu_torch.ops import paf
from openpose_tpu_torch.pose.extractor import PoseExtractor
from openpose_tpu_torch.utils.profiler import Profiler

HW = (120, 200)
NET = (160, 96)           # (w, h)
TOPDOWN_NET = 64


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(jax_model):
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jax_model.params.items()}
    return zoo.from_params(jax_model.spec, checkpoint.from_jax_params(params),
                           jax_model.info, device="cpu")


@pytest.fixture(scope="module")
def wrappers():
    configs = dict(
        pose=dict(net_resolution=NET, compute_dtype="float32", tracking=1,
                  number_people_max=3),
        face=dict(enable=True, net_resolution=TOPDOWN_NET),
        hand=dict(enable=True, net_resolution=TOPDOWN_NET))
    theirs = jwrapper.Wrapper(
        jwrapper.PoseConfig(model=JaxPoseModel.BODY_25, **configs["pose"]),
        jwrapper.FaceConfig(**configs["face"]),
        jwrapper.HandConfig(**configs["hand"]))
    mine = wrapper.Wrapper(
        wrapper.PoseConfig(**configs["pose"]),
        wrapper.FaceConfig(**configs["face"]),
        wrapper.HandConfig(**configs["hand"]), profiler=Profiler(),
        device="cpu")
    # the same weights on both sides
    mine.pose_extractor = PoseExtractor(
        _port(theirs.pose_extractor.model), compute_dtype=torch.float32,
        device="cpu")
    mine.face_extractor = FaceExtractor(
        _port(theirs.face_extractor._topdown.model), TOPDOWN_NET,
        torch.float32, device="cpu")
    mine.hand_extractor = HandExtractor(
        _port(theirs.hand_extractor._topdown.model), TOPDOWN_NET,
        torch.float32, device="cpu")
    return mine, theirs


def _frames(count, seed=0, shift=(2.0, 1.0)):
    """A textured scene with people drawn on it, moved by `shift` px per
    frame."""
    rng = np.random.RandomState(seed)
    people = synthetic.random_people(rng, 2, HW, height_range=(60, 90))
    scene = synthetic.render_scene_image(people, HW, rng).astype(np.float32)
    texture = ndi.gaussian_filter(rng.uniform(0, 255, HW), 2.0)
    scene = 0.5 * scene + 0.5 * texture[..., None]
    return [np.clip(ndi.shift(scene, (shift[1] * i, shift[0] * i, 0), order=1,
                              mode="nearest"), 0, 255).astype(np.uint8)
            for i in range(count)]


def _assert_same(got, want, what):
    if want is None:
        assert got is None, what
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-2,
                               err_msg=what)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-3,
                               err_msg=what)


def _assert_datums_match(got, want):
    _assert_same(got.pose_keypoints, want.pose_keypoints, "pose")
    np.testing.assert_allclose(got.pose_scores, want.pose_scores, atol=1e-3)
    _assert_same(got.face_keypoints, want.face_keypoints, "face")
    _assert_same(got.hand_left_keypoints, want.hand_left_keypoints, "left")
    _assert_same(got.hand_right_keypoints, want.hand_right_keypoints, "right")
    for name in ("face_rectangles", "hand_rectangles"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_allclose(np.asarray(g, np.float64).ravel(),
                                       np.asarray(w, np.float64).ravel(),
                                       atol=2e-2, err_msg=name)
    assert got.scale_input_to_net == want.scale_input_to_net
    assert got.net_input_sizes == want.net_input_sizes
    assert got.net_output_size == want.net_output_size
    assert got.scale_net_to_output == want.scale_net_to_output


def _both(wrappers, image, **kwargs):
    mine, theirs = wrappers
    return mine.process(image, **kwargs), theirs.process(image, **kwargs)


# --- the surface ----------------------------------------------------------


@pytest.mark.parametrize("name", ["PoseConfig", "FaceConfig", "HandConfig",
                                  "Datum"])
def test_dataclasses_equal(name):
    mine = dataclasses.fields(getattr(wrapper, name))
    theirs = dataclasses.fields(getattr(jwrapper, name))
    assert [f.name for f in mine] == [f.name for f in theirs]
    for a, b in zip(mine, theirs):
        if a.name == "model":
            assert a.default.name == b.default.name
        else:
            assert a.default == b.default, a.name


def test_two_wrappers_do_not_share_a_mutated_hand_config():
    """`hand.detector == 3` switches hand tracking on for that Wrapper only:
    not in the caller's config object, and not in a Wrapper built later
    from the defaults."""
    off = wrapper.PoseConfig(enable=False)
    asked = wrapper.HandConfig(detector=3)
    first = wrapper.Wrapper(off, hand=asked, device="cpu")
    assert first.hand_cfg.tracking is True
    assert asked.tracking is False
    second = wrapper.Wrapper(off, device="cpu")
    assert second.hand_cfg.tracking is False
    assert wrapper.HandConfig().tracking is False
    third = wrapper.Wrapper(off, hand=asked, device="cpu")
    third.hand_cfg.render_threshold = 0.9
    assert first.hand_cfg.render_threshold == asked.render_threshold == 0.2
    assert first.pose_cfg is not second.pose_cfg is not off


def test_compute_dtype_strings():
    off = dict(face=None, hand=None, device="cpu")
    for text, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        w = wrapper.Wrapper(wrapper.PoseConfig(
            model=wrapper.PoseModel.MPI_15_4, compute_dtype=text), **off)
        assert w.pose_extractor.compute_dtype == dtype
        assert w.pose_extractor.device == torch.device("cpu")


def test_rejects_a_frame_that_is_not_bgr(wrappers):
    with pytest.raises(ValueError, match="BGR"):
        wrappers[0].process(np.zeros((32, 32), np.uint8))


# --- process, case by case --------------------------------------------------


def test_process_plain_matches_jax(wrappers):
    frame = _frames(1)[0]
    got, want = _both(wrappers, frame, datum_id=0, name="f0")
    assert got.id == 0 and got.name == "f0" and got.frame is frame
    assert got.pose_keypoints.shape == (3, 25, 3)       # number_people_max
    assert got.face_keypoints.shape == (3, 70, 3)
    assert got.hand_left_keypoints.shape == (3, 21, 3)
    _assert_datums_match(got, want)
    stages = wrappers[0].profiler.averages_ms()
    assert set(stages) == {"pose", "face", "hand"}
    assert all(ms > 0 for ms in stages.values())


def test_process_number_people_max_matches_jax(wrappers):
    frame = _frames(1, seed=1)[0]
    counts = {}
    try:
        for nmax in (-1, 1):
            for w in wrappers:
                w.pose_cfg.number_people_max = nmax
            got, want = _both(wrappers, frame)
            _assert_datums_match(got, want)
            counts[nmax] = got.pose_keypoints.shape[0]
    finally:
        for w in wrappers:
            w.pose_cfg.number_people_max = 3
    assert counts[1] == 1 and counts[-1] > 3
    # the one kept is the best-scoring person
    assert got.pose_scores[0] == pytest.approx(want.pose_scores.max())


def test_process_refined_matches_jax(wrappers):
    frame = _frames(1, seed=2)[0]
    for w in wrappers:
        w.pose_cfg.top_down_refinement = True
    try:
        got, want = _both(wrappers, frame)
    finally:
        for w in wrappers:
            w.pose_cfg.top_down_refinement = False
    _assert_datums_match(got, want)


def test_process_part_candidates_and_heatmaps_match_jax(wrappers):
    frame = _frames(1, seed=3)[0]
    for w in wrappers:
        w.pose_cfg.part_candidates = True
    try:
        got, want = _both(wrappers, frame, keep_heatmaps=True)
    finally:
        for w in wrappers:
            w.pose_cfg.part_candidates = False
    _assert_datums_match(got, want)
    assert len(got.part_candidates) == len(want.part_candidates) == 25
    for g, w in zip(got.part_candidates, want.part_candidates):
        assert g.shape == w.shape and g.shape[1] == 3
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
    assert sum(len(c) for c in got.part_candidates) > 25
    assert got.heatmaps.shape == want.heatmaps.shape == (12, 20, 78)
    np.testing.assert_allclose(got.heatmaps, want.heatmaps, rtol=1e-4,
                               atol=1e-3)
    plain, _ = _both(wrappers, frame)
    assert plain.part_candidates is None and plain.heatmaps is None


def test_process_tracking_matches_jax_over_four_frames(wrappers):
    """tracking=1: the CNN runs on frames 0 and 2, LK carries the keypoints
    on frames 1 and 3 (and the face and hand stages follow them)."""
    mine, theirs = wrappers
    frames = _frames(4, seed=4)
    cnn_calls = []
    forward = mine.pose_extractor.forward
    mine.pose_extractor.forward = lambda *a, **k: (cnn_calls.append(1),
                                                   forward(*a, **k))[1]
    try:
        datums = [_both(wrappers, frame, datum_id=i)
                  for i, frame in enumerate(frames)]
    finally:
        mine.pose_extractor.forward = forward
    assert len(cnn_calls) == 2
    for got, want in datums:
        _assert_datums_match(got, want)
    cnn0, lk1 = datums[0][0], datums[1][0]
    assert lk1.pose_keypoints.shape == cnn0.pose_keypoints.shape
    np.testing.assert_array_equal(lk1.pose_scores, cnn0.pose_scores)
    moved = (lk1.pose_keypoints[..., 2] > 0.05)
    assert moved.any()
    flow = (lk1.pose_keypoints - cnn0.pose_keypoints)[moved][:, :2]
    assert np.abs(np.median(flow, axis=0) - [2.0, 1.0]).max() < 0.5


def test_process_provided_rectangles_match_jax(wrappers):
    """Detector mode 2: faces and hands where the caller says."""
    frame = _frames(1, seed=5)[0]
    faces = [(30.0, 20.0, 40.0, 40.0), (120.0, 50.0, 32.0, 32.0)]
    hands = [((10.0, 60.0, 30.0, 30.0), (90.0, 70.0, 36.0, 36.0))]
    for w in wrappers:
        w.face_cfg.detector = w.hand_cfg.detector = 2
    try:
        got, want = _both(wrappers, frame, face_rectangles=faces,
                          hand_rectangles=hands)
        none, _ = _both(wrappers, frame)
    finally:
        for w in wrappers:
            w.face_cfg.detector = w.hand_cfg.detector = 0
    _assert_datums_match(got, want)
    assert got.face_rectangles == faces and got.hand_rectangles == hands
    assert got.face_keypoints.shape == (2, 70, 3)
    assert got.hand_right_keypoints.shape == (1, 21, 3)
    assert none.face_rectangles == [] and none.face_keypoints is None
    assert none.hand_left_keypoints is None


def test_process_pose_net_output_matches_jax_and_recovers_people(wrappers):
    """Placed people, rendered as the body net's output, come back through
    `process(pose_net_output=...)` on both sides."""
    mine, _ = wrappers
    info = mine.pose_extractor.info
    rng = np.random.RandomState(6)
    hw = (NET[1], NET[0])
    people = synthetic.random_people(rng, 2, hw, height_range=(60, 80))
    pairs, map_idx = paf.pair_tables(info)
    net_output = synthetic.make_targets(people[None], pairs, map_idx, hw,
                                        info.num_parts,
                                        info.heatmap_channels)[0]
    frame = synthetic.render_scene_image(people, hw, rng)
    got, want = _both(wrappers, frame, pose_net_output=net_output)
    _assert_datums_match(got, want)
    assert got.pose_keypoints.shape[0] == 2
    for person in people:
        dist = np.abs(got.pose_keypoints[:, :, :2]
                      - person[None, :, :2]).max(axis=(1, 2))
        assert dist.min() <= 8.0
    assert got.face_keypoints.shape == (2, 70, 3)


def test_hand_tracking_mode_follows_the_previous_rectangles(wrappers):
    """Hand detector mode 3 (tracking): the second frame's rectangles are
    matched to the first frame's on both sides."""
    frames = _frames(2, seed=7)
    for w in wrappers:
        w.hand_cfg.detector, w.hand_cfg.tracking = 3, True
        w._prev_hand_rects = []
    try:
        for i, frame in enumerate(frames):
            got, want = _both(wrappers, frame, datum_id=2 * i)
            _assert_datums_match(got, want)
    finally:
        for w in wrappers:
            w.hand_cfg.detector, w.hand_cfg.tracking = 0, False
            w._prev_hand_rects = []


# --- the other detectors ------------------------------------------------------


def test_face_without_body_uses_the_haar_detector():
    from openpose_tpu_torch.face import haar
    if haar._find_default_cascade() is None:
        pytest.skip("no haarcascade_frontalface_alt.xml on this machine")
    configs = (dict(enable=False),
               dict(enable=True, net_resolution=TOPDOWN_NET))
    mine = wrapper.Wrapper(wrapper.PoseConfig(**configs[0]),
                           wrapper.FaceConfig(**configs[1]), device="cpu")
    theirs = jwrapper.Wrapper(jwrapper.PoseConfig(**configs[0]),
                              jwrapper.FaceConfig(**configs[1]))
    assert mine._haar_detector is not None and mine.pose_extractor is None
    frame = _frames(1, seed=8)[0]
    got, want = mine.process(frame), theirs.process(frame)
    assert got.pose_keypoints is None
    assert got.face_rectangles == want.face_rectangles == []
    assert got.face_keypoints is None and want.face_keypoints is None


def test_render_is_imported_only_when_called(wrappers):
    """`render()` draws through `render/render.py` (OpenCV), imported
    inside the call; the overlay equals the JAX package's."""
    frame = _frames(1, seed=9)[0]
    got, want = _both(wrappers, frame)
    out_mine = wrappers[0].render(got)
    out_theirs = wrappers[1].render(want)
    assert out_mine.shape == frame.shape and got.output_frame is out_mine
    assert (out_mine != frame).any()
    # positions agree to 1e-2 px, so a line's rounded end may move by one
    assert (out_mine != out_theirs).mean() < 1e-3
