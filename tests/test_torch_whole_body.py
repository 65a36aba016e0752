"""Port whole-body cascade vs the JAX package (CPU, float32).

The face and hand nets, the affine crop, both argmax decodes, the per-crop
`TopDownExtractor` (with the face and hand extractors), the batched
`TopDownInference` (JAX `ShardedTopDown`) and `WholeBodyInference` (JAX
`ShardedWholeBody`) each get the same numpy inputs and the same weights
(JAX's, through the bridge) as their JAX counterparts, at the sizes of
`tests/test_whole_body.py` (net size 64, people_cap 2).

Tolerances: nets rtol = atol = 1e-4 (convolutions sum in another order);
crops atol 1e-3 on 0..255 pixels (two bilinear taps per axis, summed by
matrix products in another order); decoded keypoints at the same pixel
(atol 1e-2) with scores within 1e-4; injected people exact to 1e-3 px.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openpose_tpu.face.detector import detect_faces
from openpose_tpu.face.extractor import FaceExtractor as JaxFaceExtractor
from openpose_tpu.hand.detector import detect_hands
from openpose_tpu.hand.extractor import HandExtractor as JaxHandExtractor
from openpose_tpu.models import graph as jgraph
from openpose_tpu.models import zoo as jzoo
from openpose_tpu.ops import maximum as jmaximum
from openpose_tpu.ops import warp as jwarp
from openpose_tpu.params import PoseModel
from openpose_tpu.parallel import mesh as mesh_lib
from openpose_tpu.parallel.inference import ShardedTopDown
from openpose_tpu.runtime.topdown import TopDownExtractor as JaxTopDown
from openpose_tpu.runtime.whole_body import ShardedWholeBody
from openpose_tpu_torch import synthetic
from openpose_tpu_torch.face.extractor import FaceExtractor
from openpose_tpu_torch.hand.extractor import HandExtractor
from openpose_tpu_torch.models import checkpoint, graph, zoo
from openpose_tpu_torch.ops import maximum, paf, warp
from openpose_tpu_torch.parallel.inference import TopDownInference
from openpose_tpu_torch.runtime.topdown import TopDownExtractor
from openpose_tpu_torch.runtime.whole_body import WholeBodyInference

NET = 64          # face and hand net input side in these tests


def _mesh(n):
    devices = jax.devices()
    if len(devices) < n:
        pytest.skip(f"needs {n} devices")
    return mesh_lib.make_mesh(devices[:n], model=1)


def _port(jax_model):
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jax_model.params.items()}
    return zoo.from_params(jax_model.spec, checkpoint.from_jax_params(params),
                           jax_model.info, device="cpu")


@pytest.fixture(scope="module")
def face():
    jax_model = jzoo.load_face_model()
    return jax_model, _port(jax_model)


@pytest.fixture(scope="module")
def hand():
    jax_model = jzoo.load_hand_model()
    return jax_model, _port(jax_model)


# --- nets -----------------------------------------------------------------


@pytest.mark.parametrize("name,channels", [("face_70", 71), ("hand_21", 22)])
def test_face_and_hand_nets_match_jax(name, channels):
    """The published FACE and HAND graphs, with random biases and weights
    from JAX through the bridge, at a 40x40 input."""
    spec = jgraph.load_spec(name)
    # the port keeps its own NetSpec class and spec files: same content
    assert graph.load_spec(name).to_json() == spec.to_json()
    params = jgraph.init_params(spec, jax.random.PRNGKey(3))
    rng = np.random.RandomState(3)
    params = {k: {kk: np.asarray(vv) if kk != "b" else rng.uniform(
        -0.1, 0.1, vv.shape).astype(np.float32) for kk, vv in v.items()}
        for k, v in params.items()}
    image = rng.uniform(-0.5, 0.5, (2, 40, 40, 3)).astype(np.float32)
    want = np.asarray(jgraph.forward(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
         for k, v in params.items()}, spec, jnp.asarray(image), jnp.float32))
    model = zoo.from_params(spec, checkpoint.from_jax_params(params),
                            device="cpu")
    with torch.inference_mode():
        got = model.forward(torch.from_numpy(image), torch.float32).numpy()
    assert got.shape == want.shape == (2, 5, 5, channels)
    assert graph.channels(spec)[spec.output] == channels
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_face_and_hand_loaders_are_seeded():
    for load, seed, spec in ((zoo.load_face_model, 1, "face_70"),
                             (zoo.load_hand_model, 2, "hand_21")):
        a, b = load(device="cpu"), load(seed=seed, device="cpu")
        assert a.spec.to_json() == jgraph.load_spec(spec).to_json()
        for (na, pa), (nb, pb) in zip(a.net.state_dict().items(),
                                      b.net.state_dict().items()):
            assert na == nb and torch.equal(pa, pb)
        other = load(seed=seed + 10, device="cpu")
        assert not all(torch.equal(pa, pb) for pa, pb in zip(
            a.net.state_dict().values(), other.net.state_dict().values()))


# --- warp -----------------------------------------------------------------


def _transforms(net=16):
    return np.array([
        warp.rect_to_transform((5.0, 6.0, 20.0, 20.0), net, False),
        warp.rect_to_transform((5.0, 6.0, 20.0, 20.0), net, True),   # mirror
        warp.rect_to_transform((-9.5, 21.25, 30.0, 24.0), net, False),
        warp.rect_to_transform((30.0, -4.0, 14.0, 14.0), net, True),
        TopDownInference.INACTIVE], np.float32)


def test_rect_transforms_and_maps_match_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-5, 40, (7, 2)).astype(np.float32)
    for rect in ((5.0, 6.0, 20.0, 20.0), (-9.5, 21.25, 30.0, 24.0)):
        for mirror in (False, True):
            tr = warp.rect_to_transform(rect, 16, mirror)
            assert tr == jwarp.rect_to_transform(rect, 16, mirror)
            np.testing.assert_array_equal(warp.map_back(pts, tr),
                                          jwarp.map_back(pts, tr))
            np.testing.assert_array_equal(warp.map_forward(pts, tr),
                                          jwarp.map_forward(pts, tr))
            np.testing.assert_allclose(
                warp.map_back(warp.map_forward(pts, tr), tr), pts, atol=1e-4)


def test_crop_affine_matches_jax():
    """Plain, mirrored, partly outside and inactive crops; one image and a
    batch of two."""
    rng = np.random.RandomState(1)
    images = rng.uniform(0, 255, (2, 30, 40, 3)).astype(np.float32)
    tr = _transforms()
    batch = np.stack([tr, tr[::-1].copy()])
    got = warp.crop_affine_batch(torch.from_numpy(images),
                                 torch.from_numpy(batch), 16).numpy()
    assert got.shape == (2, 5, 16, 16, 3)
    for b in range(2):
        want = np.asarray(jwarp.crop_affine_batch(
            jnp.asarray(images[b]), jnp.asarray(batch[b]), 16))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-3)
        one = warp.crop_affine_batch(torch.from_numpy(images[b]),
                                     torch.from_numpy(batch[b]), 16).numpy()
        np.testing.assert_array_equal(one, got[b])
    assert not got[0, 4].any() and not got[1, 0].any()   # inactive: black
    assert (got[0, 2, :, :5] == 0).all()       # left of the image: black
    assert got[0, 2, :, 8:].any()
    # the mirror reads the same pixels right to left
    np.testing.assert_allclose(got[0, 1, :, ::-1][:, :-1],
                               got[0, 0][:, 1:], rtol=0, atol=1e-3)


# --- argmax decodes -------------------------------------------------------


def _peaked_maps(seed, n=3, h=9, w=11, c=6):
    """Smooth maps with one Gaussian peak per channel, some on the border."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    maps = rng.uniform(0, 0.05, (n, h, w, c)).astype(np.float32)
    centres = [(0.0, 0.0), (h - 1, w - 1), (0.0, w - 1.3)]
    for i in range(n):
        for ch in range(c):
            cy, cx = centres[ch] if ch < len(centres) and i == 0 else (
                rng.uniform(0, h - 1), rng.uniform(0, w - 1))
            sig = rng.uniform(0.8, 1.6)
            maps[i, :, :, ch] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                        / (2 * sig * sig))
    return maps


def test_channel_argmax_matches_jax():
    maps = _peaked_maps(2)
    maps[1, 3, 4, 0] = maps[1, 5, 2, 0] = 9.0     # a tie: the first wins
    got = maximum.channel_argmax(torch.from_numpy(maps)).numpy()
    want = np.asarray(jmaximum.channel_argmax(jnp.asarray(maps)))
    np.testing.assert_array_equal(got, want)
    assert tuple(got[1, 0, :2]) == (4.0, 3.0)


@pytest.mark.parametrize("seed", [4, 5])
def test_channel_argmax_refined_matches_jax(seed):
    """The windowed decode, including peaks on the map's border (where it
    differs from a full upsample, and the port holds the windowed one)."""
    maps = _peaked_maps(seed)
    got = maximum.channel_argmax_refined(torch.from_numpy(maps)).numpy()
    want = np.asarray(jmaximum.channel_argmax_refined(jnp.asarray(maps)))
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-5,
                               atol=1e-6)
    # the peaks on the first and the last map pixel decode into that
    # pixel's 8x8 block of the upsampled grid
    assert (got[0, 0, :2] < 8).all()
    assert got[0, 1, 0] >= 80 and got[0, 1, 1] >= 64
    np.testing.assert_array_equal(maximum._window_cubic_matrix(8),
                                  jmaximum._window_cubic_matrix(8))


# --- per-crop extractors --------------------------------------------------


def _frame(seed, hw=(96, 128)):
    return np.random.RandomState(seed).randint(0, 255, hw + (3,)) \
        .astype(np.uint8)


def _assert_keypoints_equal(got, want):
    """Same decoded pixel (map_back is exact arithmetic on both sides),
    scores within 1e-4."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-4,
                               atol=1e-4)


def test_topdown_and_face_extractor_match_jax(face):
    jax_model, port_model = face
    image = _frame(1).astype(np.float32)
    rects = [(10.0, 12.0, 40.0, 40.0), (60.0, 30.0, 1.0, 30.0),   # too thin
             (90.0, 50.0, 50.0, 50.0)]                            # partly out
    mirror = [False, False, True]
    want = JaxTopDown(jax_model, NET, jnp.float32).extract(image, rects,
                                                           mirror, 70)
    got = TopDownExtractor(port_model, NET, torch.float32,
                           device="cpu").extract(image, rects, mirror, 70)
    assert not got[1].any()
    _assert_keypoints_equal(got, want)
    want_face = JaxFaceExtractor(jax_model, NET, jnp.float32).forward(
        image, rects[:1])
    got_face = FaceExtractor(port_model, NET, torch.float32,
                             device="cpu").forward(image, rects[:1])
    _assert_keypoints_equal(got_face, want_face)


@pytest.mark.parametrize("scale_number", [1, 2])
def test_hand_extractor_matches_jax(hand, scale_number):
    """Left hands mirrored; with 2 scales each hand keeps its best scale."""
    jax_model, port_model = hand
    image = _frame(2).astype(np.float32)
    rects = [((10.0, 12.0, 36.0, 36.0), (50.0, 20.0, 30.0, 30.0)),
             ((70.0, 40.0, 40.0, 40.0), (0.0, 0.0, 0.0, 0.0))]
    want = JaxHandExtractor(jax_model, NET, jnp.float32,
                            scale_number=scale_number).forward(image, rects)
    got = HandExtractor(port_model, NET, torch.float32,
                        scale_number=scale_number,
                        device="cpu").forward(image, rects)
    for g, w in zip(got, want):
        assert g.shape == (2, 21, 3)
        _assert_keypoints_equal(g, w)
    assert not got[1][1].any()
    assert HandExtractor(port_model, NET, device="cpu").forward(
        image, [])[0].shape == (0, 21, 3)


# --- batched top-down -----------------------------------------------------


def test_topdown_inference_matches_sharded_jax(face):
    """Active slots equal JAX's; the slots after the last active one are
    zeros, as in JAX's tier programs; an inactive slot before an active one
    is cropped (black) and decoded as in JAX."""
    jax_model, port_model = face
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 255, (4, 96, 128, 3)).astype(np.uint8)
    td_jax = ShardedTopDown(jax_model, _mesh(4), net_size=NET, people_cap=2,
                            compute_dtype=jnp.float32)
    td = TopDownInference(port_model, net_size=NET, people_cap=2,
                          compute_dtype=torch.float32, device="cpu")
    transforms = np.tile(np.asarray(td.INACTIVE, np.float32), (4, 2, 1))
    for i in range(4):
        transforms[i, 0] = warp.rect_to_transform(
            (10.0 + i, 12.0, 40.0, 40.0), NET, mirror=bool(i % 2))
    transforms[2, 1] = warp.rect_to_transform((60.0, 40.0, 50.0, 50.0), NET,
                                              mirror=False)
    transforms[3] = (td.INACTIVE, transforms[3, 0])   # active slot 1 only
    assert td.active_slots(transforms) == 2
    want = np.asarray(td_jax(frames, transforms))
    got = td(frames, transforms).numpy()
    assert got.shape == want.shape == (4, 2, 71, 3)
    _assert_keypoints_equal(got, want)

    transforms[:, 1] = td.INACTIVE
    transforms[3, 0] = transforms[0, 0]
    assert td.active_slots(transforms) == 1
    got = td(frames, transforms).numpy()
    want = np.asarray(td_jax(frames, transforms))
    _assert_keypoints_equal(got[:, 0], want[:, 0])
    assert not got[:, 1].any()

    transforms[:] = td.INACTIVE
    assert td.active_slots(transforms) == 0
    assert not td(frames, transforms).numpy().any()


def test_topdown_inference_decode_only_matches_jax(face):
    """The injected net output replaces the crop and the CNN."""
    jax_model, port_model = face
    maps = np.stack([_peaked_maps(6, n=2, h=8, w=8, c=71),
                     _peaked_maps(7, n=2, h=8, w=8, c=71)])
    td_jax = ShardedTopDown(jax_model, _mesh(2), net_size=NET, people_cap=2,
                            compute_dtype=jnp.float32)
    td = TopDownInference(port_model, net_size=NET, people_cap=2,
                          device="cpu")
    want = np.asarray(td_jax(None, None, net_output=maps))
    got = td(None, None, net_output=maps).numpy()
    assert got.shape == (2, 2, 71, 3)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-5,
                               atol=1e-6)


# --- whole body -----------------------------------------------------------


def _mpi_person(cx, cy):
    """MPI_15 keypoints of an upright person with face and hand geometry
    (the person of tests/test_whole_body.py)."""
    kp = np.zeros((15, 3), np.float32)
    kp[:8] = [(cx, cy - 18, 0.9), (cx, cy - 6, 0.9), (cx + 8, cy - 6, 0.9),
              (cx + 14, cy + 4, 0.9), (cx + 18, cy + 14, 0.9),
              (cx - 8, cy - 6, 0.9), (cx - 14, cy + 4, 0.9),
              (cx - 18, cy + 14, 0.9)]
    return kp


def test_whole_body_topdown_stages_match_jax(face, hand):
    """Fabricated people through the face and hand stages of both
    cascades: the same rects, crops and keypoints."""
    from openpose_tpu.runtime.whole_body import WholeBodyResult as JaxResult
    from openpose_tpu_torch.runtime.whole_body import WholeBodyResult
    jax_pose = jzoo.load_pose_model(PoseModel.MPI_15_4)
    kw = dict(frame_hw=(96, 128), net_hw=(64, 80), people_cap=2,
              max_peaks=16, face_net_size=NET, hand_net_size=NET)
    wb_jax = ShardedWholeBody(jax_pose, face[0], hand[0], mesh=_mesh(4),
                              compute_dtype=jnp.float32, **kw)
    wb = WholeBodyInference(_port(jax_pose), face[1], hand[1],
                            compute_dtype=torch.float32, **kw, device="cpu")
    frames = np.random.RandomState(2).randint(0, 255, (4, 96, 128, 3)) \
        .astype(np.uint8)
    people = [np.stack([_mpi_person(40 + 6 * i, 40),
                        _mpi_person(90 - 4 * i, 50)]) for i in range(4)]
    want = [JaxResult(p, np.array([0.8, 0.7])) for p in people]
    got = [WholeBodyResult(p, np.array([0.8, 0.7])) for p in people]
    pose_enum = PoseModel.MPI_15_4
    wb_jax._run_topdown(
        frames, want, wb_jax.face,
        lambda kp: [(r, False) for r in detect_faces(kp, pose_enum)],
        70, "face")

    def hand_rects(kp):
        return [x for lr in detect_hands(kp, pose_enum)
                for x in ((lr[0], True), (lr[1], False))]
    wb_jax._run_topdown(frames, want, wb_jax.hand, hand_rects, 21, "hand")
    frames_dev = torch.from_numpy(frames)
    wb.face_stage(frames_dev, got)
    wb.hand_stage(frames_dev, got)
    for g, w in zip(got, want):
        assert g.face_keypoints.shape == (2, 70, 3)
        assert np.any(w.face_keypoints[..., 2] != 0)
        _assert_keypoints_equal(g.face_keypoints, w.face_keypoints)
        _assert_keypoints_equal(g.hand_left_keypoints, w.hand_left_keypoints)
        _assert_keypoints_equal(g.hand_right_keypoints,
                                w.hand_right_keypoints)


@pytest.mark.parametrize("people_cap", [1, 2])
def test_whole_body_injected_people_match_jax(face, hand, people_cap):
    """Known BODY_25 people as an injected net output through both
    cascades (net_bypass body): the same people, the people cap keeping the
    best scores, and face and hand crops around them."""
    jax_pose = jzoo.load_pose_model(PoseModel.BODY_25)
    info = jax_pose.info
    hw = (184, 320)
    rng = np.random.RandomState(9)
    people = [synthetic.random_people(rng, 2, hw, height_range=(150, 170),
                                      min_spacing=130) for _ in range(2)]
    pairs, map_idx = paf.pair_tables(info)
    net_output = synthetic.make_targets(np.stack(people), pairs, map_idx, hw,
                                        info.num_parts, info.heatmap_channels)
    frames = np.stack([synthetic.render_scene_image(p, hw, rng)
                       for p in people])
    kw = dict(frame_hw=None, net_hw=hw, people_cap=people_cap,
              face_net_size=NET, hand_net_size=NET, net_bypass=True)
    want = ShardedWholeBody(jax_pose, face[0], hand[0], mesh=_mesh(2),
                            compute_dtype=jnp.float32, **kw)(
        frames, net_output=net_output)
    wb = WholeBodyInference(_port(jax_pose), face[1], hand[1],
                            compute_dtype=torch.float32, **kw, device="cpu")
    got = wb(frames, net_output=net_output)
    with pytest.raises(ValueError, match="net_bypass"):
        WholeBodyInference(_port(jax_pose), net_hw=hw, frame_hw=None,
                           device="cpu")(
            frames, net_output=net_output)
    for g, w, placed in zip(got, want, people):
        assert g.pose_keypoints.shape == (people_cap, 25, 3)
        np.testing.assert_allclose(g.pose_keypoints, w.pose_keypoints,
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.pose_scores, w.pose_scores, rtol=1e-5)
        # each is one of those placed, within two map cells (16 px): at
        # this size the 8 px cells merge the blobs of nearby face parts
        for person in g.pose_keypoints:
            err = np.abs(placed[:, :, :2] - person[None, :, :2]).max(
                axis=(1, 2)).min()
            assert err <= 16.0
        assert g.face_keypoints.shape == (people_cap, 70, 3)
        assert np.any(g.face_keypoints[..., 2] != 0)
        _assert_keypoints_equal(g.face_keypoints, w.face_keypoints)
        _assert_keypoints_equal(g.hand_left_keypoints, w.hand_left_keypoints)
        _assert_keypoints_equal(g.hand_right_keypoints,
                                w.hand_right_keypoints)
