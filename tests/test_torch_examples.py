"""The port's tutorials (`openpose_tpu_torch/examples/`) against the same
calls in the JAX package (CPU, float32).

The JAX tutorials 01-08 do their work when imported, on files named on the
command line, so the JAX side here makes the calls they make, on frames in
memory, through one `Wrapper` (BODY_25 + face + hand).  Both packages read
the same seeded random weights, written as caffemodels; `-1x64`, face and
hand nets at 64.  Tolerances are `tests/test_torch_wrapper.py`'s: the
same people in the same order, keypoints within 1e-2 px and scores within
1e-3, heatmaps within 1e-3; 3-D points within 1e-2 (in the rig's units)
and their scores within 1e-3.  Tutorial 09 is held to the JAX tutorial's
own `main`, by what it prints.
"""

import importlib
import importlib.util
import pathlib

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from openpose_tpu import wrapper as jwrapper
from openpose_tpu.threed import triangulation as jtriangulation
from openpose_tpu_torch import synthetic, wrapper
from openpose_tpu_torch.io import producers
from openpose_tpu_torch.models import caffe_proto, graph

ROOT = pathlib.Path(__file__).resolve().parents[1]
HW = (120, 200)
NET = (-1, 64)
TOPDOWN_NET = 64


def tutorial(name):
    return importlib.import_module(f"openpose_tpu_torch.examples.{name}")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded random weights of the three nets as caffemodels: {spec name:
    path}."""
    root = tmp_path_factory.mktemp("weights")
    paths = {}
    for seed, name in enumerate(("body_25", "face_70", "hand_21")):
        params = graph.init_params(graph.load_spec(name),
                                   torch.Generator().manual_seed(seed))
        layers = {layer: [p["w"].numpy(), p["b"].numpy()] if "w" in p
                  else [p["slope"].numpy()] for layer, p in params.items()}
        paths[name] = root / f"{name}.caffemodel"
        paths[name].write_bytes(caffe_proto.serialize_caffemodel(layers))
    return {name: str(path) for name, path in paths.items()}


@pytest.fixture(scope="module")
def configs(weights):
    """The port's configs for the tutorials: float32, the small nets."""
    return dict(
        pose=wrapper.PoseConfig(net_resolution=NET, compute_dtype="float32",
                                caffemodel=weights["body_25"]),
        face=wrapper.FaceConfig(enable=True, net_resolution=TOPDOWN_NET,
                                caffemodel=weights["face_70"]),
        hand=wrapper.HandConfig(enable=True, net_resolution=TOPDOWN_NET,
                                caffemodel=weights["hand_21"]))


@pytest.fixture(scope="module")
def theirs(weights):
    """The JAX `Wrapper` that makes the JAX tutorials' calls."""
    return jwrapper.Wrapper(
        jwrapper.PoseConfig(net_resolution=NET, compute_dtype="float32",
                            caffemodel=weights["body_25"]),
        jwrapper.FaceConfig(enable=True, net_resolution=TOPDOWN_NET,
                            caffemodel=weights["face_70"]),
        jwrapper.HandConfig(enable=True, net_resolution=TOPDOWN_NET,
                            caffemodel=weights["hand_21"]))


@pytest.fixture(scope="module")
def frames():
    """Three textured scenes of two drawn people, moved 2 px a frame."""
    rng = np.random.RandomState(0)
    people = synthetic.random_people(rng, 2, HW, height_range=(60, 90))
    scene = synthetic.render_scene_image(people, HW, rng).astype(np.float32)
    texture = ndi.gaussian_filter(rng.uniform(0, 255, HW), 2.0)
    scene = 0.5 * scene + 0.5 * texture[..., None]
    return [np.clip(ndi.shift(scene, (i, 2.0 * i, 0), order=1,
                              mode="nearest"), 0, 255).astype(np.uint8)
            for i in range(3)]


def assert_keypoints_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-2,
                               err_msg=what)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-3,
                               err_msg=what)


def test_01_body_from_image(configs, theirs, frames, capsys):
    _, datum = tutorial("01_body_from_image").body_from_image(
        frames[0], pose=configs["pose"], device="cpu")
    assert "Body keypoints:" in capsys.readouterr().out
    want = theirs.process(frames[0])
    assert want.pose_keypoints.shape[0] > 0
    assert_keypoints_close(datum.pose_keypoints, want.pose_keypoints, "pose")
    np.testing.assert_allclose(datum.pose_scores, want.pose_scores,
                               atol=1e-3)


def test_02_whole_body_from_image(configs, theirs, frames, capsys):
    _, datum = tutorial("02_whole_body_from_image").whole_body_from_image(
        frames[1], device="cpu", **configs)
    printed = capsys.readouterr().out
    want = theirs.process(frames[1])
    assert f"face: {want.face_keypoints.shape}" in printed
    for name in ("pose_keypoints", "face_keypoints", "hand_left_keypoints",
                 "hand_right_keypoints"):
        assert_keypoints_close(getattr(datum, name), getattr(want, name),
                               name)


def test_03_heatmaps_from_image(configs, theirs, frames, capsys):
    pred = tutorial("03_heatmaps_from_image").heatmaps_from_image(
        frames[0], pose=configs["pose"], device="cpu")
    want = theirs.pose_extractor.forward(frames[0], net_resolution=NET,
                                         keep_heatmaps=True)
    assert f"heatmaps: {want.heatmaps.shape}" in capsys.readouterr().out
    np.testing.assert_allclose(pred.heatmaps, np.asarray(want.heatmaps),
                               atol=1e-3)


def test_04_video_async(configs, theirs, frames, capsys):
    views = [[producers.Frame(image=f, frame_id=i)]
             for i, f in enumerate(frames)]
    stats, results = tutorial("04_video_async").video_async(
        iter(views), pose=configs["pose"], device="cpu")
    assert stats.frames == 3 and len(results) == 3
    assert "3 frames at" in capsys.readouterr().out
    for i, (got, frame) in enumerate(zip(results, frames)):
        assert_keypoints_close(got, theirs.process(frame, i).pose_keypoints,
                               f"frame {i}")


def test_05_multiview_3d(configs, theirs, frames):
    """Three views of one scene, view v moved 8v px to the left, cameras
    0.2 apart along x at focal 100 px: the port's 3-D people equal those
    of the JAX `reconstruct_array` over the JAX Wrapper's views."""
    images = [np.roll(frames[0], -8 * v, axis=1) for v in range(3)]
    k = np.array([[100.0, 0, HW[1] / 2], [0, 100.0, HW[0] / 2], [0, 0, 1]])
    cams = np.stack([k @ np.hstack([np.eye(3), [[-0.2 * v], [0], [0]]])
                     for v in range(3)]).astype(np.float32)
    _, kp3d = tutorial("05_multiview_3d").multiview_3d(
        images, cams, pose=configs["pose"], device="cpu")
    want = np.asarray(jtriangulation.reconstruct_array(
        [theirs.process(image).pose_keypoints for image in images], cams,
        [(HW[1], HW[0])] * 3))
    assert kp3d.shape == want.shape and kp3d.shape[0] > 0
    np.testing.assert_allclose(kp3d[..., :3], want[..., :3], atol=1e-2)
    np.testing.assert_allclose(kp3d[..., 3], want[..., 3], atol=1e-3)


def test_06_train_from_coco_takes_a_step(tmp_path):
    """Two images written with OpenCV and their people as COCO
    annotations: one float32 step of the port's trainer, a checkpoint
    written and a finite loss."""
    cv2 = pytest.importorskip("cv2")
    from openpose_tpu_torch.models import checkpoint
    from openpose_tpu_torch.train_loop import TrainConfig
    rng = np.random.RandomState(1)
    images, gts = [], []
    for i in range(2):
        people = synthetic.random_people(rng, 1, HW, height_range=(60, 90))
        cv2.imwrite(str(tmp_path / f"{i}.png"),
                    synthetic.render_scene_image(people, HW, rng))
        images.append({"id": i, "file_name": f"{i}.png"})
        gts.extend(synthetic.coco_ground_truth(people, i))
    annotations = tmp_path / "annotations.json"
    annotations.write_text(__import__("json").dumps(
        {"images": images, "annotations": gts}))
    config = TrainConfig(image_size=(48, 64), batch_size=1, steps=1,
                         checkpoint_dir=str(tmp_path / "ckpt"))
    state = tutorial("06_train_from_coco").train_from_coco(
        str(tmp_path), str(annotations), config, device="cpu")
    saved = tmp_path / "ckpt" / "BODY_25_step1.npz"
    assert saved.exists() and state is not None
    params = checkpoint.load_npz(str(saved))
    assert all(torch.isfinite(v).all() for sub in params.values()
               for v in sub.values())


def test_07_face_from_rectangles(weights, theirs, frames, capsys):
    rects = [(60.0, 10.0, 40.0, 40.0), (120.0, 50.0, 50.0, 50.0)]
    got = tutorial("07_face_from_rectangles").face_from_rectangles(
        frames[0], rects, caffemodel=weights["face_70"],
        net_size=TOPDOWN_NET, device="cpu")
    assert "face keypoints: (2, 70, 3)" in capsys.readouterr().out
    want = theirs.face_extractor.forward(frames[0].astype("float32"), rects)
    assert_keypoints_close(got, want, "face")


def test_08_hand_from_rectangles(weights, theirs, frames, capsys):
    rects = [((80.0, 60.0, 30.0, 30.0), (20.0, 70.0, 35.0, 35.0)),
             ((0.0, 0.0, 0.0, 0.0), (140.0, 20.0, 40.0, 40.0))]
    left, right = tutorial("08_hand_from_rectangles").hand_from_rectangles(
        frames[0], rects, caffemodel=weights["hand_21"],
        net_size=TOPDOWN_NET, device="cpu")
    assert "left hands: (2, 21, 3)" in capsys.readouterr().out
    want_left, want_right = theirs.hand_extractor.forward(
        frames[0].astype("float32"), rects)
    assert_keypoints_close(left, want_left, "left")
    assert_keypoints_close(right, want_right, "right")


def test_09_prints_what_the_jax_tutorial_prints(theirs, monkeypatch,
                                                 capsys):
    """The port's tutorial 09 and the JAX tutorial's `main` print the same
    lines: both people found, each at the same mean x.  The JAX `main`
    gets the Wrapper's BODY_25 model from its loader (the net's weights are
    bypassed)."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_09", ROOT / "examples" / "09_keypoints_from_heatmaps.py")
    jax_tutorial = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tutorial)
    monkeypatch.setattr(jax_tutorial.zoo, "load_pose_model",
                        lambda *args, **kwargs: theirs.pose_extractor.model)
    jax_tutorial.main()
    want = capsys.readouterr().out
    pred, means = tutorial("09_keypoints_from_heatmaps") \
        .keypoints_from_heatmaps(device="cpu")
    assert capsys.readouterr().out == want
    assert want.startswith("people found: 2\n")
    assert pred.keypoints.shape[0] == 2 and len(means) == 2
