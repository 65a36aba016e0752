"""The port's producers, savers, BVH writer, heatmap overlays and GUI
helpers against the JAX package's (CPU).

`io/producers.py`, `io/savers.py` and `render/heatmaps.py` are the
originals' code with OpenCV imported inside the functions that call it, so
`tests/test_torch_standalone.py` cannot hold them as AST copies: these
behaviour tests hold them instead.  Every case gives both packages the same
inputs and wants the same frames, byte-equal files and pixel-equal images.
`io/bvh.py`, `render/gui.py` and `render/gui3d.py` are AST copies; the cases
here run them too.
"""

import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from openpose_tpu.io import bvh as jbvh
from openpose_tpu.io import producers as jproducers
from openpose_tpu.io import savers as jsavers
from openpose_tpu.params import PoseModel as JaxPoseModel
from openpose_tpu.render import gui as jgui
from openpose_tpu.render import heatmaps as jheatmaps
from openpose_tpu.threed import camera as jcamera
from openpose_tpu_torch.io import bvh, producers, savers
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
from openpose_tpu_torch.render import gui, gui3d, heatmaps
from openpose_tpu_torch.threed import camera


@pytest.fixture
def image_dir(tmp_path):
    """Six textured 40x60 frames, each one different."""
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        cv2.imwrite(str(d / f"frame_{i:03d}.png"),
                    rng.randint(0, 256, (40, 60, 3)).astype(np.uint8))
    return str(d)


@pytest.fixture
def camera_dir(tmp_path):
    """Two cameras with distortion, written by the port's camera module."""
    d = tmp_path / "cams"
    d.mkdir()
    for i, serial in enumerate(("cam0", "cam1")):
        intr = np.array([[50.0 + i, 0, 15.0], [0, 52.0, 20.0], [0, 0, 1]])
        ext = np.hstack([np.eye(3), [[0.1 * i], [0.0], [2.0]]])
        dist = np.array([0.1, -0.05, 0.001, 0.002, 0.01, 0, 0, 0])
        camera.write_camera_xml(str(d / f"{serial}.xml"),
                                camera.CameraParameters(serial, ext, intr,
                                                        dist))
    return str(d)


def _assert_same_frames(got, want):
    assert len(got) == len(want) > 0
    for views_g, views_w in zip(got, want):
        assert len(views_g) == len(views_w)
        for g, w in zip(views_g, views_w):
            assert (g.frame_id, g.sub_id, g.sub_id_max, g.name) \
                == (w.frame_id, w.sub_id, w.sub_id_max, w.name)
            np.testing.assert_array_equal(g.image, w.image)
            assert (g.camera is None) == (w.camera is None)
            if w.camera is not None:
                np.testing.assert_array_equal(g.camera.full_matrix,
                                              w.camera.full_matrix)


@pytest.mark.parametrize("config", [
    dict(),
    dict(frame_first=1, frame_step=2, frame_last=4),
    dict(frame_flip=True),
    dict(frame_rotate=90), dict(frame_rotate=180), dict(frame_rotate=270),
    dict(num_views=2),
    dict(num_views=2, undistort=True, frame_flip=True),
    dict(frames_repeat=True),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()) or "plain")
def test_producers_give_equal_frames(image_dir, camera_dir, config):
    if config.get("undistort"):
        config = dict(config, camera_parameter_path=camera_dir)
    mine = producers.create_producer(
        image_dir=image_dir, config=producers.ProducerConfig(**config))
    theirs = jproducers.create_producer(
        image_dir=image_dir, config=jproducers.ProducerConfig(**config))
    assert isinstance(mine, producers.ImageDirectoryReader)
    n = 14 if config.get("frames_repeat") else 100
    got = [v for _, v in zip(range(n), mine.frames())]
    want = [v for _, v in zip(range(n), theirs.frames())]
    _assert_same_frames(got, want)
    if config.get("undistort"):      # the cameras did move the pixels
        plain = producers.create_producer(
            image_dir=image_dir, config=producers.ProducerConfig(
                num_views=2, frame_flip=True))
        assert not np.array_equal(got[0][0].image,
                                  next(plain.frames())[0].image)


def test_producer_seek_and_errors(image_dir):
    """The GUI's seek on a seekable source, and the factory's refusals."""
    frames = {}
    for name, mod in (("mine", producers), ("theirs", jproducers)):
        p = mod.create_producer(image_dir=image_dir)
        it = p.frames()
        seen = [next(it)[0].name]
        assert p.request_seek(3)
        seen.append(next(it)[0].name)
        assert p.request_seek(-10)
        seen.append(next(it)[0].name)
        frames[name] = seen
        with pytest.raises(ValueError):
            mod.create_producer()
        with pytest.raises(NotImplementedError):
            mod.create_producer(flir_camera=True)
    assert frames["mine"] == frames["theirs"] \
        == ["frame_000", "frame_004", "frame_000"]


def test_video_reader_equal_frames(tmp_path):
    path = str(tmp_path / "clip.avi")
    writer = savers.VideoSaver(path, fps=10)
    rng = np.random.RandomState(1)
    for _ in range(5):
        writer.write(rng.randint(0, 256, (32, 48, 3)).astype(np.uint8))
    writer.close()
    config = dict(frame_first=1, frame_step=2)
    got = list(producers.VideoReader(
        path, producers.ProducerConfig(**config)).frames())
    want = list(jproducers.VideoReader(
        path, jproducers.ProducerConfig(**config)).frames())
    _assert_same_frames(got, want)
    assert [v[0].name for v in got] == ["clip_000000000001",
                                        "clip_000000000003"]


def _save_both(tmp_path, make, call):
    """Run `call(saver)` on the port's saver and the original, each writing
    into its own directory; the two paths written."""
    paths = []
    for side, mod in (("mine", savers), ("theirs", jsavers)):
        d = tmp_path / side
        paths.append(call(make(mod, str(d))))
    return paths


@pytest.mark.parametrize("file_format", ["json", "yml", "xml"])
def test_keypoint_saver_writes_equal_files(tmp_path, file_format):
    rng = np.random.RandomState(2)
    # an empty [0, 25, 3] array goes to JSON only: both FileStorage writers
    # raise on it (`arr.reshape(0, -1)`)
    arrays = [rng.rand(3, 25, 3).astype(np.float32),
              rng.rand(1 if file_format != "json" else 0, 25, 3)
              .astype(np.float32)]
    mine, theirs = _save_both(
        tmp_path, lambda mod, d: mod.KeypointSaver(d, file_format),
        lambda s: s.save(arrays, "frame_007", "pose"))
    assert mine.endswith(f"frame_007_pose.{file_format}")
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    if file_format == "json":
        data = json.loads(open(mine).read())
        assert data["pose_0"]["sizes"] == [3, 25, 3]
    with pytest.raises(ValueError):
        savers.KeypointSaver(str(tmp_path / "bad"), "csv")


@pytest.mark.parametrize("image_format", ["float", "png"])
def test_heatmap_saver_writes_equal_files(tmp_path, image_format):
    rng = np.random.RandomState(3)
    maps = rng.uniform(-1, 1, (8, 12, 5)).astype(np.float32)
    mine, theirs = _save_both(
        tmp_path, lambda mod, d: mod.HeatMapSaver(d, image_format),
        lambda s: s.save(maps, "frame_001"))
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    if image_format == "float":
        np.testing.assert_array_equal(savers.load_float_heatmaps(mine), maps)
        np.testing.assert_array_equal(jsavers.load_float_heatmaps(mine),
                                      maps)


def test_image_and_video_savers_write_equal_files(tmp_path):
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (32, 48, 3)).astype(np.uint8)
              for _ in range(3)]
    mine, theirs = _save_both(
        tmp_path, lambda mod, d: mod.ImageSaver(d, "png"),
        lambda s: s.save(frames[0], "frame_002"))
    assert mine.endswith("frame_002_rendered.png")
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    written = []
    for side, mod in (("mine", savers), ("theirs", jsavers)):
        path = str(tmp_path / f"{side}.avi")
        saver = mod.VideoSaver(path, fps=12)
        for frame in frames:
            saver.write(frame)
        saver.close()
        written.append(open(path, "rb").read())
    assert written[0] == written[1]


def test_udp_sender_sends_the_same_datagram():
    import socket
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(10)
    port = rx.getsockname()[1]
    payload = {"version": 1.3, "people": [{"pose_keypoints_2d": [1.5, 2.0]}]}
    got = []
    try:
        for mod in (savers, jsavers):
            sender = mod.UdpSender("127.0.0.1", port)
            sender.send(payload)
            sender.close()
            got.append(rx.recv(65536))
    finally:
        rx.close()
    assert got[0] == got[1] == json.dumps(payload).encode()


def _motion(num_frames=4, seed=0):
    """BODY_25 3-D keypoints of one rigidly moving skeleton, one joint
    unobserved in a frame."""
    rng = np.random.RandomState(seed)
    rest = np.zeros((26, 3))
    for child, parent in bvh._BODY_25_TREE.items():
        rest[child] = rest[parent] + rng.uniform(-1, 1, 3)
    frames = []
    for t in range(num_frames):
        rot = bvh.rotation_zxy_deg(10.0 * t, 5.0 * t, -7.0 * t)
        pts = rest @ rot.T + np.array([0.1 * t, 0.2 * t, -0.05 * t])
        kp = np.concatenate([pts, np.ones((26, 1))], axis=1)[:25]
        if t == 2:
            kp[4, 3] = 0.0
        frames.append(kp[None].astype(np.float32))
    return frames


@pytest.mark.parametrize("model", ["BODY_25", "COCO_18"])
def test_bvh_writes_equal_files(tmp_path, model):
    frames = _motion()
    if model == "COCO_18":
        frames = [f[:, :18] for f in frames]
    mine, theirs = tmp_path / "mine.bvh", tmp_path / "theirs.bvh"
    bvh.save_bvh(str(mine), frames, PoseModel[model], fps=24.0)
    jbvh.save_bvh(str(theirs), frames, JaxPoseModel[model], fps=24.0)
    assert mine.read_bytes() == theirs.read_bytes()
    assert mine.read_text().startswith("HIERARCHY")


def _heat():
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    rng = np.random.RandomState(5)
    hm = rng.uniform(-0.2, 0.2, (12, 16, info.heatmap_channels))
    hm[4:8, 6:10, 0] = 0.8
    hm[..., info.paf_channel_offset + info.map_idx[0]] = 0.5
    return hm.astype(np.float32)


@pytest.mark.parametrize("part", [0, 3, -1])
def test_heatmap_overlay_pixel_equal(part):
    frame = np.random.RandomState(6).randint(0, 256, (48, 64, 3)) \
        .astype(np.uint8)
    got = heatmaps.overlay_heatmap(frame, _heat(), part=part, alpha=0.7)
    want = jheatmaps.overlay_heatmap(frame, _heat(), part=part, alpha=0.7)
    assert got.dtype == np.uint8 and got.shape == frame.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pair", [0, 5, -1])
def test_paf_overlay_pixel_equal(pair):
    frame = np.zeros((48, 64, 3), np.uint8)
    got = heatmaps.overlay_paf(frame, _heat(), PoseModel.BODY_25,
                               pair_index=pair)
    want = jheatmaps.overlay_paf(frame, _heat(), JaxPoseModel.BODY_25,
                                 pair_index=pair)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_info_overlay_pixel_equal():
    got, want = (np.zeros((80, 200, 3), np.uint8) for _ in range(2))
    heatmaps.add_info_overlay(got, fps=12.3, frame_id=7, n_people=2,
                              extra="3-D")
    jheatmaps.add_info_overlay(want, fps=12.3, frame_id=7, n_people=2,
                               extra="3-D")
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keys", [
    "q", " m l l k", "lk", ".,..", "1245", "567890", "zxz-==", "bhf",
    "\x1b"], ids=repr)
def test_gui_handle_key_gives_equal_state(keys):
    mine, theirs = gui.GuiState(), jgui.GuiState()
    for key in [-1] + [ord(c) for c in keys]:
        mine = gui.handle_key(mine, key)
        theirs = jgui.handle_key(theirs, key)
        assert vars(mine) == vars(theirs), (keys, key)


def test_render_skeleton_3d_same_image_size():
    frames = _motion(1)
    got = gui3d.render_skeleton_3d(frames[0], PoseModel.BODY_25)
    from openpose_tpu.render import gui3d as jgui3d
    want = jgui3d.render_skeleton_3d(frames[0], JaxPoseModel.BODY_25)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    viewer = gui3d.Gui3D(PoseModel.BODY_25, live=False)
    viewer.update(frames[0])
    assert viewer.frame().shape == got.shape
    viewer.close()


def test_camera_directory_reads_equal(camera_dir):
    mine = camera.read_camera_directory(camera_dir)
    theirs = jcamera.read_camera_directory(camera_dir)
    assert [c.serial for c in mine] == [c.serial for c in theirs]
    for g, w in zip(mine, theirs):
        np.testing.assert_array_equal(g.full_matrix, w.full_matrix)
        np.testing.assert_array_equal(g.distortion, w.distortion)
