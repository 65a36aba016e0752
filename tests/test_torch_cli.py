"""The port's command line against the JAX package's (CPU, float32).

Both CLIs read the same weights: the JAX net's random parameters written as
a caffemodel under a model folder (`--model_folder`), and the same three
synthetic frames from an image directory, at `-1x64` with `--fp32`; the
port's `main` gets `device="cpu"`.  Tolerances are the wrapper tests':
keypoints within 1e-2 px, scores within 1e-3, heatmaps within 1e-3, the
same people in the same order.
"""

import argparse
import json
import pathlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from openpose_tpu import cli as jcli
from openpose_tpu.io import savers as jsavers
from openpose_tpu.models import zoo as jzoo
from openpose_tpu_torch import cli, synthetic
from openpose_tpu_torch.io import native_loader, producers
from openpose_tpu_torch.models import caffe_proto, zoo
from openpose_tpu_torch.params import PoseModel
from openpose_tpu_torch.threed import camera

HW = (120, 200)
NET = "-1x64"


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def write_model_folder(root: pathlib.Path) -> str:
    """The JAX BODY_25 net's seeded random parameters as a caffemodel at
    the reference's place under a model folder; the folder's path."""
    model = jzoo.load_pose_model()
    layers = {}
    for name, p in model.params.items():
        if "w" in p:      # HWIO -> the caffemodel's OIHW
            layers[name] = [np.asarray(p["w"]).transpose(3, 2, 0, 1),
                            np.asarray(p["b"])]
        else:
            layers[name] = [np.asarray(p["slope"])]
    path = root / zoo.CAFFEMODEL_PATHS[PoseModel.BODY_25]
    path.parent.mkdir(parents=True)
    path.write_bytes(caffe_proto.serialize_caffemodel(layers))
    return str(root)


def write_frames(directory: pathlib.Path, count=3, seed=0):
    """`count` scenes of two drawn people as PNG files; their arrays."""
    directory.mkdir()
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(count):
        people = synthetic.random_people(rng, 2, HW, height_range=(60, 100))
        frame = synthetic.render_scene_image(people, HW, rng)
        cv2.imwrite(str(directory / f"scene_{i:03d}.png"), frame)
        frames.append(frame)
    return frames


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return {"models": write_model_folder(root / "models"),
            "images": str(root / "images"),
            "frames": write_frames(root / "images")}


def run_both(tmp_path, inputs, flags, outputs):
    """Both CLIs on the same inputs; outputs: flag -> name of the output
    directory or file, one per side.  Returns {side: {flag: path}}."""
    paths = {}
    for side, main in (("mine", lambda a: cli.main(a, device="cpu")),
                       ("theirs", jcli.main)):
        out = {flag: tmp_path / side / name for flag, name in outputs.items()}
        (tmp_path / side).mkdir()
        argv = ["--image_dir", inputs["images"], "--model_folder",
                inputs["models"], f"--net_resolution={NET}", "--fp32",
                "--render_pose", "0", *flags]
        for flag, path in out.items():
            argv += [flag, str(path)]
        assert main(argv) == 0
        paths[side] = out
    return paths


def assert_keypoints_close(got, want, what):
    got = np.asarray(got, np.float64).reshape(-1, 3)
    want = np.asarray(want, np.float64).reshape(-1, 3)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-2,
                               err_msg=what)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-3,
                               err_msg=what)


def assert_people_json_close(got_dir, want_dir, expect_files=3):
    got = sorted(pathlib.Path(got_dir).glob("*_keypoints.json"))
    want = sorted(pathlib.Path(want_dir).glob("*_keypoints.json"))
    assert [p.name for p in got] == [p.name for p in want]
    assert len(got) == expect_files
    people = 0
    for g, w in zip(got, want):
        gd, wd = json.loads(g.read_text()), json.loads(w.read_text())
        assert gd["version"] == wd["version"] == 1.3
        assert len(gd["people"]) == len(wd["people"]), g.name
        people += len(gd["people"])
        for gp, wp in zip(gd["people"], wd["people"]):
            assert gp.keys() == wp.keys()
            assert gp["person_id"] == wp["person_id"]
            assert_keypoints_close(gp["pose_keypoints_2d"],
                                   wp["pose_keypoints_2d"], g.name)
            for key in gp:
                if key not in ("person_id", "pose_keypoints_2d"):
                    assert gp[key] == wp[key] == [], key
    assert people > 0
    return people


def test_parsers_have_equal_flags_and_defaults():
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.choices, a.nargs, type(a).__name__, a.const)
                for a in parser._actions}
    mine, theirs = table(cli.build_parser()), table(jcli.build_parser())
    assert mine == theirs
    assert len(mine) > 100
    assert vars(cli.build_parser().parse_args([])) \
        == vars(jcli.build_parser().parse_args([]))
    assert cli.parse_resolution("-1x368") == jcli.parse_resolution("-1x368")


def _args(**over):
    """The JAX suite's argument set for `fast_path_eligible`
    (`tests/test_cli_fast.py`)."""
    defaults = dict(image_dir="x", video="", batch=0, face=False,
                    hand=False, threed=False, tracking=-1,
                    identification=False, part_candidates=False,
                    num_views=1, frames_repeat=False,
                    process_real_time=False, fps_max=-1.0,
                    scale_number=1, frame_flip=False, frame_rotate=0,
                    frame_undistort=False, keypoint_scale=0, udp_host="",
                    body=1, write_images="", write_video="", display=0,
                    part_to_show=0, show_info=False, write_heatmaps="",
                    write_video_3d="", write_bvh="", frame_first=0,
                    face_detector=0, hand_detector=0,
                    hand_scale_number=1)
    defaults.update(over)
    return argparse.Namespace(**defaults)


@pytest.mark.parametrize("over", [
    dict(), dict(scale_number=4),
    dict(image_dir="", video="v.avi", face=True, hand=True),
    dict(batch=1), dict(image_dir="", video=""), dict(face=True),
    dict(hand=True), dict(threed=True), dict(tracking=0),
    dict(display=2), dict(write_images="out"), dict(part_to_show=-1),
    dict(num_views=2), dict(keypoint_scale=3),
    dict(image_dir="", video="v.avi", frame_first=3),
    dict(image_dir="", video="v.avi", face=True, face_detector=2),
    dict(image_dir="", video="v.avi", hand=True, hand_scale_number=2),
    dict(top_down_refinement=True), dict(write_bvh="x.bvh"),
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "plain")
def test_fast_path_eligible_agrees(over):
    args = _args(**over)
    assert cli.fast_path_eligible(args) == jcli.fast_path_eligible(args)


def test_num_gpu_above_one_raises_and_start_picks_a_device():
    """--num_gpu above the visible cards stops, naming the sizes (on the
    CPU, as `main(..., device="cpu")`, the ranks are gloo processes)."""
    argv = ["--image_dir", "nowhere", "--num_gpu", "2"]
    if torch.cuda.device_count() < 2:
        with pytest.raises(SystemExit, match=(
                "--num_gpu 2 --num_gpu_start 0: only "
                f"{torch.cuda.device_count()} CUDA devices available")):
            cli.main(argv)
    args = cli.build_parser().parse_args(["--num_gpu_start", "1"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(SystemExit, match="CUDA devices available"):
            cli._cli_device(args)
    assert cli._cli_device(args, "cpu") == torch.device("cpu")
    assert cli._cli_device(cli.build_parser().parse_args([])) is None


def test_cli_runs_on_the_card_unless_told(inputs, monkeypatch):
    from openpose_tpu_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.NoCudaDeviceError):
        cli.main(["--image_dir", inputs["images"], "--batch", "1",
                  f"--net_resolution={NET}"])


def test_plain_run_equals_jax(tmp_path, inputs):
    """The per-frame `Wrapper` path: people JSON, keypoint JSON and the COCO
    JSON of every frame."""
    paths = run_both(tmp_path, inputs, ["--batch", "1"], {
        "--write_json": "json", "--write_keypoint": "kp",
        "--write_coco_json": "coco.json"})
    mine, theirs = paths["mine"], paths["theirs"]
    people = assert_people_json_close(mine["--write_json"],
                                      theirs["--write_json"])
    for g, w in zip(sorted(mine["--write_keypoint"].iterdir()),
                    sorted(theirs["--write_keypoint"].iterdir())):
        assert g.name == w.name and g.name.endswith("_pose.json")
        gd, wd = json.loads(g.read_text()), json.loads(w.read_text())
        assert gd["pose_0"]["sizes"] == wd["pose_0"]["sizes"]
        assert_keypoints_close(gd["pose_0"]["data"], wd["pose_0"]["data"],
                               g.name)
    got = json.loads(mine["--write_coco_json"].read_text())
    want = json.loads(theirs["--write_coco_json"].read_text())
    assert len(got) == len(want) == people
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) \
            == (w["image_id"], w["category_id"])
        assert_keypoints_close(g["keypoints"], w["keypoints"], "coco")
        assert g["score"] == pytest.approx(w["score"], abs=1e-3)


def test_keypoint_yml_and_heatmaps_equal_jax(tmp_path, inputs):
    paths = run_both(tmp_path, inputs,
                     ["--batch", "1", "--write_keypoint_format", "yml",
                      "--heatmaps_add_parts", "--heatmaps_add_PAFs"],
                     {"--write_keypoint": "kp", "--write_heatmaps": "hm"})
    mine, theirs = paths["mine"], paths["theirs"]
    names = sorted(p.name for p in mine["--write_keypoint"].iterdir())
    assert names == sorted(p.name for p in theirs["--write_keypoint"]
                           .iterdir())
    assert len(names) == 3
    for name in names:
        arrays = []
        for side in (mine, theirs):
            fs = cv2.FileStorage(str(side["--write_keypoint"] / name),
                                 cv2.FILE_STORAGE_READ)
            arrays.append(fs.getNode("pose_0").mat())
            fs.release()
        assert_keypoints_close(arrays[0], arrays[1], name)
    maps = sorted(p.name for p in mine["--write_heatmaps"].iterdir())
    assert len(maps) == 3
    for name in maps:
        got = jsavers.load_float_heatmaps(str(mine["--write_heatmaps"] / name))
        want = jsavers.load_float_heatmaps(
            str(theirs["--write_heatmaps"] / name))
        assert got.shape == want.shape and got.shape[-1] == 25 + 52
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_smooth_keyframes_equal_jax(tmp_path, inputs):
    paths = run_both(tmp_path, inputs,
                     ["--batch", "1", "--smooth_keyframes", "3"],
                     {"--write_json": "json"})
    assert_people_json_close(paths["mine"]["--write_json"],
                             paths["theirs"]["--write_json"])


@pytest.mark.parametrize("flags", [[], ["--maximize_positives"]],
                         ids=["default", "maximize_positives"])
def test_batched_fast_path_equals_jax(tmp_path, inputs, flags):
    """--batch 2 over three files: the native pump, one batched device call
    per two frames (the tail padded), threaded assembly; with
    --maximize_positives the batched path assembles with the flag's limits
    and passes, as JAX's runner does through its extractor."""
    if not native_loader.available():
        pytest.skip("native frame pump not built")
    args = cli.build_parser().parse_args(
        ["--image_dir", inputs["images"], "--batch", "2", *flags])
    assert cli.fast_path_eligible(args)
    paths = run_both(tmp_path, inputs, ["--batch", "2", *flags],
                     {"--write_json": "json"})
    assert_people_json_close(paths["mine"]["--write_json"],
                             paths["theirs"]["--write_json"])


def test_num_gpu_two_equals_one_gpu_and_jax(tmp_path, inputs):
    """--num_gpu 2 on the batched path: two gloo ranks, each on its row of
    every batch of two, write the people JSON of their own frames, and
    rank 0 the one COCO file; the same as --num_gpu 1 and as the JAX CLI's
    --num_gpu 2 over two of its virtual devices."""
    if not native_loader.available():
        pytest.skip("native frame pump not built")
    people, records = hold_num_gpu_two(tmp_path, inputs, [])
    assert records == people


def test_num_gpu_two_smooth_keyframes_equals_one_gpu_and_jax(tmp_path,
                                                             inputs):
    """--num_gpu 2 --smooth_keyframes 3: the ranks hand their frames to
    rank 0, which smooths all three in frame order and writes every
    frame's people JSON and the COCO file: the same as --num_gpu 1 and as
    the JAX CLI's --num_gpu 2 (one process, results in frame order)."""
    if not native_loader.available():
        pytest.skip("native frame pump not built")
    people, records = hold_num_gpu_two(tmp_path, inputs,
                                       ["--smooth_keyframes", "3"])
    # the smoother took effect: it drops the parts of the random net's
    # spurious people that do not persist over the window, and some are
    # left with too few for a COCO record
    assert 0 < records < people


def hold_num_gpu_two(tmp_path, inputs, flags):
    """The port's --num_gpu 2 against the JAX CLI's and the port's
    --num_gpu 1 under the same `flags`: people JSON of every frame and the
    one COCO file, within the wrapper tests' tolerances.  Returns the
    number of people in the JSON and of records in the COCO file."""
    outputs = {"--write_json": "json", "--write_coco_json": "coco.json"}
    paths = run_both(tmp_path, inputs,
                     ["--batch", "2", "--num_gpu", "2", *flags], outputs)
    mine, theirs = paths["mine"], paths["theirs"]
    people = assert_people_json_close(mine["--write_json"],
                                      theirs["--write_json"])
    one = tmp_path / "one"
    assert cli.main(["--image_dir", inputs["images"], "--model_folder",
                     inputs["models"], f"--net_resolution={NET}", "--fp32",
                     "--batch", "2", "--num_gpu", "1", *flags,
                     "--write_json", str(one / "json"),
                     "--write_coco_json", str(one / "coco.json")],
                    device="cpu") == 0
    assert_people_json_close(mine["--write_json"], one / "json")
    assert sorted(p.name for p in (tmp_path / "mine").iterdir()) \
        == ["coco.json", "json"]
    got = json.loads(mine["--write_coco_json"].read_text())
    for want in (json.loads(theirs["--write_coco_json"].read_text()),
                 json.loads((one / "coco.json").read_text())):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g["image_id"], g["category_id"]) \
                == (w["image_id"], w["category_id"])
            assert_keypoints_close(g["keypoints"], w["keypoints"], "coco")
            assert g["score"] == pytest.approx(w["score"], abs=1e-3)
    return people, len(got)


def test_a_failing_rank_makes_main_return_non_zero(tmp_path, inputs, capfd):
    """The second of three files is no image: the rank that owns it (rank
    1 of 2 at --batch 2) fails, the other is stopped, and `main` returns
    1."""
    if not native_loader.available():
        pytest.skip("native frame pump not built")
    images = tmp_path / "images"
    images.mkdir()
    for i, frame in enumerate(inputs["frames"]):
        path = images / f"scene_{i:03d}.png"
        if i == 1:
            path.write_bytes(b"not an image")
        else:
            cv2.imwrite(str(path), frame)
    argv = ["--image_dir", str(images), "--model_folder", inputs["models"],
            f"--net_resolution={NET}", "--fp32", "--batch", "2",
            "--num_gpu", "2", "--write_json", str(tmp_path / "json")]
    assert cli.main(argv, device="cpu") == 1
    assert "decode failed" in capfd.readouterr().err


def test_cli_takes_frames_from_the_producer_it_finds_at_call_time(
        tmp_path, inputs, monkeypatch):
    """`main` looks `producers.create_producer` up when it runs: a producer
    of frames in memory stands in for the image directory and gives the
    same JSON."""
    frames = inputs["frames"]

    class MemoryProducer(producers.Producer):
        def _raw_frames(self):
            for i, frame in enumerate(frames):
                yield frame, f"scene_{i:03d}"

    monkeypatch.setattr(producers, "create_producer",
                        lambda **kwargs: MemoryProducer(kwargs["config"]))
    common = ["--model_folder", inputs["models"], f"--net_resolution={NET}",
              "--fp32", "--render_pose", "0", "--batch", "1"]
    assert cli.main(common + ["--write_json", str(tmp_path / "memory")],
                    device="cpu") == 0
    monkeypatch.undo()
    assert cli.main(common + ["--image_dir", inputs["images"],
                              "--net_resolution_dynamic", "-1",
                              "--write_json", str(tmp_path / "files")],
                    device="cpu") == 0
    for g, w in zip(sorted((tmp_path / "memory").iterdir()),
                    sorted((tmp_path / "files").iterdir())):
        assert g.name == w.name
        assert g.read_text() == w.read_text()


@pytest.fixture(scope="module")
def rig(inputs, tmp_path_factory):
    """Three views of each scene side by side, view v moved 8v px to the
    left, and three cameras 0.2 m apart along x (focal 100 px): a point
    seen in the same place of every view lies at 2.5 m."""
    root = tmp_path_factory.mktemp("rig")
    (root / "images").mkdir()
    (root / "cams").mkdir()
    views = []
    for i, frame in enumerate(inputs["frames"]):
        views.append([np.roll(frame, -8 * v, axis=1) for v in range(3)])
        cv2.imwrite(str(root / "images" / f"rig_{i:03d}.png"),
                    np.concatenate(views[-1], axis=1))
    intrinsics = np.array([[100.0, 0, HW[1] / 2], [0, 100.0, HW[0] / 2],
                           [0, 0, 1]])
    for v in range(3):
        camera.write_camera_xml(
            str(root / "cams" / f"cam{v}.xml"), camera.CameraParameters(
                f"cam{v}", np.hstack([np.eye(3), [[-0.2 * v], [0], [0]]]),
                intrinsics, np.zeros(8)))
    return {"images": str(root / "images"), "cams": str(root / "cams"),
            "views": views}


def _run_3d(main, inputs, rig, out, *flags):
    return main(["--image_dir", rig["images"], "--model_folder",
                 inputs["models"], f"--net_resolution={NET}", "--fp32",
                 "--render_pose", "0", "--3d", "--num_views", "3",
                 "--camera_parameter_path", rig["cams"], "--write_json",
                 str(out), *flags])


def test_3d_branch_equals_jax(tmp_path, inputs, rig):
    """--3d over three views with the people kept to 8 a view (so every
    view has as many): the 2-D people JSON as before, the 3-D rows the
    same people kept by the outlier gate, their points within 1e-2 m (the
    views' 1e-2 px moves a point at 2.5 m by up to 3e-3 m)."""
    for side, main in (("mine", lambda a: cli.main(a, device="cpu")),
                       ("theirs", jcli.main)):
        assert _run_3d(main, inputs, rig, tmp_path / side,
                       "--number_people_max", "8") == 0
    kept = 0
    for g, w in zip(sorted((tmp_path / "mine").iterdir()),
                    sorted((tmp_path / "theirs").iterdir())):
        gd, wd = json.loads(g.read_text()), json.loads(w.read_text())
        assert len(gd["people"]) == len(wd["people"]) == 8
        for gp, wp in zip(gd["people"], wd["people"]):
            assert_keypoints_close(gp["pose_keypoints_2d"],
                                   wp["pose_keypoints_2d"], g.name)
            got = np.asarray(gp["pose_keypoints_3d"]).reshape(25, 4)
            want = np.asarray(wp["pose_keypoints_3d"]).reshape(25, 4)
            np.testing.assert_array_equal(got[:, 3] > 0, want[:, 3] > 0)
            np.testing.assert_allclose(got, want, atol=1e-2)
            kept += int((got[:, 3] > 0).sum())
    assert kept > 0


def test_3d_branch_with_fewer_people_in_a_view(tmp_path, inputs, rig):
    """Views with different numbers of people: the 3-D rows are the least
    number over the views (the reference's rule), and the people of view 0
    past it get zero rows.  The JAX CLI stops with an IndexError on such a
    frame (its people JSON indexes past the 3-D array)."""
    from openpose_tpu_torch.wrapper import PoseConfig, Wrapper
    wrapper = Wrapper(PoseConfig(net_resolution=(-1, 64),
                                 model_folder=inputs["models"],
                                 compute_dtype="float32"), device="cpu")
    counts = [[len(wrapper.process(view).pose_keypoints) for view in views]
              for views in rig["views"]]
    assert any(c[0] > min(c) for c in counts), counts
    assert _run_3d(lambda a: cli.main(a, device="cpu"), inputs, rig,
                   tmp_path / "mine") == 0
    with pytest.raises(IndexError):
        _run_3d(jcli.main, inputs, rig, tmp_path / "theirs")
    for path, c in zip(sorted((tmp_path / "mine").iterdir()), counts):
        people = json.loads(path.read_text())["people"]
        assert len(people) == c[0]
        rows = np.asarray([p["pose_keypoints_3d"] for p in people])
        assert rows.shape == (c[0], 100)
        assert not rows[min(c):].any()
        assert np.isfinite(rows).all()


@pytest.mark.parametrize("flags", [
    ["--render_pose", "1", "--show_info", "--output_resolution", "160x96"],
    ["--part_to_show", "-2"], ["--part_to_show", "3"],
    ["--render_pose", "1", "--disable_blending"],
], ids=lambda f: " ".join(f))
def test_rendered_images_close_to_jax(tmp_path, inputs, flags):
    """--write_images through the renderers and overlays: the same frames,
    their pixels equal but where a line's end moved (keypoints agree to
    1e-2 px) or the FPS text differs."""
    paths = run_both(tmp_path, inputs, ["--batch", "1", *flags],
                     {"--write_images": "img"})
    got = sorted(paths["mine"]["--write_images"].iterdir())
    want = sorted(paths["theirs"]["--write_images"].iterdir())
    assert [p.name for p in got] == [p.name for p in want]
    assert len(got) == 3
    for g, w in zip(got, want):
        a, b = cv2.imread(str(g)), cv2.imread(str(w))
        assert a.shape == b.shape
        if "--output_resolution" in flags:
            assert a.shape == (96, 160, 3)
            a, b = a[25:-15], b[25:-15]       # the FPS and people lines
        assert (a != b).any(axis=-1).mean() < 2e-3, g.name


@pytest.mark.parametrize("flags", [
    ["--keypoint_scale", "3"], ["--keypoint_scale", "4"],
    ["--identification"], ["--tracking", "1"],
    ["--part_candidates", "--number_people_max", "2"],
], ids=lambda f: " ".join(f))
def test_per_frame_options_equal_jax(tmp_path, inputs, flags):
    paths = run_both(tmp_path, inputs, ["--batch", "1", *flags],
                     {"--write_json": "json"})
    assert_people_json_close(paths["mine"]["--write_json"],
                             paths["theirs"]["--write_json"])
    if "--part_candidates" in flags:
        for g, w in zip(sorted(paths["mine"]["--write_json"].iterdir()),
                        sorted(paths["theirs"]["--write_json"].iterdir())):
            gc = json.loads(g.read_text())["part_candidates"][0]
            wc = json.loads(w.read_text())["part_candidates"][0]
            assert gc.keys() == wc.keys()
            for part in gc:
                assert_keypoints_close(gc[part], wc[part], part)


def test_video_out_equals_jax_frame_count(tmp_path, inputs):
    paths = run_both(tmp_path, inputs,
                     ["--batch", "1", "--render_pose", "1",
                      "--write_video_fps", "5"],
                     {"--write_video": "out.avi"})
    counts = []
    for side in ("mine", "theirs"):
        cap = cv2.VideoCapture(str(paths[side]["--write_video"]))
        counts.append(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
        cap.release()
    assert counts[0] == counts[1] == 3
