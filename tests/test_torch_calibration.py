"""The port's calibration toolbox against the JAX package's (CPU, OpenCV).

`threed/calibration.py`, `threed/visualsfm.py` and `calibration_cli.py` are
the originals' code with OpenCV imported where it is used
(`tests/test_torch_standalone.py` holds them as copies).  Here both CLIs run
modes 1, 2 and 4 on the synthetic chessboard views of
`tests/test_calibration_cli.py` and must write byte-equal camera XML,
`.sift` and `FeatureMatches.txt` files; the toolbox's functions get the
same inputs in both packages and must give equal answers.  Without OpenCV
the package still imports and `--help` runs, and the three modes stop with
an ImportError that names OpenCV.
"""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from openpose_tpu import calibration_cli as jcli
from openpose_tpu.threed import calibration as jcalibration
from openpose_tpu.threed import visualsfm as jvisualsfm
from openpose_tpu_torch import calibration_cli as cli
from openpose_tpu_torch.threed import calibration, camera, visualsfm
from tests.test_calibration_cli import (GRID, K_TRUE, SQUARE_MM, VIEWS,
                                        _board_image, _render_view)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_opencv_thread():
    """`cv2.calibrateCamera` sums over threads, so its last bits differ
    from call to call, even between two calls of one package: one thread
    makes it repeat itself, and the two packages' files comparable."""
    before = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(before)


@pytest.fixture(scope="module")
def board():
    return _board_image()


def _common_flags():
    return ["--grid_number_inner_corners", "9x6",
            "--grid_square_size_mm", str(SQUARE_MM)]


def _pair_views(board, r_yaw, t_x, views=VIEWS):
    """(cam0 image, cam1 image) per view: cam1 is cam0 moved by t_x along
    x with a yaw of r_yaw."""
    r_rel, _ = cv2.Rodrigues(np.float32([0, r_yaw, 0]))
    t_rel = np.float32([t_x, 0.0, 0.0])
    pairs = []
    for rv, tv in views:
        r0, _ = cv2.Rodrigues(rv)
        rv1, _ = cv2.Rodrigues(r_rel @ r0)
        t1 = r_rel @ tv.reshape(3) + t_rel
        pairs.append((_render_view(board, K_TRUE, rv, tv),
                      _render_view(board, K_TRUE, rv1.reshape(-1),
                                   np.float32(t1))))
    return pairs


def _run_both(tmp_path, argv_of):
    """Both CLIs, each on its own folder: argv_of(folder) -> argv."""
    for side, main in (("mine", cli.main), ("theirs", jcli.main)):
        assert main(argv_of(tmp_path / side)) == 0
    return tmp_path / "mine", tmp_path / "theirs"


def test_mode1_writes_the_same_xml(tmp_path, board, capsys):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, (rv, tv) in enumerate(VIEWS):
        cv2.imwrite(str(img_dir / f"view_{i}.png"),
                    _render_view(board, K_TRUE, rv, tv))
    mine, theirs = _run_both(tmp_path, lambda d: [
        "--mode", "1", "--calibration_image_dir", str(img_dir),
        "--camera_serial_number", "camtest",
        "--camera_parameter_folder", str(d)] + _common_flags())
    got = (mine / "camtest.xml").read_bytes()
    assert got == (theirs / "camtest.xml").read_bytes()
    params = camera.read_camera_xml(str(mine / "camtest.xml"))
    assert np.allclose(np.diag(params.intrinsics)[:2], np.diag(K_TRUE)[:2],
                       rtol=0.05)
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(mine), "") == out[1].replace(str(theirs), "")


def test_mode1_omit_distortion_writes_the_same_xml(tmp_path, board):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, (rv, tv) in enumerate(VIEWS[:4]):
        cv2.imwrite(str(img_dir / f"view_{i}.jpg"),
                    _render_view(board, K_TRUE, rv, tv))
    mine, theirs = _run_both(tmp_path, lambda d: [
        "--mode", "1", "--calibration_image_dir", str(img_dir),
        "--camera_serial_number", "cam9", "--omit_distortion",
        "--camera_parameter_folder", str(d)] + _common_flags())
    got = (mine / "cam9.xml").read_bytes()
    assert got == (theirs / "cam9.xml").read_bytes()
    assert not camera.read_camera_xml(str(mine / "cam9.xml")).distortion.any()


def test_mode2_writes_the_same_xml(tmp_path, board):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, (im0, im1) in enumerate(_pair_views(board, 0.08, -0.2)):
        cv2.imwrite(str(img_dir / f"pair{i}_cam0.png"), im0)
        cv2.imwrite(str(img_dir / f"pair{i}_cam1.png"), im1)
    ident = np.hstack([np.eye(3), np.zeros((3, 1))])
    for side in ("mine", "theirs"):
        (tmp_path / side).mkdir()
        for serial in ("cam0", "cam1"):
            camera.write_camera_xml(
                str(tmp_path / side / f"{serial}.xml"),
                camera.CameraParameters(serial, ident.copy(), K_TRUE.copy(),
                                        np.zeros(8)))
    mine, theirs = _run_both(tmp_path, lambda d: [
        "--mode", "2", "--calibration_image_dir", str(img_dir),
        "--camera_parameter_folder", str(d), "--cam0", "cam0",
        "--cam1", "cam1"] + _common_flags())
    got = (mine / "cam1.xml").read_bytes()
    assert got == (theirs / "cam1.xml").read_bytes()
    rel = camera.read_camera_xml(str(mine / "cam1.xml")).camera_matrix
    assert np.allclose(rel[:3, 3], [-0.2, 0.0, 0.0], atol=0.02)


def test_mode4_writes_the_same_sift_and_match_files(tmp_path, board):
    """Two cameras x three views, the board hidden in one view of camera
    1, so that camera's `.sift` holds (-1, -1) placeholders and the match
    file leaves those corners out."""
    pairs = _pair_views(board, 0.06, -0.15, VIEWS[:3])
    blank = np.full_like(pairs[0][1], 255)
    for side in ("mine", "theirs"):
        d = tmp_path / side
        d.mkdir()
        for i, (im0, im1) in enumerate(pairs):
            cv2.imwrite(str(d / f"v{i}_a.png"), im0)
            cv2.imwrite(str(d / f"v{i}_b.png"), blank if i == 1 else im1)
    mine, theirs = _run_both(tmp_path, lambda d: [
        "--mode", "4", "--calibration_image_dir", str(d),
        "--number_cameras", "2"] + _common_flags())
    names = ["00_00.sift", "00_01.sift", "FeatureMatches.txt"]
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()
    n_corners = GRID[0] * GRID[1]
    cam1 = visualsfm.read_visualsfm_sift(str(mine / "00_01.sift"))
    assert cam1.shape == (3 * n_corners, 2)
    assert (cam1[n_corners:2 * n_corners] == -1.0).all()
    first = (mine / "FeatureMatches.txt").read_text().splitlines()[0]
    assert first == f"00_00.jpg 00_01.jpg {2 * n_corners}"


def test_cli_flags_equal():
    got, want = cli.build_parser(), jcli.build_parser()
    assert got.prog == "openpose_tpu_torch.calibration_cli"
    assert vars(got.parse_args([])) == vars(want.parse_args([]))
    assert [a.option_strings for a in got._actions] \
        == [a.option_strings for a in want._actions]


@pytest.mark.parametrize("argv,message", [
    (["--mode", "3"], "unsupported --mode 3 (1, 2 or 4)"),
    (["--mode", "2"], "mode 2 needs --cam0 and --cam1 serials")])
def test_cli_refuses_like_the_original(tmp_path, argv, message):
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--camera_parameter_folder", str(tmp_path)])
        assert str(e.value) == message


@pytest.mark.parametrize("seed", [0, 1])
def test_mean_rigid_equal(seed):
    rng = np.random.RandomState(seed)
    transforms = []
    for _ in range(4):
        r, _ = cv2.Rodrigues(rng.normal(0, 0.1, 3))
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = rng.normal(0, 1, 3)
        transforms.append(m)
    np.testing.assert_array_equal(cli._mean_rigid(transforms),
                                  jcli._mean_rigid(transforms))


def test_calibration_functions_equal(board):
    images = [_render_view(board, K_TRUE, rv, tv) for rv, tv in VIEWS]
    np.testing.assert_array_equal(calibration.find_chessboard(images[0], GRID),
                                  jcalibration.find_chessboard(images[0],
                                                               GRID))
    assert calibration.find_chessboard(np.full_like(images[0], 255),
                                       GRID) is None
    (got, rms), (want, jrms) = (
        mod.estimate_intrinsics(images, GRID, SQUARE_MM, serial="c")
        for mod in (calibration, jcalibration))
    assert rms == jrms
    for field in ("camera_matrix", "intrinsics", "distortion"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    im0, im1 = _pair_views(board, 0.05, -0.1, VIEWS[:1])[0]
    np.testing.assert_array_equal(
        calibration.estimate_extrinsics(got, got, im0, im1, GRID, SQUARE_MM),
        jcalibration.estimate_extrinsics(want, want, im0, im1, GRID,
                                         SQUARE_MM))
    np.testing.assert_array_equal(calibration.undistort(images[1], got),
                                  jcalibration.undistort(images[1], want))
    with pytest.raises(ValueError, match="chessboard found in only"):
        calibration.estimate_intrinsics(images[:2], GRID, SQUARE_MM)


@pytest.mark.parametrize("n", [0, 3, 200])
def test_sift_files_equal(tmp_path, n):
    pts = np.random.RandomState(n).uniform(-1, 1280, (n, 2)).astype(
        np.float32)
    paths = [str(tmp_path / f"{side}.sift") for side in ("mine", "theirs")]
    visualsfm.write_visualsfm_sift(paths[0], pts)
    jvisualsfm.write_visualsfm_sift(paths[1], pts)
    assert pathlib.Path(paths[0]).read_bytes() \
        == pathlib.Path(paths[1]).read_bytes()
    np.testing.assert_array_equal(visualsfm.read_visualsfm_sift(paths[1]),
                                  pts)
    pathlib.Path(paths[0]).write_bytes(b"\0" * 24)
    with pytest.raises(ValueError, match="not a SiftGPU V4.0 file"):
        visualsfm.read_visualsfm_sift(paths[0])


def test_feature_matches_and_stems_equal(tmp_path):
    matches = [[0, 1, 2, 3, 7], [2, 3, 4, 7], [0, 2, 9], []]
    visualsfm.write_feature_matches(str(tmp_path / "mine.txt"), matches)
    jvisualsfm.write_feature_matches(str(tmp_path / "theirs.txt"), matches)
    assert (tmp_path / "mine.txt").read_bytes() \
        == (tmp_path / "theirs.txt").read_bytes()
    for i in (0, 9, 10, 99):
        assert visualsfm.camera_file_stem(i) == jvisualsfm.camera_file_stem(i)
    with pytest.raises(ValueError):
        visualsfm.camera_file_stem(100)


BLOCK_CV2 = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "jax", "openpose_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
"""


def _without_opencv(body, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_CV2 + textwrap.dedent(body)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_help_runs_without_opencv(tmp_path):
    out = _without_opencv("""
        import runpy
        sys.argv = ["calibration_cli", "--help"]
        try:
            runpy.run_module("openpose_tpu_torch.calibration_cli",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert "cv2" not in sys.modules
    """, tmp_path)
    assert "--calibration_image_dir" in out and "--number_cameras" in out


def test_modes_stop_naming_opencv_without_it(tmp_path, board):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    cv2.imwrite(str(img_dir / "view_0_cam0.png"),
                _render_view(board, K_TRUE, *VIEWS[0]))
    ident = np.hstack([np.eye(3), np.zeros((3, 1))])
    for serial in ("cam0", "cam1"):
        camera.write_camera_xml(str(tmp_path / f"{serial}.xml"),
                                camera.CameraParameters(
                                    serial, ident, K_TRUE, np.zeros(8)))
    out = _without_opencv(f"""
        from openpose_tpu_torch import calibration_cli
        from openpose_tpu_torch.threed import calibration
        common = ["--calibration_image_dir", {str(img_dir)!r},
                  "--camera_parameter_folder", {str(tmp_path)!r}]
        for extra in (["--mode", "1"], ["--mode", "2", "--cam0", "cam0",
                                        "--cam1", "cam1"],
                      ["--mode", "4", "--number_cameras", "1"]):
            try:
                calibration_cli.main(extra + common)
            except ImportError as e:
                assert "OpenCV" in str(e), e
                print("stopped", extra[1])
            else:
                raise AssertionError(extra)
        try:
            calibration.find_chessboard(None, (9, 6))
        except ImportError as e:
            print(e)
        assert "cv2" not in sys.modules
    """, tmp_path)
    assert out.splitlines()[:3] == ["stopped 1", "stopped 2", "stopped 4"]
    assert out.splitlines()[3] == ("camera calibration needs OpenCV (the cv2 "
                                   "module), which is not installed")
