"""The port's `threed/` against the JAX package's (CPU, float32).

`triangulate_points` and `reconstruct_array` get the same rigs and views on
both sides: the cases of `tests/test_threed.py` and a random rig of 8
people x 25 parts x 4 views.  Tolerances: the same `ok` flags, points
within 1e-3 (both sides refine to the same minimum; the eigen solver and
the sums run in another order), the mean score within 1e-6.
`threed/camera.py` is a copy (`test_torch_standalone.py`); its XML round
trip is held here on a file it writes itself.
"""

import numpy as np
import pytest
import torch

from openpose_tpu.threed import camera as jcamera
from openpose_tpu.threed import triangulation as jtriangulation
from openpose_tpu_torch.threed import camera, triangulation


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _make_rig(n_cams=4, radius=3.0):
    """Cameras on an arc looking at the origin; [V, 3, 4] K[R|t] (the JAX
    suite's rig)."""
    k = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    cams = []
    for i in range(n_cams):
        angle = (i - (n_cams - 1) / 2) * 0.35
        c = np.array([radius * np.sin(angle), 0.0, -radius * np.cos(angle)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        r = np.stack([x, y, z])
        t = -r @ c
        cams.append(k @ np.hstack([r, t[:, None]]))
    return np.stack(cams)


def _project(cams, pts3d):
    homog = np.concatenate([pts3d, np.ones((len(pts3d), 1))], axis=1)
    proj = np.einsum("vij,kj->kvi", cams, homog)
    return proj[..., :2] / proj[..., 2:3]


def _both(points2d, scores, cams, wh, **kwargs):
    args = (np.asarray(points2d, np.float32), np.asarray(scores, np.float32),
            np.asarray(cams, np.float32), np.asarray(wh, np.float32))
    want = [np.asarray(a) for a in
            jtriangulation.triangulate_points(*args, **kwargs)]
    got = [t.numpy() for t in
           triangulation.triangulate_points(*args, device="cpu", **kwargs)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0][..., :3], want[0][..., :3], atol=1e-3)
    np.testing.assert_allclose(got[0][..., 3], want[0][..., 3], atol=1e-6)
    return got


def _case(name):
    """The inputs of one `tests/test_threed.py` triangulation case."""
    rng = np.random.RandomState(0)
    if name == "exact":
        cams = _make_rig(4)
        pts3d = np.array([[0.1, 0.2, 0.3], [-0.2, 0.1, -0.1],
                          [0.0, -0.3, 0.2]])
        return (_project(cams, pts3d), np.full((3, 4), 0.9), cams,
                np.tile([640.0, 480.0], (4, 1)), pts3d)
    if name == "noisy_outlier_view":
        cams = _make_rig(5)
        pts3d = rng.uniform(-0.3, 0.3, (10, 3))
        pts2d = _project(cams, pts3d) + rng.normal(0, 0.5, (10, 5, 2))
        pts2d[:, 2] += 30.0
        return (pts2d, np.full((10, 5), 0.9), cams,
                np.tile([640.0, 480.0], (5, 1)), pts3d)
    if name == "two_valid_views":
        cams = _make_rig(4)
        pts3d = np.zeros((1, 3))
        return (_project(cams, pts3d), np.array([[0.9, 0.9, 0.1, 0.1]]),
                cams, np.tile([640.0, 480.0], (4, 1)), pts3d)
    assert name == "border"
    cams = _make_rig(3)
    return (np.full((1, 3, 2), 4.0), np.full((1, 3), 0.9), cams,
            np.tile([640.0, 480.0], (3, 1)), None)


@pytest.mark.parametrize("name,min_views,refine", [
    ("exact", 0, True), ("exact", 0, False),
    ("noisy_outlier_view", 0, True), ("noisy_outlier_view", 0, False),
    ("two_valid_views", 0, True), ("two_valid_views", 2, True),
    ("border", 2, True)])
def test_triangulate_points_equals_jax(name, min_views, refine):
    points2d, scores, cams, wh, truth = _case(name)
    xyzs, ok = _both(points2d, scores, cams, wh, min_views=min_views,
                     refine=refine)
    if name == "exact":
        assert ok.all()
        np.testing.assert_allclose(xyzs[:, :3], truth, atol=1e-3)
        np.testing.assert_allclose(xyzs[:, 3], 0.9, atol=1e-5)
    elif name == "noisy_outlier_view" and refine:
        err = np.linalg.norm(xyzs[:, :3] - truth, axis=1)
        assert np.median(err) < 0.02
    elif name == "two_valid_views":
        assert ok[0] == (min_views == 2)
    elif name == "border":
        assert not ok[0]


def _random_rig_views(seed, people=8, parts=25, views=4, noise=0.5):
    rng = np.random.RandomState(seed)
    cams = _make_rig(views)
    truth = rng.uniform(-0.5, 0.5, (people, parts, 3))
    out = []
    for v in range(views):
        pix = _project(cams[v:v + 1], truth.reshape(-1, 3))[:, 0]
        pix = pix.reshape(people, parts, 2) + rng.normal(0, noise,
                                                          (people, parts, 2))
        score = rng.uniform(0.2, 1.0, (people, parts, 1))
        out.append(np.concatenate([pix, score], -1).astype(np.float32))
    return out, cams.astype(np.float32), truth


@pytest.mark.parametrize("seed", [0, 1])
def test_reconstruct_array_equals_jax_on_a_random_rig(seed):
    """8 people x 25 parts x 4 views with 0.5 px noise and scores on both
    sides of the 0.35 validity line."""
    views, cams, truth = _random_rig_views(seed)
    sizes = [(640, 480)] * 4
    want = jtriangulation.reconstruct_array(views, cams, sizes)
    got = triangulation.reconstruct_array(views, cams, sizes, device="cpu")
    assert got.shape == want.shape == (8, 25, 4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 3] > 0, want[..., 3] > 0)
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-3)
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=1e-6)
    ok = got[..., 3] > 0
    assert 0 < ok.mean() < 1
    assert np.median(np.linalg.norm(got[..., :3][ok] - truth[ok],
                                    axis=-1)) < 0.02


def test_reconstruct_array_solves_every_person_in_one_call(monkeypatch):
    views, cams, _ = _random_rig_views(2)
    calls = []
    inner = triangulation.triangulate_points

    def counted(points2d, *args, **kwargs):
        calls.append(np.shape(points2d))
        return inner(points2d, *args, **kwargs)

    monkeypatch.setattr(triangulation, "triangulate_points", counted)
    triangulation.reconstruct_array(views, cams, [(640, 480)] * 4,
                                    device="cpu")
    assert calls == [(8, 25, 4, 2)]


def test_reconstruct_array_with_fewer_people_in_a_view_and_none():
    """The least number of people over the views, as the reference; no
    people at all gives an empty array."""
    views, cams, _ = _random_rig_views(3)
    views[1] = views[1][:5]
    sizes = [(640, 480)] * 4
    want = jtriangulation.reconstruct_array(views, cams, sizes, min_views=2)
    got = triangulation.reconstruct_array(views, cams, sizes, min_views=2,
                                          device="cpu")
    assert got.shape == want.shape == (5, 25, 4)
    np.testing.assert_array_equal(got[..., 3] > 0, want[..., 3] > 0)
    np.testing.assert_allclose(got, want, atol=1e-3)
    empty = [np.zeros((0, 25, 3), np.float32)] * 4
    assert triangulation.reconstruct_array(empty, cams, sizes,
                                           device="cpu").shape == (0, 0, 4)


def test_leading_batch_dims_equal_one_call_each():
    """[frames, people, parts, views] in one call gives what each frame's
    own call gives."""
    frames = [_random_rig_views(s) for s in (4, 5)]
    cams = frames[0][1]
    pts = np.stack([np.stack(v, 2)[..., :2] for v, _, _ in frames])
    scs = np.stack([np.stack(v, 2)[..., 2] for v, _, _ in frames])
    wh = np.tile([640.0, 480.0], (4, 1))
    xyzs, ok = triangulation.triangulate_points(pts, scs, cams, wh,
                                                device="cpu")
    assert xyzs.shape == (2, 8, 25, 4) and ok.shape == (2, 8, 25)
    for f in range(2):
        one, one_ok = triangulation.triangulate_points(pts[f], scs[f], cams,
                                                       wh, device="cpu")
        assert torch.equal(one_ok, ok[f])
        torch.testing.assert_close(one, xyzs[f], atol=1e-4, rtol=0)


def test_triangulation_runs_on_the_card_by_default(monkeypatch):
    from openpose_tpu_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    points2d, scores, cams, wh, _ = _case("exact")
    with pytest.raises(device.NoCudaDeviceError):
        triangulation.triangulate_points(points2d, scores, cams, wh)


def test_camera_xml_round_trip_of_its_own_file(tmp_path):
    """The port writes a camera file (the reference's FileStorage layout,
    8 distortion terms) and both packages read back the same matrices."""
    rng = np.random.RandomState(0)
    cams = _make_rig(2)
    intrinsics = np.array([[817.934816, 0.0, 633.1], [0.0, 818.2, 512.7],
                           [0.0, 0.0, 1.0]])
    extrinsics = np.linalg.inv(intrinsics) @ cams[1]
    params = camera.CameraParameters("17012332", extrinsics, intrinsics,
                                     rng.normal(0, 0.1, 8))
    path = tmp_path / "17012332.xml"
    camera.write_camera_xml(str(path), params)
    mine = camera.read_camera_xml(str(path))
    theirs = jcamera.read_camera_xml(str(path))
    assert mine.serial == theirs.serial == "17012332"
    assert mine.camera_matrix.shape == (3, 4)
    assert mine.intrinsics.shape == (3, 3)
    assert mine.distortion.shape == (8,)
    assert mine.intrinsics[0, 0] == pytest.approx(817.934816, abs=1e-4)
    for name in ("camera_matrix", "intrinsics", "distortion"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(params, name))
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name))
    np.testing.assert_allclose(mine.full_matrix, cams[1], atol=1e-9)
    other = tmp_path / "17012333.xml"
    jcamera.write_camera_xml(str(other), params)
    assert other.read_bytes() == path.read_bytes()
    listed = camera.read_camera_directory(str(tmp_path))
    assert [c.serial for c in listed] == ["17012332", "17012333"]
    assert [c.serial for c in jcamera.read_camera_directory(str(tmp_path))] \
        == ["17012332", "17012333"]
