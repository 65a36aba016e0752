"""The port's 3-D accuracy harness against the JAX package's (CPU).

The rig, the people and the projection are numpy in both packages and must
be bit-equal; `triangulation_eval` and `bundle_eval` draw in the same order
from one seed, so both packages reconstruct the same inputs.  Tolerances:
`valid_fraction` exact; the triangulation figures within rtol 1e-4 (at
zero noise both are float32 rounding, ~1e-4 mm on a 3 m rig, and are held
within 1e-3 mm and 1e-3 px instead); `bundle_eval` within rtol 1e-2 (the
camera rotation error is an arccos near 1 of a float32 trace), and both
under the JAX suite's gates.
"""

import numpy as np
import pytest
import torch

from openpose_tpu import accuracy3d as jaccuracy3d
from openpose_tpu_torch import accuracy3d


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n_cams,image_wh,focal", [
    (4, (1280, 720), 1000.0), (3, (640, 480), 600.0),
    (7, (1920, 1080), 1400.0)])
def test_rig_equal(n_cams, image_wh, focal):
    got = accuracy3d.make_rig(n_cams, image_wh=image_wh, focal_px=focal)
    want = jaccuracy3d.make_rig(n_cams, image_wh=image_wh, focal_px=focal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,n_people", [(0, 2), (1, 6), (7, 8)])
def test_people_and_projection_equal(seed, n_people):
    got = accuracy3d.make_people_3d(np.random.RandomState(seed), n_people)
    want = jaccuracy3d.make_people_3d(np.random.RandomState(seed), n_people)
    np.testing.assert_array_equal(got, want)
    kk, ext = accuracy3d.make_rig(4)
    obs = accuracy3d.project(got, kk, ext)
    np.testing.assert_array_equal(obs, jaccuracy3d.project(want, kk, ext))
    assert obs.shape == (n_people, 25, 4, 2)
    if (seed, n_people) == (0, 2):
        # the JAX suite's case: everybody in every view
        assert (obs[..., 0] > 0).all() and (obs[..., 0] < 1280).all()
        assert (obs[..., 1] > 0).all() and (obs[..., 1] < 720).all()


@pytest.mark.parametrize("kwargs", [
    dict(n_people=4, pixel_noise=0.0), dict(n_people=4, pixel_noise=1.0),
    dict(n_people=4, pixel_noise=4.0), dict(n_people=8, pixel_noise=2.0,
                                            seed=3),
    dict(n_people=3, n_cams=3, pixel_noise=1.0, image_wh=(640, 480))],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_triangulation_eval_equal(kwargs):
    got = accuracy3d.triangulation_eval(device="cpu", **kwargs)
    want = jaccuracy3d.triangulation_eval(**kwargs)
    assert got.keys() == want.keys()
    assert got["valid_fraction"] == want["valid_fraction"]
    assert got["reference_gate_px"] == want["reference_gate_px"]
    for key in ("rmse_mm", "reprojection_px"):
        if kwargs["pixel_noise"] == 0.0:
            assert abs(got[key] - want[key]) < 1e-3, (key, got, want)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4)


def test_triangulation_gates():
    """The JAX suite's gates, on the port: exact at zero noise, a few mm at
    1 px, under the reference reprojection gate, growing with noise."""
    r0 = accuracy3d.triangulation_eval(n_people=4, pixel_noise=0.0,
                                       device="cpu")
    assert r0["rmse_mm"] < 0.5 and r0["valid_fraction"] == 1.0, r0
    r1 = accuracy3d.triangulation_eval(n_people=4, pixel_noise=1.0,
                                       device="cpu")
    r4 = accuracy3d.triangulation_eval(n_people=4, pixel_noise=4.0,
                                       device="cpu")
    assert r1["rmse_mm"] < 10.0, r1
    assert r1["reprojection_px"] < r1["reference_gate_px"]
    assert r4["rmse_mm"] > r1["rmse_mm"]


def test_noise_sweep_equal():
    levels = (0.5, 2.0)
    got = accuracy3d.noise_sweep(levels, n_people=3, device="cpu")
    want = jaccuracy3d.noise_sweep(levels, n_people=3)
    assert [r["pixel_noise"] for r in got] == list(levels)
    for g, w in zip(got, want):
        assert g["valid_fraction"] == w["valid_fraction"]
        np.testing.assert_allclose(g["rmse_mm"], w["rmse_mm"], rtol=1e-4)


def test_bundle_eval_equal_and_recovers():
    got = accuracy3d.bundle_eval(n_people=6, pixel_noise=1.0, seed=1,
                                 device="cpu")
    want = jaccuracy3d.bundle_eval(n_people=6, pixel_noise=1.0, seed=1)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-2,
                                   err_msg=key)
    for r in (got, want):
        assert r["cam_rot_err_deg_out"] < 0.2 * r["cam_rot_err_deg_in"], r
        assert r["rmse_mm_after_ba"] < 0.7 * r["rmse_mm_before_ba"], r
