"""The port's bundle adjustment against the JAX package's (CPU, float32).

The same inputs go through `openpose_tpu.threed.bundle_adjustment` and
`openpose_tpu_torch.threed.bundle_adjustment`.  Tolerances: the rotation,
camera matrix, Huber weights and residuals within rtol 1e-5 (the same
float32 operations; a residual's scale is the pixel coordinates it is the
difference of); the reduced system and the per-point blocks within rtol
1e-4 plus 1e-5 of the array's largest entry (sums over points and the two
Jacobians' products run in another order); refined points and extrinsics
within 1e-3, the JAX suite's sharded-vs-single limit.  The scene is
`tests/test_bundle.py`'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_tpu.threed import bundle_adjustment as jba
from openpose_tpu_torch.threed import bundle_adjustment as ba
from tests.test_bundle import _scene


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _f32(a):
    return np.asarray(a, np.float32)


def _both(fn_jax, fn_port, *arrays):
    """fn on the same float32 arrays in both packages, as numpy."""
    want = fn_jax(*(jnp.asarray(_f32(a)) for a in arrays))
    got = fn_port(*(torch.from_numpy(_f32(a)) for a in arrays))
    return got, want


def _close(got, want, rtol, share=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=share * np.abs(want).max())


TWISTS = {
    "zero": np.zeros(3),
    "at_1e-6": np.array([1e-6, 0.0, 0.0]),
    "below_1e-6": np.array([3e-7, -2e-7, 5e-7]),
    "above_1e-6": np.array([1.5e-6, 0.0, -1e-6]),
    "small": np.array([0.01, -0.02, 0.005]),
    "large": np.array([0.4, -0.9, 0.3]),
}


@pytest.mark.parametrize("name", list(TWISTS))
def test_rodrigues_and_its_jacobian_equal(name):
    """The rotation and its forward-mode Jacobian, at twist 0, around
    |w| = 1e-6 where the branch changes, and away from it.  At twist 0
    theta rounds to exactly float32(1e-6), so both packages take the
    sin/cos branch; its Jacobian there is the cross-product matrix, as the
    first-order fallback's would be to float32 rounding."""
    w = TWISTS[name]
    got, want = _both(jba._rodrigues, ba._rodrigues, w)
    _close(got, want, 1e-5, 1e-7)
    got, want = _both(jax.jacfwd(jba._rodrigues),
                      torch.func.jacfwd(ba._rodrigues), w)
    _close(got, want, 1e-5, 1e-6)
    if name == "zero":
        theta = torch.sqrt(torch.sum(torch.zeros(3) ** 2) + 1e-12)
        assert not bool(theta < 1e-6)
        assert theta.item() == np.float32(1e-6)
        # d R / d w_0 at 0 is [e_0]x: the 1e6 of k = w / theta times
        # sin(1e-6) ~ 1e-6
        np.testing.assert_allclose(
            got.numpy()[..., 0], [[0, 0, 0], [0, 0, -1], [0, 1, 0]],
            atol=1e-6)


def _camera_case(seed):
    pts, obs, k, ext_true, ext0 = _scene(n_points=6, cam_err=0.05, seed=seed)
    rng = np.random.RandomState(seed + 10)
    twists = rng.normal(0, 0.02, (4, 6))
    mask = (rng.rand(6, 4) > 0.2).astype(np.float32)
    obs = obs.copy()
    obs[0, 1] += 15.0                   # an outlier: the Huber weight < 1
    return pts + rng.normal(0, 0.03, pts.shape), obs, k, ext0, twists, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_matrix_equal(seed):
    _, _, k, ext0, twists, _ = _camera_case(seed)
    for v in range(4):
        got, want = _both(jba._camera_matrix, ba._camera_matrix, k[v],
                          ext0[v], twists[v])
        _close(got, want, 1e-5, 1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_point_residuals_equal(seed):
    """Residuals and Huber IRLS weights per point, with masked views and an
    outlier that the Huber weight damps."""
    pts, obs, k, ext0, twists, mask = _camera_case(seed)
    cams = np.einsum("vij,vjk->vik", k, ext0)
    weights = []
    for p in range(len(pts)):
        got, want = _both(jba._point_residuals, ba._point_residuals, pts[p],
                          cams, obs[p], mask[p])
        # a residual is a projection (hundreds of px) minus the observation:
        # rtol 1e-5 of the pixel coordinates it is the difference of
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5 * np.abs(obs).max())
        _close(got[1], want[1], 1e-5)
        weights.append(got[1].numpy())
    assert min(w.min() for w in weights) == 0.0          # a masked view
    assert 0.0 < weights[0][2] < 1.0                     # the outlier


@pytest.mark.parametrize("twists_at", ["zero", "random"])
@pytest.mark.parametrize("seed", [0, 3])
def test_build_normal_eqs_equal(twists_at, seed):
    """h, b, hpp_inv, hpc and bp of the Schur reduction: the first
    iteration's linearisation (twists 0) and a later one."""
    pts, obs, k, ext0, twists, mask = _camera_case(seed)
    if twists_at == "zero":
        twists = np.zeros_like(twists)
    got, want = _both(jba._build_normal_eqs, ba._build_normal_eqs, pts,
                      twists, k, ext0, obs, mask)
    for name, g, w in zip(("h", "b", "hpp_inv", "hpc", "bp"), got, want):
        assert g.shape == w.shape, name
        _close(g, w, 1e-4, 1e-5)


@pytest.mark.parametrize("iterations", [5, 12])
def test_bundle_adjust_equal(iterations):
    """The JAX suite's scene (16 points, 4 cameras, translation error 0.05):
    the whole LM loop, accept and reject decisions included."""
    pts, obs, k, ext_true, ext0 = _scene(cam_err=0.05)
    pts0 = pts + np.random.RandomState(1).normal(0, 0.05, pts.shape)
    mask = np.ones(obs.shape[:2], np.float32)
    want = jba.bundle_adjust(pts0, obs, mask, k, ext0, iterations=iterations)
    got = ba.bundle_adjust(pts0, obs, mask, k, ext0, iterations=iterations,
                           device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-3)


@pytest.mark.parametrize("iterations", [1, 3])
def test_bundle_adjust_equal_with_masked_views_and_noise(iterations):
    pts, obs, k, ext_true, ext0 = _scene(n_points=20, noise=0.5, cam_err=0.03,
                                         seed=4)
    pts0 = pts + 0.02
    # a third of the points lose one view; each keeps three (a point seen
    # by one view has no well-posed 3x3 block in float32)
    rng = np.random.RandomState(5)
    mask = np.ones((20, 4), np.float32)
    mask[np.arange(20), rng.randint(0, 4, 20)] = rng.rand(20) > 0.33
    want = jba.bundle_adjust(pts0, obs, mask, k, ext0, iterations=iterations)
    got = ba.bundle_adjust(pts0, obs, mask, k, ext0, iterations=iterations,
                           device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3)


@pytest.mark.parametrize("iterations", [3, 8])
def test_bundle_adjust_equal_where_steps_are_rejected(iterations):
    """`accuracy3d`'s rig with 4 people (100 points, 4 cameras off by 0.5
    deg and 20 mm): JAX accepts the first two steps, rejects the next five
    (the damping grows tenfold each time) and accepts the eighth."""
    from openpose_tpu_torch import accuracy3d
    prob = accuracy3d.bundle_problem(n_people=4, device="cpu")
    args = (prob["pts0"], prob["obs"], prob["vis"], prob["kk"], prob["ext0"])
    want = jba.bundle_adjust(*args, iterations=iterations)
    got = ba.bundle_adjust(*args, iterations=iterations, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3)
    if iterations == 3:       # the third step was rejected: nothing moved
        for g, w in zip(ba.bundle_adjust(*args, iterations=2, device="cpu"),
                        got):
            np.testing.assert_array_equal(g, w)


def test_refines_perturbed_cameras():
    """The JAX suite's recovery gate on the port: mean reprojection under
    0.1 px after 12 iterations."""
    pts, obs, k, ext_true, ext0 = _scene(cam_err=0.05)
    pts0 = pts + np.random.RandomState(1).normal(0, 0.05, pts.shape)
    mask = np.ones(obs.shape[:2], np.float32)
    pts_ref, ext_ref = ba.bundle_adjust(pts0, obs, mask, k, ext0,
                                        iterations=12, device="cpu")
    homog = np.concatenate([pts_ref, np.ones((len(pts_ref), 1))], 1)
    cams = np.einsum("vij,vjk->vik", k, ext_ref)
    proj = np.einsum("vij,nj->nvi", cams, homog)
    err = np.linalg.norm(proj[..., :2] / proj[..., 2:3] - obs, axis=-1)
    assert err.mean() < 0.1, err.mean()
    np.testing.assert_array_equal(ext_ref[0], np.float32(ext0[0]))  # gauge


def test_bundle_adjust_takes_tensors_and_keeps_zero_iterations():
    pts, obs, k, _, ext0 = _scene(n_points=4, cam_err=0.02)
    mask = np.ones(obs.shape[:2], np.float32)
    got = ba.bundle_adjust(*(torch.from_numpy(_f32(a)) for a in
                             (pts, obs, mask, k, ext0)), iterations=0,
                           device="cpu")
    np.testing.assert_array_equal(got[0], _f32(pts))
    np.testing.assert_array_equal(got[1], _f32(ext0))
