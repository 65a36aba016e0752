"""The port's BODY_25 slice end to end vs the JAX package (CPU, float32).

The same JAX random weights (through the weight bridge) and the same image
go through `openpose_tpu.pose.extractor.PoseExtractor` and the port's.  Peak
counts and people must match; peaks and pair scores agree to the JAX
suite's tolerances (rtol = atol = 1e-4 for peaks, rtol 1e-4 / atol 1e-5 for
scores): the CNN, resize and tap sums run in another order.
"""

import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openpose_tpu import scenes, train
from openpose_tpu.models import zoo as jzoo
from openpose_tpu.ops import paf as jpaf
from openpose_tpu.params import PoseModel
from openpose_tpu.pose.extractor import PoseExtractor as JaxPoseExtractor
from openpose_tpu_torch import synthetic
from openpose_tpu_torch.models import checkpoint, zoo
from openpose_tpu_torch.ops import resize
from openpose_tpu_torch.parallel.inference import PoseInference
from openpose_tpu_torch.pose.extractor import PoseExtractor

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    jax_model = jzoo.load_pose_model(PoseModel.BODY_25)
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jax_model.params.items()}
    port_model = zoo.from_params(jax_model.spec,
                                 checkpoint.from_jax_params(params),
                                 jax_model.info, device="cpu")
    return jax_model, port_model


def _assert_predictions_match(got, want):
    np.testing.assert_array_equal(got.peaks[:, 0, 0], want.peaks[:, 0, 0])
    np.testing.assert_allclose(got.peaks, want.peaks, rtol=1e-4, atol=1e-4)
    assert got.keypoints.shape == want.keypoints.shape
    np.testing.assert_allclose(got.keypoints, want.keypoints,
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-5)
    assert got.scale_net_to_output == want.scale_net_to_output
    assert got.net_input_sizes == want.net_input_sizes


@pytest.mark.parametrize("scale_number", [1, 2])
def test_extractor_matches_jax_on_an_image(models, scale_number):
    jax_model, port_model = models
    rng = np.random.RandomState(0)
    people = scenes.random_people(rng, 2, (96, 160), height_range=(60, 80),
                                  min_spacing=50)
    image = synthetic.render_scene_image(people, (96, 160), rng)
    kwargs = dict(net_resolution=(-1, 64), scale_number=scale_number)
    want = JaxPoseExtractor(jax_model, compute_dtype=jnp.float32).forward(
        image, **kwargs)
    got = PoseExtractor(port_model, compute_dtype=torch.float32,
                        device="cpu").forward(
        image, **kwargs)
    assert want.peaks[:, 0, 0].sum() > 0, "the scene must produce peaks"
    _assert_predictions_match(got, want)


def test_extractor_scores_match_jax(models):
    """The [P, K, K] pair scores of the slice, from the same peaks."""
    jax_model, port_model = models
    image = np.random.RandomState(1).randint(0, 255, (64, 80, 3)) \
        .astype(np.uint8)
    port = PoseExtractor(port_model, compute_dtype=torch.float32,
                         device="cpu")
    from openpose_tpu.pose import scaler
    plan = scaler.extract_scales((80, 64), (80, 64))
    img = torch.from_numpy(image.astype(np.float32)[None])
    peaks, scores = port.decode(port.net_outputs(img, plan), plan, 0.5)
    with torch.inference_mode():
        source = port_model.forward(resize.normalize_vgg(img), torch.float32)
    want = np.asarray(jpaf.paf_scores_multiscale(
        (jnp.asarray(source.numpy()),), (1.0,), (64, 80),
        jnp.asarray(peaks.numpy()), jnp.asarray(port.decoder.pairs),
        jnp.asarray(port.decoder.map_idx_dev.numpy()), 0.05, 0.95, 0.05, fast_peaks=0,
        use_pallas=False))
    assert (want > 0).any(), "the scene must have accepted pairs"
    np.testing.assert_allclose(scores.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("centers", [(120.0,), (90.0, 230.0)])
def test_injected_people_match_jax(models, centers):
    """net_output injection (the reference's poseNetOutput hook): the JAX
    package's rendered targets assemble the same people in both packages."""
    jax_model, port_model = models
    info = jax_model.info
    h, w = 176, 320
    rng = np.random.RandomState(1)
    kp = np.zeros((1, len(centers), info.num_parts, 3), np.float32)
    for p, cx in enumerate(centers):
        kp[0, p, :, 0] = cx + rng.uniform(-14, 14, info.num_parts)
        kp[0, p, :, 1] = 88 + rng.uniform(-30, 30, info.num_parts)
        kp[0, p, :, 2] = 1.0
    pairs, map_idx = jpaf.pair_tables(info)
    net_output = np.asarray(train.make_targets(
        jnp.asarray(kp), jnp.asarray(pairs), jnp.asarray(map_idx),
        (h, w), info.num_parts, info.heatmap_channels))[0]
    image = np.zeros((h, w, 3), np.float32)
    want = JaxPoseExtractor(jax_model, compute_dtype=jnp.float32).forward(
        image, net_resolution=(w, h), net_output=net_output)
    got = PoseExtractor(port_model, compute_dtype=torch.float32,
                        device="cpu").forward(
        image, net_resolution=(w, h), net_output=net_output)
    _assert_predictions_match(got, want)
    assert got.keypoints.shape[0] >= len(centers)
    top = np.argsort(-got.scores)[:len(centers)]
    got_means = sorted(float(np.mean(got.keypoints[p, got.keypoints[p, :, 2] > 0, 0]))
                       for p in top)
    np.testing.assert_allclose(got_means, sorted(kp[0, :, :, 0].mean(-1)),
                               atol=8.0)


def test_synthetic_targets_match_train_make_targets():
    info = jzoo.POSE_MODEL_INFO[PoseModel.BODY_25]
    rng = np.random.RandomState(4)
    kp = np.zeros((2, 3, info.num_parts, 3), np.float32)
    kp[..., 0] = rng.uniform(0, 160, kp.shape[:3])
    kp[..., 1] = rng.uniform(0, 96, kp.shape[:3])
    kp[..., 2] = rng.rand(*kp.shape[:3]) > 0.2
    pairs, map_idx = jpaf.pair_tables(info)
    want = np.asarray(train.make_targets(
        jnp.asarray(kp), jnp.asarray(pairs), jnp.asarray(map_idx), (96, 160),
        info.num_parts, info.heatmap_channels))
    got = synthetic.make_targets(kp, pairs, map_idx, (96, 160),
                                 info.num_parts, info.heatmap_channels)
    assert got.shape == want.shape == (2, 12, 20, info.heatmap_channels)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_batched_inference_matches_extractor(models):
    """PoseInference on a batch == the extractor frame by frame; fetch cuts
    the scores to the smallest bucket covering the largest count."""
    _, port_model = models
    frames = np.random.RandomState(2).randint(0, 255, (2, 48, 64, 3)) \
        .astype(np.uint8)
    inference = PoseInference(port_model, net_hw=(48, 64),
                              compute_dtype=torch.float32, device="cpu")
    peaks, scores = inference(frames)
    assert peaks.shape == (2, 25, 128, 3) and scores.shape == (2, 26, 127, 127)
    extractor = PoseExtractor(port_model, compute_dtype=torch.float32,
                              device="cpu")
    for b in range(2):
        # batch 1 and batch 2 convolutions sum in different orders
        pred = extractor.forward(frames[b], net_resolution=(64, 48))
        np.testing.assert_array_equal(peaks[b, :, 0, 0].numpy(),
                                      pred.peaks[:, 0, 0])
        np.testing.assert_allclose(peaks[b].numpy(), pred.peaks,
                                   rtol=1e-4, atol=1e-4)
    peaks_np, scores_np = inference.fetch(peaks, scores)
    k = int(peaks_np[:, :, 0, 0].max())
    bucket = next(b for b in PoseInference.SCORE_BUCKETS if k <= b)
    assert scores_np.shape == (2, 26, bucket, bucket)
    np.testing.assert_array_equal(scores_np,
                                  scores[:, :, :bucket, :bucket].numpy())


def test_package_imports_without_jax_and_builds_nothing():
    """Every module imports with JAX and process spawning blocked, and the
    CPU path runs without building the kernels."""
    script = r"""
import importlib, pkgutil, subprocess, sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax is blocked")
sys.meta_path.insert(0, _NoJax())
def _boom(*a, **k):
    raise AssertionError("a process was started")
subprocess.run = subprocess.Popen = _boom
import openpose_tpu_torch
for mod in pkgutil.walk_packages(openpose_tpu_torch.__path__, "openpose_tpu_torch."):
    importlib.import_module(mod.name)
import torch
from openpose_tpu_torch.kernels import build
from openpose_tpu_torch.ops import paf
peaks = torch.zeros(1, 2, 5, 3)
peaks[0, :, 0, 0] = 1
peaks[0, 0, 1, :2] = torch.tensor([3.0, 4.0])
peaks[0, 1, 1, :2] = torch.tensor([20.0, 9.0])
out = paf.paf_scores_multiscale(
    [torch.zeros(1, 4, 4, 5)], [1.0], (32, 32), peaks,
    torch.tensor([[0, 1]], dtype=torch.int32),
    torch.tensor([[3, 4]], dtype=torch.int32), 0.05, 0.95, 0.05)
assert out.shape == (1, 1, 4, 4)
assert build.LIBRARY.lib is None
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print("OK")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
