"""Port batched pose inference and pose extractor vs the JAX package (CPU).

`PoseInference` is held to `ShardedPoseInference` on a virtual 4-device
CPU mesh, in float32, with the same weights (JAX's, through the bridge) and
frames, in its pre-sized multi-scale, raw-frame multi-scale and net-bypass
modes and on one BODY_25 case.  Tolerances: peak counts exact, peaks within
1e-3 px (the JAX suite's sharded-vs-extractor bound: the CNN and the
resize products sum in another order); pair scores rtol = 1e-4, atol =
1e-4, except that peaks 1e-5 px apart can round a line sample to the
neighbouring pixel, which moves that line's mean by one sample's share: at
most 0.1% of the scores may differ, each by at most 0.02.  Then one test for each of the extractor and inference repairs
(`max_peaks`, `maximize_positives` and `connect_params`, `keep_heatmaps`
and `net_resolution_dynamic`, the inference budget and thresholds).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openpose_tpu import train
from openpose_tpu.models import zoo as jzoo
from openpose_tpu.ops import paf as jpaf
from openpose_tpu.params import PoseModel, default_connect_params
from openpose_tpu.parallel import mesh as mesh_lib
from openpose_tpu.parallel.inference import ShardedPoseInference
from openpose_tpu.pose.extractor import PoseExtractor as JaxPoseExtractor
from openpose_tpu_torch.models import checkpoint, zoo
from openpose_tpu_torch.parallel.inference import PoseInference
from openpose_tpu_torch.pose.extractor import PoseExtractor


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
def mpi():
    jax_model = jzoo.load_pose_model(PoseModel.MPI_15_4)
    return jax_model, _port(jax_model)


@pytest.fixture(scope="module")
def body25():
    jax_model = jzoo.load_pose_model(PoseModel.BODY_25)
    return jax_model, _port(jax_model)


def _compare(jax_inf, port_inf, inputs):
    want_peaks, want_scores = (np.asarray(a) for a in jax_inf(inputs))
    got_peaks, got_scores = (t.numpy() for t in port_inf(inputs))
    assert got_peaks.shape == want_peaks.shape
    assert got_scores.shape == want_scores.shape
    assert want_peaks[:, :, 0, 0].sum() > 0, "the frames must give peaks"
    np.testing.assert_array_equal(got_peaks[:, :, 0, 0],
                                  want_peaks[:, :, 0, 0])
    np.testing.assert_allclose(got_peaks, want_peaks, rtol=0, atol=1e-3)
    off = ~np.isclose(got_scores, want_scores, rtol=1e-4, atol=1e-4)
    assert off.mean() <= 1e-3, f"{off.sum()} of {off.size} scores differ"
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=0.02)
    assert port_inf.scale_net_to_output == jax_inf.scale_net_to_output
    return got_peaks, got_scores


# the sizes of tests/test_whole_body.py TestMultiScaleSharded
MPI_KW = dict(net_hw=(64, 80), max_peaks=16, scale_number=2, scale_gap=0.25,
              nms_threshold=0.3, inter_threshold=0.01,
              inter_min_above_threshold=0.95)


@pytest.mark.parametrize("mode", ["presized", "raw_frames", "net_bypass"])
def test_inference_matches_sharded_jax(mpi, mode):
    jax_model, port_model = mpi
    rng = np.random.RandomState(0)
    kw = dict(MPI_KW)
    if mode == "raw_frames":
        kw["frame_hw"] = (96, 128)
        inputs = rng.randint(0, 255, (4, 96, 128, 3)).astype(np.uint8)
    elif mode == "presized":
        inputs = rng.randint(0, 255, (4, 64, 80, 3)).astype(np.uint8)
    else:
        kw.update(scale_number=1, net_bypass=True)
        inputs = rng.uniform(-0.2, 1.0, (4, 8, 10, 44)).astype(np.float32)
    jax_inf = ShardedPoseInference(jax_model, _mesh(4),
                                   compute_dtype=jnp.float32, **kw)
    port_inf = PoseInference(port_model, compute_dtype=torch.float32, **kw,
                             device="cpu")
    peaks, _ = _compare(jax_inf, port_inf, inputs)
    assert peaks.shape == (4, 15, 17, 3)


def test_inference_body25_raw_frames_matches_sharded_jax(body25):
    """BODY_25 at the default 127 budget (the fused backend in the port,
    the sampled one in JAX on the CPU) from raw frames."""
    jax_model, port_model = body25
    frames = np.random.RandomState(1).randint(
        0, 255, (2, 72, 96, 3)).astype(np.uint8)
    kw = dict(net_hw=(48, 64), frame_hw=(72, 96))
    jax_inf = ShardedPoseInference(jax_model, _mesh(2),
                                   compute_dtype=jnp.float32, **kw)
    port_inf = PoseInference(port_model, compute_dtype=torch.float32, **kw,
                             device="cpu")
    peaks, _ = _compare(jax_inf, port_inf, frames)
    assert peaks.shape == (2, 25, 128, 3)


def test_net_bypass_rejects_multiscale_and_raw_frames(mpi):
    _, port_model = mpi
    for kw in (dict(scale_number=2), dict(frame_hw=(96, 128))):
        with pytest.raises(ValueError, match="net_bypass"):
            PoseInference(port_model, net_hw=(64, 80), net_bypass=True, **kw,
                          device="cpu")


@pytest.mark.parametrize("max_peaks,count", [
    (127, 5), (127, 12), (127, 40), (127, 100), (16, 12), (16, 16)])
def test_fetch_buckets_match_jax(mpi, max_peaks, count):
    """The score slice `fetch` returns, bounded by the instance's budget
    (the JAX rule), equals JAX's on the same device outputs."""
    jax_model, port_model = mpi
    rng = np.random.RandomState(count)
    peaks = rng.uniform(0, 9, (2, 15, max_peaks + 1, 3)).astype(np.float32)
    peaks[:, :, 0, 0] = rng.randint(0, count + 1, (2, 15))
    peaks[1, 3, 0, 0] = count
    scores = rng.uniform(-1, 1, (2, 14, max_peaks, max_peaks)) \
        .astype(np.float32)
    jax_inf = ShardedPoseInference(jax_model, _mesh(2), net_hw=(64, 80),
                                   max_peaks=max_peaks)
    port_inf = PoseInference(port_model, net_hw=(64, 80),
                             max_peaks=max_peaks, device="cpu")
    want = jax_inf.fetch(jnp.asarray(peaks), jnp.asarray(scores))
    got = port_inf.fetch(torch.from_numpy(peaks), torch.from_numpy(scores))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, np.asarray(w))


# --- repairs of the extractor and of the inference constructor ---------


def test_extractor_takes_max_peaks(body25):
    """`PoseExtractor(model, max_peaks=16)`: the NMS budget and the routing
    follow it (the sampled backend at 16), as in JAX."""
    jax_model, port_model = body25
    image = np.random.RandomState(3).randint(0, 255, (64, 80, 3)) \
        .astype(np.uint8)
    want = JaxPoseExtractor(jax_model, max_peaks=16,
                            compute_dtype=jnp.float32).forward(
        image, net_resolution=(80, 64))
    got = PoseExtractor(port_model, max_peaks=16,
                        compute_dtype=torch.float32, device="cpu").forward(
        image, net_resolution=(80, 64))
    assert got.peaks.shape == want.peaks.shape == (25, 17, 3)
    np.testing.assert_array_equal(got.peaks[:, 0, 0], want.peaks[:, 0, 0])
    np.testing.assert_allclose(got.peaks, want.peaks, rtol=1e-4, atol=1e-4)
    assert got.keypoints.shape == want.keypoints.shape


def _injected_output(info, h, w, centers, seed=1):
    rng = np.random.RandomState(seed)
    kp = np.zeros((1, len(centers), info.num_parts, 3), np.float32)
    for p, cx in enumerate(centers):
        kp[0, p, :, 0] = cx + rng.uniform(-14, 14, info.num_parts)
        kp[0, p, :, 1] = h / 2 + rng.uniform(-30, 30, info.num_parts)
        kp[0, p, :, 2] = 1.0
    pairs, map_idx = jpaf.pair_tables(info)
    return np.array(train.make_targets(
        jnp.asarray(kp), jnp.asarray(pairs), jnp.asarray(map_idx),
        (h, w), info.num_parts, info.heatmap_channels))[0]


def test_extractor_maximize_positives_matches_jax(body25):
    """maximize_positives switches to its connect parameters and to the
    assembly's retry pass; the people equal JAX's with the flag."""
    jax_model, port_model = body25
    h, w = 176, 320
    net_output = _injected_output(jax_model.info, h, w, (90.0, 230.0))
    # a weakened limb map: the default parameters drop people that the
    # maximize-positives ones keep
    net_output[..., 26:] *= 0.5
    image = np.zeros((h, w, 3), np.float32)
    for flag in (False, True):
        ex = PoseExtractor(port_model, maximize_positives=flag,
                           compute_dtype=torch.float32, device="cpu")
        # the port's own ConnectParams class: same fields
        assert dataclasses.asdict(ex.connect) == dataclasses.asdict(
            default_connect_params(PoseModel.BODY_25, flag))
        got = ex.forward(image, net_resolution=(w, h), net_output=net_output)
        want = JaxPoseExtractor(jax_model, maximize_positives=flag,
                                compute_dtype=jnp.float32).forward(
            image, net_resolution=(w, h), net_output=net_output)
        assert got.keypoints.shape == want.keypoints.shape
        np.testing.assert_allclose(got.keypoints, want.keypoints,
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4,
                                   atol=1e-5)
    custom = default_connect_params(PoseModel.BODY_25, True)
    assert PoseExtractor(port_model, connect_params=custom,
                         device="cpu").connect is custom


def test_extractor_keep_heatmaps_and_dynamic_resolution(body25):
    """keep_heatmaps returns the merged low-res map of all channels;
    net_resolution_dynamic clips the derived net width, both as in JAX."""
    jax_model, port_model = body25
    image = np.random.RandomState(4).randint(0, 255, (48, 160, 3)) \
        .astype(np.uint8)
    kwargs = dict(net_resolution=(-1, 64), scale_number=2,
                  keep_heatmaps=True, net_resolution_dynamic=0.5)
    want = JaxPoseExtractor(jax_model, compute_dtype=jnp.float32).forward(
        image, **kwargs)
    got = PoseExtractor(port_model, compute_dtype=torch.float32,
                        device="cpu").forward(
        image, **kwargs)
    assert got.net_input_sizes == want.net_input_sizes
    assert got.net_input_sizes[0][0] < 208       # clipped below 160 / 48 * 64
    assert got.heatmaps.shape == want.heatmaps.shape
    assert got.heatmaps.shape[-1] == jax_model.info.heatmap_channels
    np.testing.assert_allclose(got.heatmaps, want.heatmaps, rtol=1e-4,
                               atol=1e-4)
    assert PoseExtractor(port_model, device="cpu").forward(
        image, net_resolution=(-1, 64)).heatmaps is None


def test_inference_takes_budget_and_thresholds(mpi):
    """max_peaks and the three thresholds reach the NMS and the scoring."""
    _, port_model = mpi
    frames = np.random.RandomState(5).randint(0, 255, (2, 64, 80, 3)) \
        .astype(np.uint8)
    loose = PoseInference(port_model, net_hw=(64, 80), max_peaks=8,
                          nms_threshold=0.01, compute_dtype=torch.float32,
                          device="cpu")
    strict = PoseInference(port_model, net_hw=(64, 80), max_peaks=8,
                           nms_threshold=0.6, compute_dtype=torch.float32,
                           device="cpu")
    assert loose.thresholds == (0.01, 0.05, 0.95)
    peaks_loose, scores = loose(frames)
    peaks_strict, _ = strict(frames)
    assert peaks_loose.shape == (2, 15, 9, 3) and scores.shape[-1] == 8
    assert (peaks_loose[:, :, 0, 0] >= peaks_strict[:, :, 0, 0]).all()
    assert peaks_loose[:, :, 0, 0].sum() > peaks_strict[:, :, 0, 0].sum()
