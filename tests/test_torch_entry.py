"""`openpose_tpu_torch/entry.py` against the repository's
`__graft_entry__.py`, on the CPU.

The port's `fn` is held to the original's pipeline (`__graft_entry__.py`'s
`fn`, built from `openpose_tpu.ops` with the CNN in float32) at 64x96 on
random images, with the original's BODY_25 weights through the checkpoint
bridge: peak counts exact, peak positions and scores within 1e-5 (the
CNNs differ in the last float32 bits), pair scores rtol 1e-4, atol 1e-5
(`tests/test_ops.py:404`).  At the defaults, the example arguments and
the outputs have the original's shapes and types.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_tpu.ops import nms as jnms
from openpose_tpu.ops import paf as jpaf
from openpose_tpu.ops import resize as jresize
from openpose_tpu.models import graph as jgraph
from openpose_tpu_torch import entry as port_entry
from openpose_tpu_torch.device import NoCudaDeviceError
from openpose_tpu_torch.models import checkpoint, graph

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL_HW = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two threads per worker: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def original():
    """The repository's `__graft_entry__` module and its `entry()`."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry_original", ROOT / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fn, example_args = module.entry()
    return module, fn, example_args


@pytest.fixture(scope="module")
def small(original):
    """Random images at 64x96 through the original's pipeline with the
    CNN in float32: (the port's BODY_25 net on the original's weights,
    images, the CNN's output, peaks, pair scores)."""
    from openpose_tpu.params import POSE_MODEL_INFO, PoseModel
    _, _, (jparams, _) = original
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    spec = jgraph.load_spec(info.spec)
    pairs, map_idx = (jnp.asarray(t) for t in jpaf.pair_tables(info))

    def fn(params, images):
        """The body of `__graft_entry__.py`'s fn, the CNN in float32."""
        out = jgraph.forward(params, spec, jresize.normalize_vgg(images),
                             jnp.float32)
        merged = jresize.resize_bicubic(out[..., :info.num_parts], SMALL_HW)
        peaks = jnms.nms(merged, 0.05, 127)
        scores = jpaf.paf_scores_multiscale(
            (out,), (1.0,), SMALL_HW, peaks, pairs, map_idx, 0.05, 0.95,
            0.05)
        return out, peaks, scores
    images = np.random.RandomState(0).uniform(
        0, 255, (2, *SMALL_HW, 3)).astype(np.float32)
    out, peaks, scores = (np.asarray(t) for t in jax.jit(fn)(
        jparams, jnp.asarray(images)))
    net = graph.PoseNet(graph.load_spec(info.spec), checkpoint.from_jax_params(
        {k: {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in jparams.items()}))
    assert peaks[:, :, 0, 0].sum() > 100 and (scores > 0).sum() > 100
    return net, images, out, peaks, scores


def _port_fn_small():
    fn, _ = port_entry.entry(device="cpu", net_hw=SMALL_HW,
                             compute_dtype=torch.float32)
    return fn


def test_fn_matches_the_original_on_the_same_net_output(small):
    """Everything after the CNN: the port's fn given a net that returns
    the original's CNN output.  Counts exact, refined positions within
    1e-4 px (the JAX suite's NMS tolerance, `tests/test_torch_nms.py`),
    peak scores within 1e-5, pair scores rtol 1e-4, atol 1e-5."""
    _, images, out, want_peaks, want_scores = small
    out = torch.tensor(out)
    peaks, scores = (t.numpy() for t in _port_fn_small()(
        lambda x, dtype: out, torch.from_numpy(images)))
    assert peaks.shape == want_peaks.shape == (2, 25, 128, 3)
    assert scores.shape == want_scores.shape == (2, 26, 127, 127)
    np.testing.assert_array_equal(peaks[:, :, 0, 0], want_peaks[:, :, 0, 0])
    np.testing.assert_allclose(peaks[:, :, 1:, :2], want_peaks[:, :, 1:, :2],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(peaks[:, :, 1:, 2], want_peaks[:, :, 1:, 2],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-5)


def test_fn_matches_the_original_end_to_end_in_float32(small):
    """The whole fn, the port's CNN on the original's weights.  The two
    float32 CNNs differ by up to 3e-5 on outputs of about +-5, which the
    8x resize and the centroid carry on: counts exact, positions and peak
    scores within 5e-4, pair scores rtol 1e-4, atol 1e-4."""
    net, images, out, want_peaks, want_scores = small
    peaks, scores = (t.numpy() for t in _port_fn_small()(
        net, torch.from_numpy(images)))
    with torch.inference_mode():
        got_out = net(torch.from_numpy(images) / 256.0 - 0.5,
                      torch.float32).numpy()
    np.testing.assert_allclose(got_out, out, rtol=0,
                               atol=1e-5 * np.ptp(out))
    np.testing.assert_array_equal(peaks[:, :, 0, 0], want_peaks[:, :, 0, 0])
    np.testing.assert_allclose(peaks[:, :, 1:], want_peaks[:, :, 1:],
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-4)


def test_defaults_give_the_original_arguments_and_output_shapes(original):
    _, jfn, (jparams, jimage) = original
    fn, (net, image) = port_entry.entry(device="cpu")
    assert isinstance(net, graph.PoseNet)
    assert tuple(image.shape) == jimage.shape == (1, 368, 656, 3)
    assert image.dtype == torch.float32 and jimage.dtype == np.float32
    assert not image.any()
    assert sorted(net.params()) == sorted(jparams)
    for layer, blobs in jparams.items():
        for key, blob in blobs.items():
            got = net.params()[layer][key]
            assert got.dtype == torch.float32 and blob.dtype == jnp.float32
            assert got.numel() == blob.size, (layer, key)
    want = jax.eval_shape(jfn, jparams, jimage)
    got = fn(net, image)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want] \
        == [(1, 25, 128, 3), (1, 26, 127, 127)]
    assert all(t.dtype == torch.float32 for t in got)
    assert all(w.dtype == jnp.float32 for w in want)
    assert all(bool(torch.isfinite(t).all()) for t in got)


def test_without_a_card_entry_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        port_entry.entry()


def test_dryrun_multichip_is_the_ports(original):
    from openpose_tpu_torch.parallel import dryrun
    module, _, _ = original
    assert port_entry.dryrun_multichip is dryrun.dryrun_multichip
    assert callable(module.dryrun_multichip)


def test_main_runs_the_dry_run_on_one_gloo_rank(capsys):
    found = port_entry.main(["1", "--cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == found
    assert found["inference"] and found["whole_body"]


def test_main_without_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(NoCudaDeviceError):
        port_entry.main(["2"])


