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

Last, the CUDA graphs of `parallel/graphs.py`: on the CPU, that the gate
keeps every call eager and counts it, refuses a model-sharded net, and
that the key cache drops the least recently used key; on a card (these
skip without one, and `chip_smoke.py --graphs` runs the same checks
there), that a replay is bit-equal to the eager call on new frames too,
on a card that is not the current device as well, keeps a held output,
counts captures, replays and the fused kernel's launches.
"""

import dataclasses
import types

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
from openpose_tpu_torch.models import checkpoint, graph, zoo
from openpose_tpu_torch.ops import nms, paf_cuda
from openpose_tpu_torch.parallel import graphs
from openpose_tpu_torch.parallel.inference import PoseInference
from openpose_tpu_torch.pose.extractor import PoseExtractor
from openpose_tpu_torch.utils.profiler import TRACE


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
    cp = loose.decoder.connect
    assert (cp.nms_threshold, cp.inter_threshold,
            cp.inter_min_above_threshold) == (0.01, 0.05, 0.95)
    peaks_loose, scores = loose(frames)
    peaks_strict, _ = strict(frames)
    assert peaks_loose.shape == (2, 15, 9, 3) and scores.shape[-1] == 8
    assert (peaks_loose[:, :, 0, 0] >= peaks_strict[:, :, 0, 0]).all()
    assert peaks_loose[:, :, 0, 0].sum() > peaks_strict[:, :, 0, 0].sum()


# --- CUDA graphs (parallel/graphs.py) -----------------------------------


@pytest.fixture
def tracer():
    TRACE.drain()
    TRACE.enable()
    try:
        yield TRACE
    finally:
        TRACE.disable()
        TRACE.drain()


def test_graph_gate_keeps_cpu_calls_eager(mpi, tracer):
    """On the CPU every call runs the eager bodies, as before graphs: no key
    is kept, the outputs equal the bodies' bit for bit, and
    `pose.graph.eager` counts each call of net_outputs and decode; a
    net_bypass net_outputs (an upload and a cast) counts nothing.  Every
    convolution of each scale's CNN counts its plain epilogue, and each
    decode its plain NMS."""
    _, port_model = mpi
    rng = np.random.RandomState(6)
    frames = rng.randint(0, 255, (2, 64, 80, 3)).astype(np.uint8)
    inf = PoseInference(port_model, compute_dtype=torch.float32,
                        device="cpu", **MPI_KW)
    want_src = inf._net([torch.from_numpy(frames)], graphs.eager_stage)
    want = [*want_src, *inf._decode(want_src, graphs.eager_stage)]
    tracer.drain()
    for _ in range(3):
        src = inf.net_outputs(frames)
        got = [*src, *inf.decode(src)]
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not inf._graphs._entries
    n_convs = len(graph.epilogue_plan(port_model.spec))
    assert tracer.drain()["counters"] == {
        "pose.graph.eager": 6,
        graph.EPILOGUE_PLAIN: 3 * MPI_KW["scale_number"] * n_convs,
        nms.PLAIN: 3}

    bypass = PoseInference(port_model, net_hw=(64, 80), net_bypass=True,
                           device="cpu")
    maps = rng.uniform(-0.2, 1.0, (2, 8, 10, 44)).astype(np.float32)
    bypass.decode(bypass.net_outputs(maps))
    assert tracer.drain()["counters"] == {"pose.graph.eager": 1,
                                          nms.PLAIN: 1}


def test_graph_gate_refuses_a_model_sharded_mesh():
    """A net sharded over a ``model`` dimension gathers its weights with
    collectives at use, so its calls stay eager on a card too; so do calls
    on host tensors, and every call on the CPU."""
    def gate(device, model_shards, tensors=()):
        mesh = types.SimpleNamespace(shape=(4 // model_shards, model_shards),
                                     mesh_dim_names=("data", "model"))
        owner = types.SimpleNamespace(device=torch.device(device), mesh=mesh)
        return PoseInference._graphable(owner, tensors)
    assert not gate("cuda", 2)
    assert not gate("cuda", 4)
    assert not gate("cuda", 1, [torch.zeros(1)])
    assert not gate("cpu", 1)


def test_graph_cache_evicts_least_recently_used(monkeypatch, tracer):
    """Per key: eager, then capture and replay, then replay; beyond
    `GraphCache.KEYS` keys the least recently used one goes, and comes
    back as a new key (eager).  The graphs are stood in for by the eager
    body here: only a card captures."""
    class Replayed:
        def __init__(self, body, inputs, device):
            self.body = body

        def replay(self, inputs):
            return self.body(inputs, graphs.eager_stage)
    monkeypatch.setattr(graphs, "_Graphed", Replayed)
    cache = graphs.GraphCache(torch.device("cpu"))

    def body(inputs, stage):
        with stage("test.body"):
            return [inputs[0] + 1]

    def call(n):
        out = cache.run(body, [torch.zeros(n)], True)
        assert torch.equal(out[0], torch.ones(n))

    def keys():
        return [key[2][0][0] for key in cache._entries]   # the length
    assert graphs.GraphCache.KEYS == 8
    for _ in range(3):
        call(1)
    assert tracer.drain()["counters"] == {"pose.graph.eager": 1,
                                          "pose.graph.captures": 1,
                                          "pose.graph.replays": 2}
    for n in range(2, 9):
        call(n)
    assert keys() == [1, 2, 3, 4, 5, 6, 7, 8]
    call(1)                 # replayed: now the most recent
    call(9)                 # a ninth key: 2, the least recent, goes
    assert keys() == [3, 4, 5, 6, 7, 8, 1, 9]
    call(2)                 # seen again as new: eager, and 3 goes
    assert keys() == [4, 5, 6, 7, 8, 1, 9, 2]
    assert tracer.drain()["counters"] == {"pose.graph.eager": 9,
                                          "pose.graph.replays": 1}


@pytest.fixture(scope="module")
def card():
    """The card; the tests that replay graphs skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: only a card captures CUDA graphs")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_body25(card):
    return zoo.load_pose_model(seed=0, device=card)


def _card_case(case, rng):
    """(PoseInference keywords, two different inputs) at the cells'
    368x656."""
    kw = dict(net_hw=(368, 656))
    if case == "net_bypass":
        kw["net_bypass"] = True
        shape = (1, 46, 82, 78)
        return kw, [rng.uniform(-0.2, 1.0, shape).astype(np.float32)
                    for _ in range(2)]
    if case == "two_scales_raw":
        kw.update(scale_number=2, frame_hw=(720, 1280))
        shape = (2, 720, 1280, 3)
    else:
        shape = (int(case[len("batch"):]), 368, 656, 3)
    return kw, [rng.randint(0, 255, shape).astype(np.uint8)
                for _ in range(2)]


def _outputs(inf, inputs):
    src = inf.net_outputs(inputs)
    return [*src, *inf.decode(src)]


@torch.inference_mode()
def _eager(inf, inputs):
    """The bodies of net_outputs and decode, run eagerly on `inputs`."""
    x = torch.as_tensor(inputs)
    src = [x.to(inf.device).float()] if inf.net_bypass \
        else inf._net([x], graphs.eager_stage)
    return [*src, *inf._decode(src, graphs.eager_stage)]


def _replays_match_eager(inf, inputs, other, before=lambda: None):
    """Eager, capturing and replayed calls of one shape, the replays also
    on frames the capture never saw: every output (CNN sources, peaks,
    scores) equal to the eager bodies on the same frames, bit for bit.
    `before` runs before each call."""
    def call(x):
        before()
        return _outputs(inf, x)
    first, captured = call(inputs), call(inputs)
    replayed, again = call(other), call(inputs)
    want, want_other = _eager(inf, inputs), _eager(inf, other)
    for got, wanted in ((first, want), (captured, want), (again, want),
                        (replayed, want_other)):
        assert len(got) == len(wanted)
        assert all(torch.equal(g, w) for g, w in zip(got, wanted))
    # the frames differ, so a stage frozen at capture would show
    assert not torch.equal(want_other[0], want[0])
    return replayed


@pytest.mark.parametrize("case", ["batch1", "batch8", "net_bypass",
                                  "two_scales_raw"])
def test_graph_replay_bit_equal_to_eager(card, card_body25, case):
    """The first call of a shape is eager; the second captures and
    replays, later ones replay, on the same frames and on others: each
    equal to the eager bodies on its frames bit for bit."""
    kw, (inputs, other) = _card_case(case, np.random.RandomState(7))
    inf = PoseInference(card_body25, device=card, **kw)
    _replays_match_eager(inf, inputs, other)


def test_graph_replay_on_a_card_that_is_not_current(card):
    """A `PoseInference` on cuda:1, called with cuda:0 the current device,
    captures and replays on cuda:1: its replays match its eager calls on
    new frames, its outputs are on cuda:1, and a replay leaves cuda:0
    current.  (The fused kernel's launcher makes its card current, so
    cuda:0 is set again before each call.)"""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards: the graphs' card must not be "
                    "the current one")
    other_card = torch.device("cuda", 1)
    model = zoo.load_pose_model(seed=0, device=other_card)
    kw, (inputs, other) = _card_case("batch1", np.random.RandomState(11))
    inf = PoseInference(model, device=other_card, **kw)
    replayed = _replays_match_eager(inf, inputs, other,
                                    before=lambda: torch.cuda.set_device(0))
    assert all(t.device == other_card for t in replayed)
    torch.cuda.set_device(0)
    _outputs(inf, other)
    assert torch.cuda.current_device() == 0


def test_graph_output_held_across_the_next_call(card, card_body25):
    """Outputs are clones: the next replay, on other frames, leaves an
    output a caller holds as it was."""
    kw, (first, second) = _card_case("batch8", np.random.RandomState(8))
    inf = PoseInference(card_body25, device=card, **kw)
    _outputs(inf, first)
    held = _outputs(inf, first)
    kept = [t.clone() for t in held]
    other = _outputs(inf, second)
    torch.cuda.synchronize()
    assert all(torch.equal(h, k) for h, k in zip(held, kept))
    assert not torch.equal(other[0], held[0])


def test_graph_counters_on_card(card, card_body25, tracer):
    """N calls of one shape: one eager call, one capture, N - 1 replays,
    for net_outputs and decode each; the eager call and the capture run
    every convolution's epilogue kernel and the NMS kernels on the host, the
    replays nothing."""
    kw, (inputs, _) = _card_case("batch1", np.random.RandomState(9))
    inf = PoseInference(card_body25, device=card, **kw)
    n = 5
    for _ in range(n):
        _outputs(inf, inputs)
    assert tracer.drain()["counters"] == {
        "pose.graph.eager": 2, "pose.graph.captures": 2,
        "pose.graph.replays": 2 * (n - 1),
        graph.EPILOGUE_FUSED: 2 * len(card_body25.net.epilogues),
        nms.FUSED: 2}


def test_graph_replay_counts_fused_launches(card, card_body25):
    """A replay passes the kernel wrapper by, and still counts its launch:
    one fused launch a call, eager, capturing or replayed."""
    kw, (inputs, _) = _card_case("batch1", np.random.RandomState(10))
    inf = PoseInference(card_body25, device=card, **kw)
    for _ in range(4):
        before = paf_cuda.paf_scores_fused.launches
        _outputs(inf, inputs)
        assert paf_cuda.paf_scores_fused.launches == before + 1
