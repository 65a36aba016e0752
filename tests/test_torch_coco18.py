"""COCO_18 on the port's normal path, held to the benchmark's plain
reference (CPU, small sizes, seeded weights), and the CNN's split into its
trunk and CPM stages.

* The port's COCO_18 `PoseNet` in float32 against
  `perfbench/reference/cnn.py` on the reference's frozen copy of the spec.
* `PoseInference` on COCO_18 with net_bypass, fed the rendered net outputs
  of the `coco18` configuration's people: its peaks, pair scores and
  assembled people equal the reference decode and assembly; at the cell's
  size every drawn person is found.  (At the 64x96 CPU rehearsal size the
  drawn people are 46 px tall and overlap, so the reference itself finds
  another count: there the two are held equal only.)
* `forward` with a `stage` callable is bit-equal to `forward` without one
  and opens the trunk's stage, then the stages'; `PoseInference` opens both
  once a scale inside `pose.net`, and its outputs are the net's on the
  scale inputs made as before the split.  `split_flops` cuts the count
  where `forward` cuts the net.
"""

import contextlib

import numpy as np
import pytest
import torch

from openpose_tpu_torch.models import caffe_proto, graph, zoo
from openpose_tpu_torch.ops import resize
from openpose_tpu_torch.parallel.inference import PoseInference
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
from openpose_tpu_torch.utils.profiler import TRACE
from perfbench import cells, check, inputs, run
from perfbench.reference import cnn, decode

CPU = torch.device("cpu")
SEED = 4294967311
INFO = POSE_MODEL_INFO[PoseModel.COCO_18]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cell(cpu):
    """The `coco18.video_b8` cell's configuration and traffic, at its CPU
    rehearsal size or at its own."""
    _, cfg, traffic = cells.load_cell("coco18.video_b8")
    return run.sized(cfg, traffic, cpu)


def _model(params):
    spec = caffe_proto.NetSpec.from_json(cnn.load_spec("coco_18"))
    return zoo.from_params(spec, params, INFO, CPU)


def test_the_reference_spec_is_the_ports():
    spec = cnn.load_spec("coco_18")
    assert caffe_proto.NetSpec.from_json(spec).to_json() == \
        graph.load_spec("coco_18").to_json()
    assert cnn.output_channels(spec) == INFO.heatmap_channels == 57


def test_coco18_net_matches_the_plain_reference_in_float32():
    params = inputs.make_params("coco_18", 9, CPU)
    frames = torch.randint(0, 256, (2, 64, 96, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    model = _model(params)
    with torch.backends.mkldnn.flags(enabled=False):
        theirs = model.net((frames.float() / 256.0) - 0.5, torch.float32)
        ours = cnn.forward(cnn.load_spec("coco_18"), params, frames)
    assert theirs.shape == (2, 8, 12, 57)
    err = (ours - theirs).norm() / theirs.norm()
    assert err < 1e-5


@pytest.mark.parametrize("cpu", [True, False], ids=["rehearsal", "cell"])
def test_coco18_decode_equals_the_reference(cpu):
    cfg, traffic = _cell(cpu)
    hw, th = tuple(cfg["net_hw"]), cfg["thresholds"]
    parts = cfg["num_parts"]
    pi = PoseInference(_model(inputs.make_params("coco_18", 1, CPU)),
                       net_hw=hw, device=CPU, net_bypass=True,
                       max_peaks=cfg["max_peaks"], nms_threshold=th["nms"],
                       inter_threshold=th["inter"],
                       inter_min_above_threshold=th["inter_min_above"])
    pairs = torch.tensor(cfg["pairs"], dtype=torch.int32).reshape(-1, 2)
    map_idx = torch.tensor(cfg["map_idx"], dtype=torch.int32).reshape(
        -1, 2) + parts + 1
    assert np.array_equal(pi.decoder.pairs, pairs.numpy())
    for b in range(2):
        people = inputs.batch_people(SEED, b, traffic["batch"],
                                     tuple(traffic["people"]), hw)
        maps = torch.from_numpy(inputs.rendered(cfg, people))
        peaks, scores = pi.decode([maps])
        want_peaks = decode.nms(decode.upsample(maps[..., :parts], hw),
                                th["nms"], cfg["max_peaks"], 0.5)
        want_scores = decode.paf_scores(
            maps, hw, want_peaks, pairs, map_idx, th["inter"],
            th["inter_min_above"], th["nms"])
        k = want_scores.shape[-1]
        assert torch.equal(peaks, want_peaks)
        assert torch.equal(scores[..., :k, :k], want_scores)
        host_peaks, host_scores = pi.fetch(peaks, scores)
        found = []
        for i, (kp, s) in enumerate(decode.decode(maps, cfg)):
            got_kp, got_s = pi.assemble(host_peaks[i], host_scores[i])
            assert check.people_gap(got_kp, got_s, kp, s) == 0.0
            found.append(len(kp))
        if not cpu:
            assert found == (people[:, :, 0, 2] > 0).sum(axis=1).tolist()


class _Stages:
    """A stage callable that records the names it is opened with."""

    def __init__(self):
        self.names = []

    def __call__(self, name):
        self.names.append(name)
        return contextlib.nullcontext()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", [PoseModel.BODY_25, PoseModel.COCO_18])
def test_forward_with_stages_is_bit_equal_to_forward_without(model, dtype):
    net = zoo.load_pose_model(model, seed=0, device=CPU).net
    image = torch.rand((2, 64, 96, 3),
                       generator=torch.Generator().manual_seed(1)) - 0.5
    stages = _Stages()
    with torch.inference_mode():
        want = net(image, dtype)
        got = net(image, dtype, stages)
        made = net(lambda: image, dtype, stages)
    assert torch.equal(got, want) and torch.equal(made, want)
    assert stages.names == [graph.TRUNK, graph.STAGES] * 2


@pytest.mark.parametrize("model, trunk, stages", [
    (PoseModel.BODY_25, 145.5, 141.9), (PoseModel.COCO_18, 145.5, 339.2),
    (PoseModel.MPI_15, 145.5, 333.0)])
def test_split_flops_sum_to_the_count(model, trunk, stages):
    spec = graph.load_spec(POSE_MODEL_INFO[model].spec)
    end = graph.trunk_end(spec)
    # the trunk ends with conv4_4_CPM's activation, which every stage reads
    assert spec.layers[end - 1].tops == ["conv4_4_CPM"]
    assert "conv4_4_CPM" in spec.layers[end].bottoms
    split = graph.split_flops(spec, (368, 656))
    assert sum(split) == sum(graph.count_flops(spec, (368, 656)).values())
    assert [round(f / 1e9, 1) for f in split] == [trunk, stages]


def test_pose_inference_opens_trunk_and_stages_once_a_scale():
    """Two scales: each scale's trunk and stages inside `pose.net`, and the
    sources bit-equal to the net on the scale inputs made as before the
    split (upload and cast once, then per scale resize and normalize)."""
    model = zoo.load_pose_model(PoseModel.COCO_18, seed=0, device=CPU)
    pi = PoseInference(model, net_hw=(64, 96), device=CPU, scale_number=2,
                       compute_dtype=torch.float32)
    frames = torch.randint(0, 256, (2, 64, 96, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    TRACE.drain()
    TRACE.enable()
    try:
        got = pi.net_outputs(frames)
        spans = TRACE.drain()["spans"]
    finally:
        TRACE.disable()
        TRACE.drain()
    tree = [(s[0], None if s[3] is None else spans[s[3]][0]) for s in spans
            if not s[0].startswith("gc.")]
    assert tree == [("pose.net", None)] + [
        (graph.TRUNK, "pose.net"), (graph.STAGES, "pose.net")] * 2
    x = frames.float()
    scales = pi.plan.scale_input_to_net
    with torch.inference_mode():
        want = [model.net(resize.normalize_vgg(
            x if s == scales[0] else resize.resize_fixed_aspect(
                x, s / scales[0], (h, w))), torch.float32)
            for (w, h), s in zip(pi.plan.net_input_sizes, scales)]
    assert len(got) == len(want) == 2
    assert all(torch.equal(g, w) for g, w in zip(got, want))
