"""The CNN's bf16 convolution epilogue (`ops/conv_epilogue.py`,
`models/graph.py::epilogue_plan`), on the CPU.

The plan folds into each convolution the ReLU or PReLU that directly
follows it in place, in every bundled spec, and nothing where another
layer could see the blob before the activation.  The plain version is the
sequence `PoseNet` ran before the kernel, bit for bit: alone, over whole
nets in bf16, and under a trainer's autograd (forward and gradients).  The
kernel's autograd function, with the launch emulated by the plain version
in place, gives a trainer's net the gradients of that sequence bit for
bit.  The `cnn.epilogue.*` counters count every convolution once a host
run.  The kernel itself runs only on a card, where `chip_smoke.py
--epilogue` holds it to the plain version bit for bit, gradients too
(pytest does not run there).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from openpose_tpu_torch.models import graph
from openpose_tpu_torch.models.caffe_proto import LayerSpec, NetSpec
from openpose_tpu_torch.ops import conv_epilogue
from openpose_tpu_torch.utils.profiler import TRACE

# spec: (convolutions, convolutions that fold their activation)
SPECS = {"body_25": (114, 108), "coco_18": (92, 80), "mpi_15": (92, 80),
         "mpi_15_4": (64, 56), "face_70": (52, 46), "hand_21": (52, 46)}
CHANNELS = [19, 22, 26, 38, 52, 71, 96, 128, 512]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tracer():
    TRACE.disable()
    TRACE.drain()
    TRACE.enable()
    try:
        yield TRACE
    finally:
        TRACE.disable()
        TRACE.drain()


def _present_layers(net, acts, dtype):
    """`PoseNet._layers` as it ran before the epilogue was one step: a
    float32 bias add and a cast after each bf16 convolution, every ReLU
    and PReLU a layer of its own."""
    for layer in net.spec.layers:
        x = acts[layer.bottoms[0]]
        if layer.type == "Convolution":
            w = net.param(layer.name, "w").to(dtype)
            b = net.param(layer.name, "b")
            if dtype == torch.float32:
                out = F.conv2d(x, w, b, layer.stride, layer.pad)
            else:
                out = F.conv2d(x, w, None, layer.stride, layer.pad)
                out = (out + b[:, None, None]).to(dtype)
        elif layer.type == "ReLU":
            out = F.relu(x)
        elif layer.type == "PReLU":
            slope = net.param(layer.name, "slope").to(dtype)
            out = torch.where(x >= 0, x, x * slope[:, None, None])
        elif layer.type == "Pooling":
            out = graph._max_pool(x, layer)
        else:
            out = torch.cat([acts[b] for b in layer.bottoms], dim=1)
        for top in layer.tops:
            acts[top] = out
    return acts[net.spec.output].permute(0, 2, 3, 1).to(torch.float32)


def _present_forward(net, image, dtype):
    with graph.full_f32_convs():
        acts = {net.spec.input: image.permute(0, 3, 1, 2).to(dtype)}
        return _present_layers(net, acts, dtype)


def _bits(t):
    return t.contiguous().view(torch.int16)


def _net(spec, seed=0, trainable=False):
    """Seeded weights with random biases and slopes, so that every bias
    and slope path carries signal."""
    gen = torch.Generator().manual_seed(seed)
    params = graph.init_params(spec, gen)
    for sub in params.values():
        for key in ("b", "slope"):
            if key in sub:
                sub[key] = torch.rand(sub[key].shape, generator=gen) - 0.3
    return graph.PoseNet(spec, params, trainable=trainable)


def _image(spec, hw, batch=1, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        -0.5, 0.5, (batch, *hw, spec.input_channels)).astype(np.float32))


def _shared_blob_spec():
    """A ReLU that writes a blob of its own, so that a Concat also reads
    the convolution's blob before it; and a PReLU that rewrites a
    convolution's blob in place, but after a pool has read it."""
    L = LayerSpec
    return NetSpec(name="shared", input="image", input_channels=3, layers=[
        L("c1", "Convolution", ["image"], ["c1"], num_output=8, kernel=3,
          pad=1),
        L("r1", "ReLU", ["c1"], ["r1"]),
        L("cat", "Concat", ["c1", "r1"], ["cat"]),
        L("c2", "Convolution", ["cat"], ["c2"], num_output=6, kernel=3,
          pad=1),
        L("p2", "Pooling", ["c2"], ["p2"], kernel=2, stride=2),
        L("pr2", "PReLU", ["c2"], ["c2"]),
        L("c3", "Convolution", ["c2"], ["c3"], num_output=5, kernel=1),
        L("r3", "ReLU", ["c3"], ["c3"]),
        L("cat2", "Concat", ["c3", "c2"], ["cat2"]),
        L("p3", "Pooling", ["cat2"], ["p3"], kernel=2, stride=2),
        L("cat3", "Concat", ["p3", "p2"], ["net_output"]),
    ])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_epilogue_plan_folds_each_in_place_activation(name):
    spec = graph.load_spec(name)
    plan = graph.epilogue_plan(spec)
    n_convs, n_folded = SPECS[name]
    assert len(plan) == n_convs
    folded = {conv: act for conv, act in plan.items() if act[0] != "none"}
    assert len(folded) == n_folded
    layers = {layer.name: i for i, layer in enumerate(spec.layers)}
    for conv, (kind, act) in folded.items():
        after = spec.layers[layers[conv] + 1]
        assert (after.name, after.type.lower()) == (act, kind)
        assert after.bottoms == after.tops == spec.layers[layers[conv]].tops
    # what is left: the output convolutions, whose blobs only Concat
    # layers and the net's output read, and no activation at all
    activated = {b for layer in spec.layers
                 if layer.type in ("ReLU", "PReLU") for b in layer.bottoms}
    for conv, act in plan.items():
        if conv in folded:
            continue
        assert act == ("none", None)
        tops = spec.layers[layers[conv]].tops
        assert not activated.intersection(tops)
        readers = [layer.type for layer in spec.layers
                   if set(tops) & set(layer.bottoms)]
        assert set(readers) <= {"Concat"}
        assert readers or spec.output in tops


def test_epilogue_plan_leaves_a_blob_others_read_unfused():
    spec = _shared_blob_spec()
    assert graph.epilogue_plan(spec) == {
        "c1": ("none", None), "c2": ("none", None), "c3": ("relu", "r3")}
    net = _net(spec, seed=4)
    image = _image(spec, (12, 16), batch=2)
    with torch.inference_mode():
        got = net(image, torch.bfloat16)
        want = _present_forward(net, image, torch.bfloat16)
    assert torch.equal(_bits(got.to(torch.bfloat16)),
                       _bits(want.to(torch.bfloat16)))
    assert torch.equal(got, want)


def _edge_values(rng, n):
    """bf16 values with negatives, zeros of both signs, the largest finite
    values, tiny ones and ordinary ones."""
    x = rng.standard_normal(n).astype(np.float32) * 3
    special = np.array([0.0, -0.0, 1e-40, -1e-40, 3.3e38, -3.3e38, 1e30,
                        -1e30, 1.0, -1.0, 2.0 ** -126, -(2.0 ** -126)],
                       np.float32)
    x[:special.size] = special
    return x


@pytest.mark.parametrize("kind", ["none", "relu", "prelu"])
@pytest.mark.parametrize("channels", CHANNELS)
def test_plain_is_the_present_sequence(kind, channels):
    rng = np.random.RandomState(channels)
    shape = (2, channels, 5, 7)
    x = torch.from_numpy(_edge_values(rng, int(np.prod(shape)))
                         .reshape(shape)).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    bias = torch.from_numpy(_edge_values(rng, channels) / 4)
    bias[:3] = torch.tensor([-0.0, 0.0, 1e38])
    slope = torch.from_numpy(rng.uniform(-0.5, 1.5, channels)
                             .astype(np.float32))
    want = (x + bias[:, None, None]).to(torch.bfloat16)
    if kind == "relu":
        want = F.relu(want)
    elif kind == "prelu":
        s = slope.to(torch.bfloat16)
        want = torch.where(want >= 0, want, want * s[:, None, None])
    got = conv_epilogue.plain(x, bias, kind, slope)
    assert got.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(want))
    # the wrapper runs the plain version on a CPU tensor
    assert torch.equal(_bits(conv_epilogue.bias_act(x, bias, kind, slope)),
                       _bits(want))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_bf16_forward_is_the_present_sequence(name):
    """Each bundled net, whole, in bf16 (and float32, and the float64 that
    `chip_smoke.py`'s gradient check runs through `_run`), with the plan:
    the outputs equal those of the layer loop before, bit for bit."""
    spec = graph.load_spec(name)
    net = _net(spec, seed=2)
    image = _image(spec, (24, 40))
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            assert torch.equal(net(image, dtype),
                               _present_forward(net, image, dtype))
        assert torch.equal(net._run(image, torch.float64, None),
                           _present_forward(net, image, torch.float64))


def _trained_against_present(name):
    """A trainer's net in bf16, forward and backward, and the layer loop
    before on a net of the same weights: (outputs, gradients) of each."""
    spec = _shared_blob_spec() if name == "shared" else graph.load_spec(name)
    hw = (12, 16) if name == "shared" else (24, 40)
    image = _image(spec, hw, seed=3)
    runs = []
    for forward in (lambda n: n(image, torch.bfloat16),
                    lambda n: _present_forward(n, image, torch.bfloat16)):
        net = _net(spec, seed=5, trainable=True)
        with graph.full_f32_convs():
            out = forward(net)
            (out.float() ** 2).sum().backward()
        runs.append((out.detach(), {k: p.grad.clone()
                                    for k, p in net.weights.items()}))
    return spec, runs


def _assert_same_training(runs):
    (got, got_grads), (want, want_grads) = runs
    assert torch.equal(got, want)
    assert got_grads.keys() == want_grads.keys()
    for key in want_grads:
        assert torch.equal(got_grads[key], want_grads[key]), key


@pytest.mark.parametrize("name", ["body_25", "shared"])
def test_trainable_net_under_grad_takes_the_plain_path(name, tracer):
    """A trainer's net in bf16 under autograd on the CPU: the plain
    epilogue, with forward and gradients those of the layer loop before,
    bit for bit."""
    spec, runs = _trained_against_present(name)
    _assert_same_training(runs)
    n_convs = len(graph.epilogue_plan(spec))
    assert tracer.drain()["counters"] == {graph.EPILOGUE_PLAIN: n_convs}


def _emulated_launch(x, bias, kind, slope, pre=None):
    """The kernel's effect, by the plain version: x overwritten with the
    result, pre (PReLU) with the pre-activation."""
    y = (x + bias[:, None, None]).to(x.dtype)
    if pre is not None:
        pre.copy_(y)
    x.copy_(conv_epilogue.activate(y, kind, slope))
    conv_epilogue.bias_act.launches += 1


@pytest.mark.parametrize("name", ["body_25", "coco_18", "shared"])
def test_kernel_under_autograd_keeps_the_plain_gradients(name, tracer,
                                                         monkeypatch):
    """The kernel's path under a trainer's autograd (`_BiasAct`), with the
    launch emulated in place on the CPU: the forward and every gradient of
    the layer loop before, bit for bit, for ReLU, PReLU and no activation;
    one launch a convolution, each counted fused."""
    monkeypatch.setattr(conv_epilogue, "fuses", lambda x: True)
    monkeypatch.setattr(conv_epilogue, "_launch", _emulated_launch)
    before = conv_epilogue.bias_act.launches
    spec, runs = _trained_against_present(name)
    _assert_same_training(runs)
    n_convs = len(graph.epilogue_plan(spec))
    assert conv_epilogue.bias_act.launches - before == n_convs
    assert tracer.drain()["counters"] == {graph.EPILOGUE_FUSED: n_convs}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_epilogue_counters_count_each_convolution_once_a_run(dtype, tracer):
    """On the CPU every convolution takes the plain path, once for every
    run of its layer on the host; the graph stages' split counts the
    same; with tracing off nothing is counted."""
    spec = graph.load_spec("mpi_15_4")
    net = _net(spec)
    image = _image(spec, (24, 40))
    n_convs = SPECS["mpi_15_4"][0]
    with torch.inference_mode():
        net(image, dtype)
        net(image, dtype, stage=lambda name: TRACE.span(name))
        assert tracer.drain()["counters"] == {graph.EPILOGUE_PLAIN:
                                              2 * n_convs}
        TRACE.disable()
        net(image, dtype)
    assert tracer.drain()["counters"] == {}
