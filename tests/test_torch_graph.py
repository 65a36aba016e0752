"""Port CNN executor and weight bridge vs the JAX package (CPU, float32).

The same numpy weights and inputs go through `openpose_tpu.models.graph`
and `openpose_tpu_torch.models.graph`.  Tolerance rtol = atol = 1e-4: the
convolutions sum in another order in the two frameworks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openpose_tpu.models import caffe_proto, checkpoint as jcheckpoint
from openpose_tpu.models import graph as jgraph
from openpose_tpu.models.caffe_proto import LayerSpec, NetSpec
from openpose_tpu.params import POSE_MODEL_INFO, PoseModel
from openpose_tpu_torch.models import checkpoint, graph, zoo


def _small_spec() -> NetSpec:
    """conv -> ReLU -> ceil-mode pool -> conv -> PReLU -> concat with a 1x1
    branch -> padded pool -> conv: every layer type, narrow widths."""
    L = LayerSpec
    return NetSpec(name="small", input="image", input_channels=3, layers=[
        L("c1", "Convolution", ["image"], ["c1"], num_output=6, kernel=3, pad=1),
        L("r1", "ReLU", ["c1"], ["c1"]),
        L("p1", "Pooling", ["c1"], ["p1"], kernel=2, stride=2),
        L("c2", "Convolution", ["p1"], ["c2"], num_output=5, kernel=3, pad=1),
        L("pr2", "PReLU", ["c2"], ["c2"]),
        L("c3", "Convolution", ["p1"], ["c3"], num_output=4, kernel=1),
        L("cat", "Concat", ["c2", "c3"], ["cat"]),
        L("p2", "Pooling", ["cat"], ["p2"], kernel=3, stride=2, pad=1),
        L("c4", "Convolution", ["p2"], ["net_output"], num_output=7, kernel=3,
          stride=2, pad=1),
    ])


def _jax_params(spec, seed):
    """JAX He-normal weights with random biases and PReLU slopes, so the
    bias and slope paths carry signal."""
    params = jgraph.init_params(spec, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    out = {}
    for name, sub in params.items():
        out[name] = {k: np.asarray(v) for k, v in sub.items()}
        if "b" in out[name]:
            out[name]["b"] = rng.uniform(-0.1, 0.1, out[name]["b"].shape) \
                .astype(np.float32)
        if "slope" in out[name]:
            out[name]["slope"] = rng.uniform(0.0, 0.5,
                                             out[name]["slope"].shape) \
                .astype(np.float32)
    return out


def _forward_both(spec, params, image, jax_dtype=jnp.float32,
                  torch_dtype=torch.float32):
    want = np.asarray(jgraph.forward(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
         for k, v in params.items()}, spec, jnp.asarray(image), jax_dtype))
    model = zoo.from_params(spec, checkpoint.from_jax_params(params),
                            device="cpu")
    with torch.inference_mode():
        got = model.forward(torch.from_numpy(image), torch_dtype).numpy()
    return got, want


@pytest.mark.parametrize("hw", [(13, 11), (20, 34), (9, 16)])
def test_small_spec_matches_jax(hw):
    spec = _small_spec()
    params = _jax_params(spec, 0)
    image = np.random.RandomState(1).uniform(
        -0.5, 0.5, (2, *hw, 3)).astype(np.float32)
    got, want = _forward_both(spec, params, image)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_small_spec_bf16_close_to_jax():
    """bf16 compute: each side rounds activations to bf16 (8 bits of
    mantissa) at every layer, in slightly different places (the port rounds
    the conv sum before adding the bias); 4 conv layers of drift stay
    within 5e-2 of each other on O(1) outputs."""
    spec = _small_spec()
    params = _jax_params(spec, 2)
    image = np.random.RandomState(3).uniform(
        -0.5, 0.5, (1, 20, 34, 3)).astype(np.float32)
    got, want = _forward_both(spec, params, image, jnp.bfloat16,
                              torch.bfloat16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("name", ["BODY_25", "COCO_18", "MPI_15",
                                  "MPI_15_4"])
def test_body25_matches_jax(name):
    """Each bundled pose graph, whole, at a small input that is not a
    multiple of 16 (ceil-mode pools), with JAX weights through the bridge."""
    info = POSE_MODEL_INFO[PoseModel[name]]
    spec = jgraph.load_spec(info.spec)
    params = _jax_params(spec, 5)
    image = np.random.RandomState(6).uniform(
        -0.5, 0.5, (1, 36, 52, 3)).astype(np.float32)
    got, want = _forward_both(spec, params, image)
    assert got.shape == (1, 5, 7, info.heatmap_channels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_body25_bf16_close_to_jax():
    """BODY_25 in bfloat16 against JAX in bfloat16, and both against JAX in
    float32.  Each side rounds activations to bfloat16 at every one of ~100
    layers, and the port rounds the conv sum once more before the bias; a
    last-bit flip then propagates, so the two bf16 nets differ by a few bf16
    ulps of the output (0.031 on outputs up to 2.4 at this input, about as
    much as an emulation that rounds once).  Bound: the port's bf16 is no
    further from float32 than twice JAX's own bf16 error (1.34x measured),
    and within 0.1 of JAX's bf16."""
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    spec = jgraph.load_spec(info.spec)
    params = _jax_params(spec, 5)
    image = np.random.RandomState(6).uniform(
        -0.5, 0.5, (1, 36, 52, 3)).astype(np.float32)
    got, want = _forward_both(spec, params, image, jnp.bfloat16,
                              torch.bfloat16)
    want32 = np.asarray(jgraph.forward(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
         for k, v in params.items()}, spec, jnp.asarray(image), jnp.float32))
    assert got.dtype == np.float32 and got.shape == want.shape
    jax_err = np.abs(want - want32).max()
    assert np.abs(got - want32).max() <= 2.0 * jax_err
    np.testing.assert_allclose(got, want, rtol=0, atol=0.1)


def test_load_spec_reads_the_jax_specs():
    for name in ("body_25", "coco_18", "mpi_15", "face_70"):
        # the port's own copies of the files, parsed by its own NetSpec
        assert graph.load_spec(name).to_json() \
            == jgraph.load_spec(name).to_json()


def test_init_params_shapes_match_jax():
    spec = graph.load_spec("body_25")
    want = jgraph.init_params(spec, jax.random.PRNGKey(0))
    got = graph.init_params(spec, torch.Generator().manual_seed(0))
    assert got.keys() == want.keys()
    for name, sub in want.items():
        for key, val in sub.items():
            shape = val.shape
            if key == "w":   # HWIO -> OIHW
                shape = (shape[3], shape[2], shape[0], shape[1])
            assert tuple(got[name][key].shape) == tuple(shape), (name, key)
    w = got["conv1_1"]["w"]
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) - np.sqrt(2.0 / fan_in)) < 0.1 * np.sqrt(2.0 / fan_in)


def test_npz_roundtrip(tmp_path):
    """An .npz written by the JAX package's checkpoint.save loads through
    load_npz into the same tensors as the in-memory bridge."""
    spec = _small_spec()
    params = _jax_params(spec, 7)
    path = str(tmp_path / "w.npz")
    jcheckpoint.save(path, params)
    got = checkpoint.load_npz(path)
    want = checkpoint.from_jax_params(params)
    assert got.keys() == want.keys()
    for name in want:
        for key in want[name]:
            assert torch.equal(got[name][key], want[name][key])
    np.testing.assert_array_equal(
        got["c1"]["w"].numpy(), params["c1"]["w"].transpose(3, 2, 0, 1))


def test_convert_caffe_blobs_matches_jax():
    spec = _small_spec()
    rng = np.random.RandomState(8)
    layers = {}
    for layer in spec.layers:
        if layer.type == "Convolution":
            c_in = {"c1": 3, "c2": 6, "c3": 6, "c4": 9}[layer.name]
            layers[layer.name] = [
                rng.randn(layer.num_output, c_in, layer.kernel,
                          layer.kernel).astype(np.float32),
                rng.randn(layer.num_output).astype(np.float32)]
        elif layer.type == "PReLU":
            layers[layer.name] = [rng.rand(5).astype(np.float32)]
    blobs = caffe_proto.parse_caffemodel(caffe_proto.serialize_caffemodel(layers))
    want = jgraph.convert_caffe_blobs(spec, blobs)
    got = graph.convert_caffe_blobs(spec, blobs)
    for name, sub in want.items():
        for key, val in sub.items():
            val = np.asarray(val)
            if key == "w":
                val = val.transpose(3, 2, 0, 1)
            np.testing.assert_array_equal(got[name][key].numpy(), val)


def test_rejects_other_compute_dtypes():
    model = zoo.from_params(_small_spec(), checkpoint.from_jax_params(
        _jax_params(_small_spec(), 0)), device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        model.forward(torch.zeros(1, 8, 8, 3), torch.float16)


def test_weights_of_any_origin_get_one_layout():
    """A 1x1 conv's weight from the JAX bridge (an HWIO transpose) and from
    contiguous OIHW tensors ends up with the same strides in a `PoseNet`,
    so cuDNN sees one descriptor; a trainer's serving view keeps its
    storage and the outputs are equal."""
    spec = _small_spec()
    params = checkpoint.from_jax_params(_jax_params(spec, 3))
    contiguous = {name: {k: v.contiguous() for k, v in sub.items()}
                  for name, sub in params.items()}
    assert params["c3"]["w"].stride() != contiguous["c3"]["w"].stride()
    bridged = graph.PoseNet(spec, params)
    trainer = graph.PoseNet(spec, contiguous, trainable=True)
    view = trainer.serving_view()
    for name, w in bridged.weights.items():
        assert w.stride() == trainer.weights[name].stride(), name
        assert view.weights[name].data_ptr() == trainer.weights[name].data_ptr()
    image = torch.from_numpy(
        np.random.RandomState(4).rand(2, 12, 10, 3).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(bridged(image), view(image))
