"""PyTorch executor for the OpenPose CNN graphs (VGG trunk + CPM/PAF stages).

Counterpart of `openpose_tpu/models/graph.py`.  A `NetSpec` (the same JSON
topology files) runs as an `nn.Module` over a dict of activations:

* Parameters are OIHW (PyTorch's layout, also Caffe's); the JAX package keeps
  HWIO.  `checkpoint.from_jax_params` converts between the two.
* `forward` takes and returns NHWC like `graph.forward`; inside, activations
  are NCHW views of channels-last memory, which is what cuDNN's tensor-core
  convolutions want.
* Compute dtype is float32 or bfloat16.  In bfloat16 the convolution
  accumulates in float32 and rounds its sum to bfloat16; the float32 bias is
  then added and the result rounded again.  JAX rounds once, after the bias:
  `F.conv2d` cannot return a float32 sum of bfloat16 operands, and handing
  it the bias does not help (on CUDA it adds a bfloat16 bias after the
  convolution).  The extra rounding is within the drift that summation
  order alone causes (tests/test_torch_graph.py, BODY_25 in bfloat16).
  The bias add, its rounding and the activation that directly follows the
  convolution in place (`epilogue_plan`) are one step,
  `ops/conv_epilogue.py::bias_act`: on a card one hand-written kernel a
  convolution, bit-equal to the PyTorch operations it replaces, which run
  on the CPU; under a trainer's autograd the kernel's backward is those
  operations' own, so the gradients are bit-equal too.  Each convolution
  counts `cnn.epilogue.fused` or
  `cnn.epilogue.plain` in the tracer when its layer runs on the host (an
  eager call or a CUDA graph's capture; a replay counts nothing).
  float32 convolutions run with cuDNN's TF32 switched off, set as a context
  around the forward pass, not as a global side effect.
* Serving nets hold parameters that take no gradient.  A trainer builds
  `PoseNet(spec, params, trainable=True)`, calls it outside
  `torch.inference_mode()` and wraps forward and backward in
  `full_f32_convs()` (the backward pass runs after `forward` has left its
  own context); `serving_view()` gives a serving net over the same storage.
* A weight may be a DTensor holding this rank's shard of a model-sharded
  net (`parallel/mesh.py::shard_params`); `param` gathers it at use and
  its gradient comes back as the rank's shard.
* Caffe pooling uses ceil-mode output sizes with -inf padding at the bottom
  and right, written out explicitly (PyTorch's ceil_mode drops a last window
  that starts in the padding; Caffe's output size keeps it).
* A net is its trunk (the VGG layers up to the features every CPM stage
  reads, `trunk_end`) and its CPM stages.  Given a `stage` callable
  (`parallel/graphs.py`), `forward` runs the two parts inside
  `stage(TRUNK)` and `stage(STAGES)`: the tracer's spans when eager, one
  CUDA graph each when captured.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import pathlib
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from openpose_tpu_torch.models.caffe_proto import LayerSpec, NetSpec
from openpose_tpu_torch.ops import conv_epilogue
from openpose_tpu_torch.utils.profiler import TRACE

Params = Dict[str, Dict[str, torch.Tensor]]

_SPEC_DIR = pathlib.Path(__file__).resolve().parent / "specs"

# the spans (and graph stages) of a forward's two parts
TRUNK, STAGES = "pose.net.trunk", "pose.net.stages"
# the counters of the convolutions' epilogues: the kernel, or PyTorch's ops
EPILOGUE_FUSED, EPILOGUE_PLAIN = "cnn.epilogue.fused", "cnn.epilogue.plain"


@functools.lru_cache(maxsize=None)
def load_spec(name: str) -> NetSpec:
    """Load a bundled topology spec (`models/specs/*.json`, the port's own
    copies of the JAX package's files)."""
    with open(_SPEC_DIR / f"{name}.json") as f:
        return NetSpec.from_json(json.load(f))


def channels(spec: NetSpec) -> Dict[str, int]:
    """The channel count of every blob of a spec, the input's included."""
    out: Dict[str, int] = {spec.input: spec.input_channels}
    for layer in spec.layers:
        if layer.type == "Convolution":
            c = layer.num_output
        elif layer.type == "Concat":
            c = sum(out[b] for b in layer.bottoms)
        else:  # ReLU / PReLU / Pooling keep channels
            c = out[layer.bottoms[0]]
        for top in layer.tops:
            out[top] = c
    return out


def init_params(spec: NetSpec, generator: torch.Generator) -> Params:
    """He-normal initialization for every learnable layer (OIHW weights)."""
    params: Params = {}
    blob_channels = channels(spec)
    for layer in spec.layers:
        if layer.type == "Convolution":
            c_in = blob_channels[layer.bottoms[0]]
            fan_in = layer.kernel * layer.kernel * c_in
            w = torch.randn((layer.num_output, c_in, layer.kernel, layer.kernel),
                            generator=generator)
            params[layer.name] = {"w": w * float(np.sqrt(2.0 / fan_in)),
                                  "b": torch.zeros(layer.num_output)}
        elif layer.type == "PReLU":
            c = blob_channels[layer.bottoms[0]]
            params[layer.name] = {"slope": torch.full((c,), 0.25)}
    return params


def convert_caffe_blobs(spec: NetSpec, blobs: Dict[str, list]) -> Params:
    """`caffe_proto.parse_caffemodel()` output -> OIHW params (float32).

    Caffe's conv blobs are already OIHW; bias is 1-D; the PReLU slope is
    per-channel, stored under the PReLU layer's name."""
    params: Params = {}
    for layer in spec.layers:
        if layer.type == "Convolution":
            lb = blobs[layer.name]
            w = np.asarray(lb[0], np.float32)
            if w.ndim != 4:
                w = w.reshape(layer.num_output, -1, layer.kernel, layer.kernel)
            b = (np.asarray(lb[1], np.float32).reshape(-1) if len(lb) > 1
                 else np.zeros(layer.num_output, np.float32))
            params[layer.name] = {"w": torch.from_numpy(w.copy()),
                                  "b": torch.from_numpy(b.copy())}
        elif layer.type == "PReLU":
            slope = np.asarray(blobs[layer.name][0], np.float32).reshape(-1)
            params[layer.name] = {"slope": torch.from_numpy(slope.copy())}
    return params


def _max_pool(x: torch.Tensor, layer: LayerSpec) -> torch.Tensor:
    k, s, p = layer.kernel, layer.stride, layer.pad
    h, w = x.shape[2], x.shape[3]
    # Caffe ceil-mode output: ceil((dim + 2p - k)/s) + 1
    out_h = -(-(h + 2 * p - k) // s) + 1
    out_w = -(-(w + 2 * p - k) // s) + 1
    pad_h = s * (out_h - 1) + k - h
    pad_w = s * (out_w - 1) + k - w
    if pad_h or pad_w:
        x = F.pad(x, (p, pad_w - p, p, pad_h - p), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def count_flops(spec: NetSpec, hw: Tuple[int, int], in_channels: int = 3
                ) -> Dict[str, int]:
    """Per-layer FLOPs (2 per multiply-add) for one image at input (H, W),
    shapes propagated as `PoseNet` does (Caffe ceil-mode pooling).  Returns
    {layer_name: flops}; sum the values for the per-image total."""
    shapes: Dict[str, Tuple[int, int, int]] = {
        spec.input: (hw[0], hw[1], in_channels)}
    flops: Dict[str, int] = {}
    for layer in spec.layers:
        h, w, c = shapes[layer.bottoms[0]]
        if layer.type == "Convolution":
            k, s, p = layer.kernel, layer.stride, layer.pad
            oh = (h + 2 * p - k) // s + 1
            ow = (w + 2 * p - k) // s + 1
            out = (oh, ow, layer.num_output)
            flops[layer.name] = 2 * k * k * c * layer.num_output * oh * ow
        elif layer.type == "Pooling":
            k, s, p = layer.kernel, layer.stride, layer.pad
            oh = -(-(h + 2 * p - k) // s) + 1
            ow = -(-(w + 2 * p - k) // s) + 1
            out = (oh, ow, c)
            flops[layer.name] = k * k * c * oh * ow
        elif layer.type in ("ReLU", "PReLU"):
            out = (h, w, c)
            flops[layer.name] = h * w * c
        elif layer.type == "Concat":
            out = (h, w, sum(shapes[b][2] for b in layer.bottoms))
            flops[layer.name] = 0
        else:
            raise ValueError(f"unsupported layer type: {layer.type}")
        for top in layer.tops:
            shapes[top] = out
    return flops


def trunk_end(spec: NetSpec) -> int:
    """The number of layers in the net's trunk: those up to the last that
    writes the features every CPM stage reads, the blob most Concat
    layers read (`conv4_4_CPM` in the body nets, `conv5_3_CPM` in the face
    and hand nets)."""
    reads = collections.Counter(b for layer in spec.layers
                                if layer.type == "Concat"
                                for b in layer.bottoms)
    if not reads:
        raise ValueError(f"net {spec.name!r} has no CPM stages to split off")
    features = reads.most_common(1)[0][0]
    return 1 + max(i for i, layer in enumerate(spec.layers)
                   if features in layer.tops)


def split_flops(spec: NetSpec, hw: Tuple[int, int], in_channels: int = 3
                ) -> Tuple[int, int]:
    """(trunk, CPM stages) FLOPs of one image at input (H, W), split
    where `forward` splits the net."""
    flops = count_flops(spec, hw, in_channels)
    trunk = sum(flops[layer.name] for layer in spec.layers[:trunk_end(spec)])
    return trunk, sum(flops.values()) - trunk


def epilogue_plan(spec: NetSpec) -> Dict[str, Tuple[str, Optional[str]]]:
    """{convolution: (activation, its layer)} for every convolution of the
    spec: ("relu" | "prelu", name) where a ReLU or PReLU layer directly
    follows the convolution and rewrites its one top in place, so that no
    other layer sees the blob before the activation; else ("none", None),
    and any activation runs as its own layer."""
    plan: Dict[str, Tuple[str, Optional[str]]] = {}
    layers = spec.layers
    for conv, after in zip(layers, [*layers[1:], None]):
        if conv.type != "Convolution":
            continue
        folds = (after is not None and after.type in ("ReLU", "PReLU")
                 and len(conv.tops) == 1 and after.bottoms == conv.tops
                 and after.tops == conv.tops)
        plan[conv.name] = ((after.type.lower(), after.name) if folds
                           else ("none", None))
    return plan


def _no_stage(name: str):
    return contextlib.nullcontext()


@contextlib.contextmanager
def full_f32_convs():
    """float32 convolutions without TF32 inside the block, forward and
    backward; the process-wide cuDNN flags are as before after it."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


class PoseNet(nn.Module):
    """A `NetSpec` as an `nn.Module`: image NHWC -> net output NHWC float32.

    trainable: the parameters take gradients (a trainer's net); a serving
    net's do not, whatever mode its caller runs it in."""

    def __init__(self, spec: NetSpec, params: Params,
                 trainable: bool = False):
        super().__init__()
        self.spec = spec
        self.epilogues = epilogue_plan(spec)
        # the activation layers that a forward in another dtype than float32
        # (bf16; float64 in a gradient check) runs inside their convolution
        self._folded = {act for _, act in self.epilogues.values() if act}
        self.weights = nn.ParameterDict()
        for layer in spec.layers:
            if layer.type not in ("Convolution", "PReLU"):
                continue
            for key, val in params[layer.name].items():
                val = val.to(torch.float32)
                # conv weights in the activations' layout (a shard keeps
                # the layout of the weight it was cut from), with one
                # stride for a dim of size 1 too: a 1x1 conv's weight from
                # a file and from a trainer then give cuDNN one descriptor,
                # so both nets run the same algorithms
                if val.ndim == 4 and not isinstance(val, DTensor):
                    val = val.contiguous(memory_format=torch.channels_last)
                    val = val.as_strided(val.shape, torch.empty(
                        val.shape, device="meta",
                        memory_format=torch.channels_last).stride())
                self.weights[f"{layer.name}__{key}"] = nn.Parameter(
                    val, requires_grad=trainable)

    def param(self, layer: str, key: str) -> torch.Tensor:
        p = self.weights[f"{layer}__{key}"]
        return p.full_tensor() if isinstance(p, DTensor) else p

    def params(self) -> Params:
        """`{layer: {"w" | "b" | "slope": tensor}}` over the net's own
        storage, detached (logical OIHW order, whatever the memory's)."""
        out: Params = {}
        for name, val in self.weights.items():
            layer, key = name.rsplit("__", 1)
            out.setdefault(layer, {})[key] = val.detach()
        return out

    def serving_view(self) -> "PoseNet":
        """A net for serving over this net's parameter storage: nothing is
        copied, nothing takes a gradient, and a later optimizer step on
        this net shows in it."""
        return PoseNet(self.spec, self.params())

    def forward(self, image: Union[torch.Tensor, Callable[[], torch.Tensor]],
                compute_dtype: torch.dtype = torch.float32,
                stage: Optional[Callable] = None) -> torch.Tensor:
        """image [N, H, W, C_in] (BGR, normalized) -> [N, H/8, W/8, C] f32.

        stage: `GraphCache`'s stage callable (`parallel/graphs.py`); given,
        the trunk's layers run inside `stage(TRUNK)` and the CPM stages'
        inside `stage(STAGES)`.  image may be a function that makes the
        input; it is called first thing in the trunk's stage, so that the
        input's device work joins the trunk's graph."""
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        with full_f32_convs():
            return self._run(image, compute_dtype, stage)

    def _run(self, image, dtype: torch.dtype, stage) -> torch.Tensor:
        layers = self.spec.layers
        end = len(layers) if stage is None else trunk_end(self.spec)
        stage = stage or _no_stage
        with stage(TRUNK):
            if callable(image):
                image = image()
            # NHWC memory seen as NCHW: a channels-last tensor
            acts = {self.spec.input: image.permute(0, 3, 1, 2).to(dtype)}
            self._layers(acts, layers[:end], dtype)
        with stage(STAGES):
            self._layers(acts, layers[end:], dtype)
            return acts[self.spec.output].permute(0, 2, 3, 1).to(
                torch.float32)

    def _layers(self, acts: Dict[str, torch.Tensor], layers,
                dtype: torch.dtype) -> None:
        for layer in layers:
            x = acts[layer.bottoms[0]]
            if layer.type == "Convolution":
                out = self._conv(x, layer, dtype)
            elif layer.type in ("ReLU", "PReLU"):
                if dtype != torch.float32 and layer.name in self._folded:
                    continue        # its convolution's epilogue applied it
                out = conv_epilogue.activate(
                    x, layer.type.lower(), self.param(layer.name, "slope")
                    if layer.type == "PReLU" else None)
            elif layer.type == "Pooling":
                out = _max_pool(x, layer)
            elif layer.type == "Concat":
                out = torch.cat([acts[b] for b in layer.bottoms], dim=1)
            else:
                raise ValueError(f"unsupported layer type: {layer.type}")
            for top in layer.tops:
                acts[top] = out

    def _conv(self, x: torch.Tensor, layer: LayerSpec,
              dtype: torch.dtype) -> torch.Tensor:
        w = self.param(layer.name, "w").to(dtype)
        b = self.param(layer.name, "b")
        if dtype == torch.float32:
            TRACE.count(EPILOGUE_PLAIN)
            return F.conv2d(x, w, b, layer.stride, layer.pad)
        out = F.conv2d(x, w, None, layer.stride, layer.pad)
        kind, act = self.epilogues[layer.name]
        TRACE.count(EPILOGUE_FUSED if conv_epilogue.fuses(out)
                    else EPILOGUE_PLAIN)
        return conv_epilogue.bias_act(
            out, b, kind, self.param(act, "slope") if kind == "prelu"
            else None)
