"""Caffe model-format readers: deploy.prototxt topology + .caffemodel weights.

This lets users of the original OpenPose bring their own trained models: the
prototxt gives the layer graph (only Convolution / ReLU / PReLU / Pooling /
Concat occur in the OpenPose model zoo — see e.g. reference
models/pose/body_25/pose_deploy.prototxt), and the caffemodel gives weights.

The caffemodel reader is a minimal protobuf *wire-format* walker — no protobuf
runtime or caffe.proto needed.  It understands both the old V1LayerParameter
encoding (NetParameter.layers = field 2, CMU's published models) and the newer
LayerParameter encoding (NetParameter.layer = field 100).

The port's own copy of `openpose_tpu/models/caffe_proto.py` (host code, no framework):
the port imports nothing of the JAX package, and
`tests/test_torch_standalone.py` holds the two copies to each other.
"""

from __future__ import annotations

import dataclasses
import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------- #
# prototxt (text format) topology parsing
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class LayerSpec:
    """One layer of the (flattened) Caffe graph."""

    name: str
    type: str                      # Convolution | ReLU | PReLU | Pooling | Concat
    bottoms: List[str]
    tops: List[str]
    # Convolution / Pooling params
    num_output: int = 0
    kernel: int = 0
    stride: int = 1
    pad: int = 0

    def to_json(self) -> dict:
        d = {"name": self.name, "type": self.type,
             "bottoms": self.bottoms, "tops": self.tops}
        if self.type == "Convolution":
            d.update(num_output=self.num_output, kernel=self.kernel,
                     stride=self.stride, pad=self.pad)
        elif self.type == "Pooling":
            d.update(kernel=self.kernel, stride=self.stride, pad=self.pad)
        return d

    @staticmethod
    def from_json(d: dict) -> "LayerSpec":
        return LayerSpec(
            name=d["name"], type=d["type"], bottoms=list(d["bottoms"]),
            tops=list(d["tops"]), num_output=d.get("num_output", 0),
            kernel=d.get("kernel", 0), stride=d.get("stride", 1),
            pad=d.get("pad", 0))


@dataclasses.dataclass
class NetSpec:
    """Topology of a whole net: ordered layers + graph input name."""

    name: str
    input: str
    input_channels: int
    layers: List[LayerSpec]
    output: str = "net_output"

    def to_json(self) -> dict:
        return {"name": self.name, "input": self.input,
                "input_channels": self.input_channels, "output": self.output,
                "layers": [l.to_json() for l in self.layers]}

    @staticmethod
    def from_json(d: dict) -> "NetSpec":
        return NetSpec(
            name=d["name"], input=d["input"],
            input_channels=d["input_channels"], output=d.get("output", "net_output"),
            layers=[LayerSpec.from_json(x) for x in d["layers"]])


def parse_prototxt(text: str) -> NetSpec:
    """Parse a Caffe deploy prototxt into a NetSpec (subset of Caffe grammar)."""
    name_m = re.search(r'^name:\s*"([^"]*)"', text, re.M)
    input_m = re.search(r'^input:\s*"([^"]*)"', text, re.M)
    dims = re.findall(r'^input_dim:\s*(\d+)', text, re.M)
    in_channels = int(dims[1]) if len(dims) >= 2 else 3

    layers: List[LayerSpec] = []
    idx = 0
    while True:
        m = re.search(r'layer\s*\{', text[idx:])
        if m is None:
            break
        start = idx + m.end()
        depth, j = 1, start
        while depth > 0:
            ch = text[j]
            if ch == '{':
                depth += 1
            elif ch == '}':
                depth -= 1
            j += 1
        body = text[start:j - 1]
        idx = j

        def scalar(key: str, default=None):
            mm = re.search(key + r':\s*"?([\w.\-]+)"?', body)
            return mm.group(1) if mm else default

        ltype = scalar("type")
        layer = LayerSpec(
            name=scalar("name"), type=ltype,
            bottoms=re.findall(r'bottom:\s*"([^"]*)"', body),
            tops=re.findall(r'top:\s*"([^"]*)"', body))
        if ltype == "Convolution":
            layer.num_output = int(scalar("num_output"))
            layer.kernel = int(scalar("kernel_size"))
            layer.stride = int(scalar("stride", 1))
            layer.pad = int(scalar("pad", 0))
        elif ltype == "Pooling":
            layer.kernel = int(scalar("kernel_size"))
            layer.stride = int(scalar("stride", 1))
            layer.pad = int(scalar("pad", 0))
        layers.append(layer)

    return NetSpec(
        name=name_m.group(1) if name_m else "",
        input=input_m.group(1) if input_m else "image",
        input_channels=in_channels, layers=layers)


# --------------------------------------------------------------------------- #
# caffemodel (binary protobuf) weight parsing
# --------------------------------------------------------------------------- #

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a protobuf message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _WT_I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == _WT_I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:  # pragma: no cover - groups unused by caffe
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_blob(buf: memoryview) -> np.ndarray:
    """BlobProto: data=5 (packed/repeated float), shape=7 (BlobShape.dim=1),
    legacy dims num=1 channels=2 height=3 width=4."""
    shape: List[int] = []
    legacy = [0, 0, 0, 0]
    data_chunks: List[np.ndarray] = []
    for field, wt, val in _iter_fields(buf):
        if field == 5:  # data
            if wt == _WT_LEN:
                data_chunks.append(np.frombuffer(bytes(val), dtype="<f4"))
            else:  # non-packed single float
                data_chunks.append(np.frombuffer(bytes(val), dtype="<f4"))
        elif field == 7 and wt == _WT_LEN:  # shape: BlobShape {repeated int64 dim=1}
            dims = []
            for f2, wt2, v2 in _iter_fields(val):
                if f2 == 1:
                    if wt2 == _WT_LEN:  # packed
                        p = 0
                        mv = memoryview(v2)
                        while p < len(mv):
                            d, p = _read_varint(mv, p)
                            dims.append(d)
                    else:
                        dims.append(v2)
            shape = dims
        elif field in (1, 2, 3, 4) and wt == _WT_VARINT:
            legacy[field - 1] = val
    data = np.concatenate(data_chunks) if data_chunks else np.zeros((0,), np.float32)
    if not shape:
        if any(legacy):
            shape = [d for d in legacy]
        else:
            shape = [data.size]
    return data.reshape(shape)


def _parse_layer(buf: memoryview, v1: bool) -> Tuple[str, List[np.ndarray]]:
    """[V1]LayerParameter: name=1, blobs=7 (new) / blobs=6 (V1)."""
    blob_field = 6 if v1 else 7
    name = ""
    blobs: List[np.ndarray] = []
    for field, wt, val in _iter_fields(buf):
        if field == 1 and wt == _WT_LEN:
            name = bytes(val).decode("utf-8", "replace")
        elif field == blob_field and wt == _WT_LEN:
            blobs.append(_parse_blob(val))
    return name, blobs


def parse_caffemodel(data: bytes) -> Dict[str, List[np.ndarray]]:
    """Parse a .caffemodel into {layer_name: [blob0 (weights), blob1 (bias), ...]}.

    Convolution blobs come out in Caffe's OIHW layout; PReLU slope blobs are 1-D.
    """
    mv = memoryview(data)
    out: Dict[str, List[np.ndarray]] = {}
    for field, wt, val in _iter_fields(mv):
        if wt != _WT_LEN:
            continue
        if field == 2:      # V1LayerParameter 'layers'
            name, blobs = _parse_layer(val, v1=True)
        elif field == 100:  # LayerParameter 'layer'
            name, blobs = _parse_layer(val, v1=False)
        else:
            continue
        if name and blobs:
            out[name] = blobs
    return out


def serialize_caffemodel(layers: Dict[str, Sequence[np.ndarray]]) -> bytes:
    """Minimal caffemodel writer (LayerParameter encoding) — used by tests to
    round-trip the reader without a real CMU model download."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                out += bytes([b7])
                return out

    def len_field(field: int, payload: bytes) -> bytes:
        return varint((field << 3) | _WT_LEN) + varint(len(payload)) + payload

    def varint_field(field: int, v: int) -> bytes:
        return varint((field << 3) | _WT_VARINT) + varint(v)

    msg = b""
    for name, blobs in layers.items():
        layer_payload = len_field(1, name.encode())
        layer_payload += len_field(2, b"Convolution")
        for blob in blobs:
            blob = np.asarray(blob, np.float32)
            shape_payload = b"".join(varint_field(1, int(d)) for d in blob.shape)
            blob_payload = len_field(7, shape_payload)
            blob_payload += len_field(5, blob.astype("<f4").tobytes())
            layer_payload += len_field(7, blob_payload)
        msg += len_field(100, layer_payload)
    return msg
