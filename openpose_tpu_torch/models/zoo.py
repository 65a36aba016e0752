"""Model registry: the pose, face and hand nets with seeded random or
caffemodel weights.

Counterpart of `openpose_tpu/models/zoo.py`.  A model is
its `NetSpec`, a `graph.PoseNet` holding the weights on a device, and its
`PoseModelInfo`.  Random weights come from a seeded `torch.Generator`; they
are not the JAX package's random weights (the two generators differ), so
tests that compare the packages pass JAX weights through
`checkpoint.from_jax_params`.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional, Union

import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.models import caffe_proto, checkpoint, graph
from openpose_tpu_torch.params import (
    POSE_MODEL_INFO, PoseModel, PoseModelInfo)


@dataclasses.dataclass
class Model:
    spec: caffe_proto.NetSpec
    net: graph.PoseNet
    info: Optional[PoseModelInfo] = None

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def forward(self, image: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.net(image, compute_dtype)


def from_params(spec: caffe_proto.NetSpec, params: graph.Params,
                info: Optional[PoseModelInfo] = None,
                device: Union[str, torch.device, None] = None) -> Model:
    """A model on `device`: the card when none is given (`device.resolve`)."""
    return Model(spec=spec, net=graph.PoseNet(spec, params).to(
        device_rule.resolve(device)), info=info)


# Conventional model-folder layout of the reference (getPoseTrainedModel /
# getFaceModel etc., src/openpose/pose/poseParameters.cpp:394-408): relative
# caffemodel paths under `--model_folder`.
CAFFEMODEL_PATHS = {
    PoseModel.BODY_25: "pose/body_25/pose_iter_584000.caffemodel",
    PoseModel.COCO_18: "pose/coco/pose_iter_440000.caffemodel",
    PoseModel.MPI_15: "pose/mpi/pose_iter_160000.caffemodel",
    PoseModel.MPI_15_4: "pose/mpi/pose_iter_160000.caffemodel",
}
FACE_CAFFEMODEL_PATH = "face/pose_iter_116000.caffemodel"
HAND_CAFFEMODEL_PATH = "hand/pose_iter_102000.caffemodel"


def resolve_caffemodel(caffemodel: Optional[str],
                       model_folder: Optional[str],
                       relative: str) -> Optional[str]:
    """Explicit `--caffemodel_path` wins; else look in the conventional
    `--model_folder` layout; else None (random init).  An explicit path
    that ends in `.npz` names a trainer's checkpoint (`checkpoint.save`, or
    the JAX package's): the way a trained net reaches `Wrapper`."""
    if caffemodel:
        return caffemodel
    if model_folder:
        candidate = pathlib.Path(model_folder) / relative
        if candidate.exists():
            return str(candidate)
    return None


def _load(spec_name: str, seed: int,
          device: Union[str, torch.device, None],
          caffemodel: Optional[str],
          info: Optional[PoseModelInfo] = None,
          prototxt: Optional[str] = None) -> Model:
    device = device_rule.resolve(device)     # before any weights are made
    if prototxt is not None:
        spec = caffe_proto.parse_prototxt(pathlib.Path(prototxt).read_text())
    else:
        spec = graph.load_spec(spec_name)
    if caffemodel is not None and caffemodel.endswith(".npz"):
        params = checkpoint.load_npz(caffemodel)    # a trainer's checkpoint
    elif caffemodel is not None:
        blobs = caffe_proto.parse_caffemodel(
            pathlib.Path(caffemodel).read_bytes())
        params = graph.convert_caffe_blobs(spec, blobs)
    else:
        params = graph.init_params(spec, torch.Generator().manual_seed(seed))
    return from_params(spec, params, info, device)


def load_pose_model(model: PoseModel = PoseModel.BODY_25, seed: int = 0,
                    device: Union[str, torch.device, None] = None,
                    caffemodel: Optional[str] = None,
                    model_folder: Optional[str] = None,
                    prototxt: Optional[str] = None) -> Model:
    """He-normal weights from `torch.Generator().manual_seed(seed)`, or the
    weights of a Caffe `.caffemodel` when one is given or found under
    `model_folder` (`resolve_caffemodel`); prototxt: a deploy prototxt that
    replaces the bundled topology.  On the card unless `device` says
    otherwise, as every loader here."""
    if model.experimental:
        raise ValueError(f"PoseModel.{model.name} has no bundled topology")
    info = POSE_MODEL_INFO[model]
    caffemodel = resolve_caffemodel(caffemodel, model_folder,
                                    CAFFEMODEL_PATHS.get(model, ""))
    return _load(info.spec, seed, device, caffemodel, info, prototxt)


def load_face_model(seed: int = 1,
                    device: Union[str, torch.device, None] = None,
                    caffemodel: Optional[str] = None,
                    model_folder: Optional[str] = None) -> Model:
    """The 70-keypoint face net (`face_70.json`); the JAX package's seed."""
    return _load("face_70", seed, device, resolve_caffemodel(
        caffemodel, model_folder, FACE_CAFFEMODEL_PATH))


def load_hand_model(seed: int = 2,
                    device: Union[str, torch.device, None] = None,
                    caffemodel: Optional[str] = None,
                    model_folder: Optional[str] = None) -> Model:
    """The 21-keypoint hand net (`hand_21.json`); the JAX package's seed."""
    return _load("hand_21", seed, device, resolve_caffemodel(
        caffemodel, model_folder, HAND_CAFFEMODEL_PATH))
