"""One body decoder behind both pose paths (`pose/extractor.py::BodyDecoder`).

The per-frame `PoseExtractor` and the batched `PoseInference` decode and
assemble through the same `BodyDecoder`: the same injected net output
through `PoseInference(net_bypass=True)` and through
`PoseExtractor.forward(net_output=...)` gives equal keypoints and scores,
for every pose model, with and without `maximize_positives`.  The scene
holds a right leg with its foot and no torso: BODY_25's default assembly
drops such standalone legs, and `maximize_positives` keeps them, so the
batched path must take the flag's assembly and not only its thresholds.
Then `PoseInference`'s connect limits against `default_connect_params`,
the one net-to-output scale against the reference's formula, and the
serving paths' one call of NMS and of the assembly.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from openpose_tpu_torch import synthetic
from openpose_tpu_torch.models import zoo
from openpose_tpu_torch.ops import paf
from openpose_tpu_torch.parallel.inference import PoseInference
from openpose_tpu_torch.params import (
    POSE_MODEL_INFO, PoseModel, default_connect_params)
from openpose_tpu_torch.pose import scaler
from openpose_tpu_torch.pose.extractor import (
    PoseExtractor, net_to_output_scale)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NET_HW = (176, 320)
MODELS = (PoseModel.BODY_25, PoseModel.COCO_18, PoseModel.MPI_15,
          PoseModel.MPI_15_4)
# each model's parts as BODY_25 parts (MPI's chest is placed apart)
FROM_BODY25 = {
    "BODY_25": list(range(25)),
    "COCO_18": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                18],
    "MPI_15": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 8],
}
# BODY_25's right leg and foot: hip, knee, ankle, big toe, small toe, heel
RIGHT_LEG = [9, 10, 11, 22, 23, 24]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two threads per worker: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _scene(info) -> np.ndarray:
    """[1, h/8, w/8, C] net output of two whole people and, apart from
    them, a right leg with its foot and nothing above the hip (the other
    parts not visible): BODY_25 people projected onto the model's parts."""
    people = synthetic.random_people(np.random.RandomState(4), 3, NET_HW,
                                     height_range=(120.0, 160.0))
    people[2, [p for p in range(25) if p not in RIGHT_LEG], 2] = 0.0
    if info.name.startswith("MPI"):
        # the chest, halfway from the neck to the mid-hip
        people[:, 8, :2] = (people[:, 1, :2] + people[:, 8, :2]) / 2
    kp = people[:, FROM_BODY25[info.name.replace("_4", "")]][None]
    pairs, map_idx = paf.pair_tables(info)
    return synthetic.make_targets(kp, pairs, map_idx, NET_HW,
                                  info.num_parts, info.heatmap_channels)


@pytest.fixture(scope="module")
def models():
    return {m: zoo.load_pose_model(m, seed=0, device="cpu") for m in MODELS}


@pytest.mark.parametrize("flag", [False, True],
                         ids=["default", "maximize_positives"])
@pytest.mark.parametrize("pose_model", MODELS, ids=[m.value for m in MODELS])
def test_batched_and_per_frame_paths_agree(models, pose_model, flag):
    model = models[pose_model]
    info = POSE_MODEL_INFO[pose_model]
    maps = _scene(info)
    cp = default_connect_params(pose_model, flag)
    h, w = NET_HW
    pred = PoseExtractor(model, maximize_positives=flag,
                         compute_dtype=torch.float32, device="cpu").forward(
        np.zeros((h, w, 3), np.float32), net_resolution=(w, h),
        net_output=maps[0])
    inference = PoseInference(
        model, net_hw=NET_HW, device="cpu", net_bypass=True,
        nms_threshold=cp.nms_threshold, inter_threshold=cp.inter_threshold,
        inter_min_above_threshold=cp.inter_min_above_threshold,
        maximize_positives=flag)
    peaks, scores = inference.fetch(*inference(maps))
    keypoints, person_scores = inference.assemble(peaks[0], scores[0])
    assert np.array_equal(peaks[0], pred.peaks)
    assert keypoints.shape[0] >= 2, "the whole people must be found"
    np.testing.assert_array_equal(keypoints, pred.keypoints)
    np.testing.assert_array_equal(person_scores, pred.scores)
    if pose_model == PoseModel.BODY_25:
        # the standalone leg: a person with the right knee and no neck
        legs = [(kp[10, 2] > 0) and not (kp[1, 2] > 0) for kp in keypoints]
        assert any(legs) == flag, legs


@pytest.mark.parametrize("flag", [False, True],
                         ids=["default", "maximize_positives"])
def test_inference_connect_limits_follow_the_flag(models, flag):
    """The flag's limits and passes; the three thresholds given take the
    place of its own."""
    model = models[PoseModel.BODY_25]
    cp = default_connect_params(PoseModel.BODY_25, flag)
    given = PoseInference(
        model, net_hw=(64, 96), device="cpu",
        nms_threshold=cp.nms_threshold, inter_threshold=cp.inter_threshold,
        inter_min_above_threshold=cp.inter_min_above_threshold,
        maximize_positives=flag)
    assert given.decoder.connect == cp
    assert given.decoder.maximize_positives is flag
    own = PoseInference(model, net_hw=(64, 96), device="cpu",
                        nms_threshold=0.3, inter_threshold=0.2,
                        inter_min_above_threshold=0.5,
                        maximize_positives=flag)
    assert own.decoder.connect == dataclasses.replace(
        cp, nms_threshold=0.3, inter_threshold=0.2,
        inter_min_above_threshold=0.5)


@pytest.mark.parametrize("input_wh, net_resolution, scale_number", [
    ((80, 64), (80, 64), 1), ((1280, 720), (-1, 368), 1),
    ((200, 120), (-1, 128), 2), ((640, 480), (-1, 368), 4),
    ((1920, 1080), (1312, 736), 4)])
def test_net_to_output_scale_is_the_references(input_wh, net_resolution,
                                               scale_number):
    """poseExtractorCaffe.cpp:306-311: the input's size at the scale-0 net
    size, then the scale from it back to the input."""
    plan = scaler.extract_scales(input_wh, net_resolution, scale_number)
    s = scaler.resize_get_scale_factor(input_wh, plan.net_input_sizes[0])
    net_size = (int(s * input_wh[0] + 0.5), int(s * input_wh[1] + 0.5))
    assert net_to_output_scale(plan, input_wh) \
        == scaler.resize_get_scale_factor(net_size, input_wh)


def test_one_decode_body_on_the_serving_paths():
    """Under `pose/` and `parallel/`, NMS and the assembly are called
    once each, in `BodyDecoder`."""
    calls = {"nms.nms(": [], "connect_body_parts(": []}
    for folder in ("pose", "parallel"):
        for path in sorted((ROOT / "openpose_tpu_torch" / folder)
                           .glob("*.py")):
            text = path.read_text()
            for call in calls:
                calls[call] += [path.name] * len(
                    re.findall(re.escape(call), text))
    assert calls == {"nms.nms(": ["extractor.py"],
                     "connect_body_parts(": ["extractor.py"]}
