"""The port's device rule (`openpose_tpu_torch/device.py`): every entry
point runs on the card unless the caller names a device.  On a machine
without a card, naming none raises `NoCudaDeviceError`; nothing carries on
on the CPU on its own.  With `device="cpu"` everything runs here.
"""

import numpy as np
import pytest
import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.face.extractor import FaceExtractor
from openpose_tpu_torch.hand.extractor import HandExtractor
from openpose_tpu_torch.models import graph, zoo
from openpose_tpu_torch.parallel.inference import (
    PoseInference, TopDownInference)
from openpose_tpu_torch.params import PoseModel
from openpose_tpu_torch.pose.extractor import PoseExtractor
from openpose_tpu_torch.runtime.topdown import TopDownExtractor
from openpose_tpu_torch.runtime.video_runner import VideoRunner
from openpose_tpu_torch.runtime.whole_body import WholeBodyInference
from openpose_tpu_torch.tracking import lk, person_id, pose_graph, tracker
from openpose_tpu_torch.wrapper import HandConfig, PoseConfig, Wrapper


@pytest.fixture(scope="module")
def pose_model():
    return zoo.load_pose_model(PoseModel.MPI_15_4, device="cpu")


@pytest.fixture(scope="module")
def hand_model():
    return zoo.load_hand_model(device="cpu")


@pytest.fixture
def no_card(monkeypatch):
    """What a machine without a card reports."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small_params():
    spec = graph.load_spec("hand_21")
    return spec, graph.init_params(spec, torch.Generator().manual_seed(0))


ENTRY_POINTS = {
    "load_pose_model": lambda pose, hand: zoo.load_pose_model(
        PoseModel.MPI_15_4),
    "load_face_model": lambda pose, hand: zoo.load_face_model(),
    "load_hand_model": lambda pose, hand: zoo.load_hand_model(),
    "from_params": lambda pose, hand: zoo.from_params(*_small_params()),
    "PoseExtractor": lambda pose, hand: PoseExtractor(pose),
    "PoseInference": lambda pose, hand: PoseInference(pose, net_hw=(64, 80)),
    "TopDownInference": lambda pose, hand: TopDownInference(hand, 64, 2),
    "TopDownExtractor": lambda pose, hand: TopDownExtractor(hand, 64),
    "WholeBodyInference": lambda pose, hand: WholeBodyInference(
        pose, None, hand, frame_hw=(96, 128), net_hw=(64, 80)),
    "FaceExtractor": lambda pose, hand: FaceExtractor(hand, 64),
    "HandExtractor": lambda pose, hand: HandExtractor(hand, 64),
    "Wrapper": lambda pose, hand: Wrapper(),
    "Wrapper_hand_only": lambda pose, hand: Wrapper(
        PoseConfig(enable=False), hand=HandConfig(enable=True)),
    "VideoRunner": lambda pose, hand: VideoRunner(
        PoseInference(pose, net_hw=(64, 80))),
    "pyramidal_lk": lambda pose, hand: lk.pyramidal_lk(
        np.zeros((40, 40), np.float32), np.zeros((40, 40), np.float32),
        np.zeros((1, 2), np.float32)),
    "PersonTracker": lambda pose, hand: tracker.PersonTracker(),
    "PersonIdExtractor": lambda pose, hand: person_id.PersonIdExtractor(),
    "KeyframeSmoother": lambda pose, hand: pose_graph.KeyframeSmoother(),
    "smooth_window": lambda pose, hand: pose_graph.smooth_window(
        np.zeros((3, 1, 2, 3), np.float32)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_given_asks_for_the_card(name, pose_model, hand_model,
                                           no_card):
    """Given no device, each entry point asks for "cuda": without a card it
    raises the helper's error, and the models it was handed stay where
    they were."""
    with pytest.raises(device_rule.NoCudaDeviceError, match='device="cpu"'):
        ENTRY_POINTS[name](pose_model, hand_model)
    assert pose_model.device.type == "cpu"
    assert hand_model.device.type == "cpu"


def test_default_device_is_the_current_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert device_rule.default_device() == torch.device("cuda", 0)
    assert device_rule.resolve(None) == torch.device("cuda", 0)
    assert device_rule.resolve("cpu") == torch.device("cpu")
    assert device_rule.resolve(torch.device("cuda", 1)) \
        == torch.device("cuda", 1)


def test_with_cpu_named_every_entry_point_runs(pose_model, hand_model,
                                               no_card):
    """`device="cpu"` runs here, from the loaders down to keypoints."""
    assert pose_model.device.type == hand_model.device.type == "cpu"
    assert zoo.from_params(*_small_params(), device="cpu").device.type == "cpu"
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 255, (1, 64, 80, 3)).astype(np.uint8)
    extractor = PoseExtractor(pose_model, max_peaks=8, device="cpu",
                              compute_dtype=torch.float32)
    pred = extractor.forward(frames[0], net_resolution=(80, 64))
    assert pred.peaks.shape == (15, 9, 3)
    inference = PoseInference(pose_model, net_hw=(64, 80), max_peaks=8,
                              nms_threshold=extractor.connect.nms_threshold,
                              device="cpu", compute_dtype=torch.float32)
    peaks, scores = inference(frames)
    assert peaks.device.type == scores.device.type == "cpu"
    np.testing.assert_array_equal(peaks[0].numpy(), pred.peaks)
    rect = (8.0, 8.0, 40.0, 40.0)
    left, right = HandExtractor(hand_model, 64, torch.float32,
                                device="cpu").forward(
        frames[0], [(rect, rect)])
    assert left.shape == right.shape == (1, 21, 3)
    face_model = zoo.load_face_model(device="cpu")
    assert FaceExtractor(face_model, 64, torch.float32,
                         device="cpu").forward(frames[0], [rect]).shape \
        == (1, 70, 3)
    whole = WholeBodyInference(pose_model, None, hand_model,
                               frame_hw=(64, 80), net_hw=(64, 80),
                               people_cap=2, max_peaks=8, hand_net_size=64,
                               device="cpu", compute_dtype=torch.float32)
    assert whole.device.type == whole.hand.device.type == "cpu"
    assert len(whole(frames)) == 1
    wrapper = Wrapper(PoseConfig(model=PoseModel.MPI_15_4, tracking=1,
                                 net_resolution=(80, 64),
                                 compute_dtype="float32"), device="cpu")
    assert wrapper.pose_extractor.device.type == "cpu"
    assert wrapper._pose_tracker.device.type == "cpu"
    for datum_id in range(2):       # a CNN frame, then an LK frame
        datum = wrapper.process(frames[0], datum_id=datum_id)
        assert datum.pose_keypoints.shape[1:] == (15, 3)
    runner = VideoRunner(inference, batch_size=1)
    results = list(runner._run_batches([(frames, np.ones(1), 1)],
                                       lambda index: (80, 64)))
    assert len(results) == 1 and results[0].index == 0
