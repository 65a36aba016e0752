"""The plain reference against the port at a small size on the CPU."""

import numpy as np
import pytest
import torch

from openpose_tpu_torch.models import caffe_proto, zoo
from openpose_tpu_torch.parallel.inference import (
    PoseInference, TopDownInference)
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
from perfbench import cells, check, inputs
from perfbench.reference import cnn, decode, topdown

CPU = torch.device("cpu")


def _model(spec_name, params, info=None):
    spec = caffe_proto.NetSpec.from_json(cnn.load_spec(spec_name))
    return zoo.from_params(spec, params, info, CPU)


@pytest.mark.parametrize("spec_name, hw", [("body_25", (64, 96)),
                                           ("hand_21", (64, 64))])
def test_reference_cnn_matches_the_port_in_float32(spec_name, hw):
    params = inputs.make_params(spec_name, 9, CPU)
    frames = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8)
    ours = cnn.forward(cnn.load_spec(spec_name), params, frames)
    model = _model(spec_name, params)
    with torch.backends.mkldnn.flags(enabled=False):
        theirs = model.net((frames.float() / 256.0) - 0.5, torch.float32)
        ours = cnn.forward(cnn.load_spec(spec_name), params, frames)
    err = (ours - theirs).norm() / theirs.norm()
    assert err < 1e-5


def test_reference_decode_matches_the_port():
    _, cfg, traffic = cells.load_cell("body25.video_b8")
    hw = tuple(cfg["net_hw"])
    people = inputs.batch_people(3, 0, 2, (4, 6), hw)
    maps = torch.from_numpy(inputs.rendered(cfg, people))
    params = inputs.make_params("body_25", 1, CPU)
    pi = PoseInference(_model("body_25", params,
                              POSE_MODEL_INFO[PoseModel.BODY_25]),
                       net_hw=hw, device=CPU)
    peaks, scores = pi.fetch(*pi.decode([maps]))
    want = decode.decode(maps, cfg)
    found = 0
    for i, (kp, s) in enumerate(want):
        got_kp, got_s = pi.assemble(peaks[i], scores[i])
        assert check.people_gap(got_kp, got_s, kp, s) < 1e-4
        found += len(kp)
    assert found >= people.shape[0]


def test_reference_topdown_matches_the_port_in_float32():
    params = inputs.make_params("hand_21", 4, CPU)
    frame = torch.randint(0, 256, (1, 96, 160, 3), dtype=torch.uint8)
    td = TopDownInference(_model("hand_21", params), net_size=64,
                          people_cap=2, device=CPU,
                          compute_dtype=torch.float32)
    rects = [((20.0, 10.0, 50.0, 50.0), True), ((90.0, 30.0, 40.0, 40.0),
                                                 False)]
    with torch.backends.mkldnn.flags(enabled=False):
        got = td.extract(frame, [rects], 21)[0]
        stage = topdown.Stage("hand_21", params, 64, lambda kp: rects, 21)
        ref = stage.run(frame, [np.zeros((1, 25, 3))], 2)[0]
    for slot in range(2):
        assert check._crop_gap(got[slot], ref[slot], 21) < 1e-4
        tr, _, peaks = ref[slot]
        want_x = tr[0] * peaks[:21, 0].numpy() + tr[2]
        np.testing.assert_allclose(got[slot][:, 0], want_x, atol=1e-3)
