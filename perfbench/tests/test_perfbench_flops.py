"""The yardstick's FLOP count is the port's `graph.count_flops`."""

import pytest

from openpose_tpu_torch.models import graph
from perfbench import flops


@pytest.mark.parametrize("spec, hw, gflop", [
    ("body_25", (368, 656), 287.4), ("face_70", (368, 368), 213.2),
    ("hand_21", (368, 368), 206.4)])
def test_flops_match_the_port(spec, hw, gflop):
    ours = flops.net_flops(spec, hw)
    assert ours == sum(graph.count_flops(graph.load_spec(spec), hw).values())
    assert round(ours / 1e9, 1) == gflop


def test_peak_is_the_datasheet_bf16_rate():
    assert flops.bf16_peak("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.bf16_peak("cpu") is None
