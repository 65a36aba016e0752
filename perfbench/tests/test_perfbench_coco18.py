"""The `coco18` configuration is the port's COCO_18 at its published
widths: its FLOP count, its spec's copy and its tables."""

import json

from openpose_tpu_torch.models import graph
from openpose_tpu_torch.params import (
    POSE_MODEL_INFO, PoseModel, default_connect_params)
from perfbench import cells, flops
from perfbench.reference import cnn
from perfbench.tests.conftest import COCO18_FROM_BODY25, ROOT

HW = (368, 656)


def test_coco18_flops_match_the_port():
    ours = flops.net_flops("coco_18", HW)
    assert ours == sum(graph.count_flops(graph.load_spec("coco_18"),
                                         HW).values())
    assert round(ours / 1e9, 1) == 484.8


def test_coco18_spec_copy_is_the_ports():
    port = json.loads((ROOT / "openpose_tpu_torch" / "models" / "specs"
                       / "coco_18.json").read_text())
    assert cnn.load_spec("coco_18") == port


def test_coco18_configuration_is_the_ports_coco_18():
    cfg = cells.load_json("configs", "coco18")
    info = POSE_MODEL_INFO[PoseModel.COCO_18]
    cp = default_connect_params(PoseModel.COCO_18)
    assert (cfg["model"], cfg["spec"]) == ("COCO_18", info.spec)
    assert cfg["net_hw"] == [368, 656] and cfg["max_peaks"] == 127
    assert cfg["num_parts"] == info.num_parts
    assert cfg["pairs"] == list(info.pairs)
    assert cfg["map_idx"] == list(info.map_idx)
    assert cfg["keypoints_from_body25"] == COCO18_FROM_BODY25
    assert cfg["thresholds"] == {
        "nms": cp.nms_threshold, "inter": cp.inter_threshold,
        "inter_min_above": cp.inter_min_above_threshold,
        "min_subset_cnt": cp.min_subset_cnt,
        "min_subset_score": cp.min_subset_score}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["coco18"]
    assert entry["source"] == cfg["source"] and entry["why"] == cfg["why"]
