"""Tests of the benchmark harness.  They run on the CPU at the tiny sizes
of the files' `cpu_rehearsal` entries; a test marked `card` needs an
NVIDIA card and skips without one (decided inside the test)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


# COCO_18's parts in its own order, each the BODY_25 part of the same name
COCO18_FROM_BODY25 = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16,
                      17, 18]


def coco18_config() -> dict:
    """A COCO_18 configuration, as a file of its own would hold it:
    `body25`'s settings with COCO's parts, pairs and PAF channels from the
    port's tables, and the BODY_25 parts its people are drawn as."""
    import json
    from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
    info = POSE_MODEL_INFO[PoseModel.COCO_18]
    cfg = json.loads((ROOT / "perfbench" / "configs" / "body25.json")
                     .read_text())
    cfg.update(
        name="coco18", model="COCO_18", spec="coco_18",
        source="https://github.com/CMU-Perceptual-Computing-Lab/openpose/"
               "blob/master/models/pose/coco/pose_deploy_linevec.prototxt",
        num_parts=info.num_parts, pairs=list(info.pairs),
        map_idx=list(info.map_idx),
        about="OpenPose COCO_18 (arXiv:1611.08050), --model_pose COCO, "
              "as body25 runs BODY_25",
        why="the COCO deploy net: 7x7 CPM stages, ReLU, 19 PAF pairs, on "
            "the BODY_25 trunk, graphs and decode",
        keypoints_from_body25=list(COCO18_FROM_BODY25))
    return cfg


def coco18_spec_text() -> str:
    """The port's COCO_18 net spec, written as the reference's copies are."""
    import json
    spec = json.loads((ROOT / "openpose_tpu_torch" / "models" / "specs"
                       / "coco_18.json").read_text())
    return json.dumps(spec, separators=(",", ":"))
