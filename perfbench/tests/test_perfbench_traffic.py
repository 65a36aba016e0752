"""The traffic follows each configuration's own keypoint set: people are
drawn as BODY_25 and projected onto the configuration's parts before their
net outputs are rendered, and a configuration whose parts, pairs and PAF
channels do not fit its net stops at set-up."""

import shutil

import numpy as np
import pytest
import torch

from openpose_tpu_torch.params import BODY_25_PARTS, COCO_18_PARTS
from perfbench import cells, inputs
from perfbench.reference import cnn, decode
from perfbench.tests.conftest import (COCO18_FROM_BODY25, coco18_config,
                                      coco18_spec_text)

SEED = 4294967311


@pytest.fixture
def coco18_spec(tmp_path, monkeypatch):
    """The reference's specs with COCO_18's added, in a copy of their
    directory."""
    specs = tmp_path / "perfbench" / "reference" / "specs"
    shutil.copytree(cnn.SPEC_DIR, specs)
    (specs / "coco_18.json").write_text(coco18_spec_text())
    monkeypatch.setattr(cnn, "SPEC_DIR", specs)
    cnn.load_spec.cache_clear()
    yield
    cnn.load_spec.cache_clear()


def _config(name):
    return coco18_config() if name == "coco18" else \
        cells.load_json("configs", name)


def _channels(cfg):
    return cnn.output_channels(cnn.load_spec(cfg["spec"]))


def test_coco18_parts_are_the_body25_parts_of_the_same_name():
    by_name = {v: k for k, v in BODY_25_PARTS.items()}
    want = [by_name[COCO_18_PARTS[i]] for i in range(18)]
    assert COCO18_FROM_BODY25 == want


@pytest.mark.parametrize("name", cells.names("configs") + ["coco18"])
def test_rendered_maps_have_the_nets_output_channels(name, coco18_spec):
    cfg = _config(name)
    hw = tuple(cfg["net_hw"])
    people = inputs.batch_people(SEED, 0, 4, (1, 4), hw)
    maps = inputs.rendered(cfg, people)
    assert maps.shape == (4, hw[0] // 8, hw[1] // 8, _channels(cfg))


@pytest.mark.parametrize("name", ["body25", "wholebody"])
@pytest.mark.parametrize("batch_index", [0, 5])
def test_body25_maps_are_what_they_were_before_the_projection(name,
                                                              batch_index):
    """Without `keypoints_from_body25` all 25 parts go in, in order: the
    maps are bit for bit the ones rendered from the drawn people
    directly."""
    cfg = cells.load_json("configs", name)
    assert "keypoints_from_body25" not in cfg
    hw = tuple(cfg["net_hw"])
    people = inputs.batch_people(SEED, batch_index, 8, (1, 4), hw)
    pairs = np.asarray(cfg["pairs"], np.int64).reshape(-1, 2)
    map_idx = np.asarray(cfg["map_idx"], np.int64).reshape(-1, 2) + 26
    want = inputs.make_targets(people, pairs, map_idx, hw, 25, 78)
    assert np.array_equal(inputs.rendered(cfg, people), want)


@pytest.mark.parametrize("name", ["coco18", "body25"])
def test_the_reference_decode_finds_every_drawn_person(name, coco18_spec):
    """At the cell's size and mix (`video_b8`: batches of 8 368x656 frames,
    1-4 people), each of 2 pool batches decodes to the people drawn."""
    cfg = _config(name)
    traffic = cells.load_json("traffic", "video_b8")
    hw = tuple(cfg["net_hw"])
    for b in range(2):
        people = inputs.batch_people(SEED, b, traffic["batch"],
                                     tuple(traffic["people"]), hw)
        maps = inputs.rendered(cfg, people)
        assert maps.shape[-1] == _channels(cfg)
        found = [len(kp) for kp, _ in decode.decode(torch.from_numpy(maps),
                                                    cfg)]
        assert found == (people[:, :, 0, 2] > 0).sum(axis=1).tolist()


def _without_the_map(cfg):
    del cfg["keypoints_from_body25"]


def _another_net(cfg):
    cfg["spec"] = "body_25"


def _pair_beyond_the_parts(cfg):
    cfg["pairs"][-1] = 18


def _paf_beyond_the_channels(cfg):
    cfg["map_idx"][0] = 38


def _map_outside_body25(cfg):
    cfg["keypoints_from_body25"][-1] = 25


@pytest.mark.parametrize("fault", [
    _without_the_map, _another_net, _pair_beyond_the_parts,
    _paf_beyond_the_channels, _map_outside_body25])
def test_a_configuration_that_misfits_its_net_raises(fault, coco18_spec):
    """`_without_the_map` is COCO_18 fed BODY_25's 25 parts: 64 channels
    for a net of 57, every PAF 7 channels off."""
    cfg = coco18_config()
    fault(cfg)
    people = inputs.batch_people(SEED, 0, 2, (1, 4), tuple(cfg["net_hw"]))
    with pytest.raises(ValueError, match="'coco18'"):
        inputs.rendered(cfg, people)
    traffic = dict(cells.load_json("traffic", "video_b8"), pool=1)
    with pytest.raises(ValueError, match="'coco18'"):
        inputs.Pool(cfg, traffic, SEED, slice(0, 8), torch.device("cpu"))
