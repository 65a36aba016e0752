"""Every cell, configuration, traffic mix and metric is a file of its own,
found by name, and `BENCHMARK.json` says what the files say."""

import json

import pytest

from perfbench import cells
from perfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", cells.names("workloads"))
def test_cell_files_are_found_by_name(name):
    cell, cfg, traffic = cells.load_cell(name)
    assert cfg["name"] == cell["config"]
    assert traffic["loop"] in ("overlapped", "live", "closed")
    for metric in cell["end_to_end"] + cell["per_layer"]:
        reader = cells.load_metric(metric)
        assert callable(reader.read) and reader.UNIT
    assert "setup_s" in cell["end_to_end"]


def test_benchmark_json_matches_the_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for w in BENCH["workloads"]:
        cell = cells.load_json("workloads", w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell["config"], cell["traffic"], cell["chips"], cell["why"])
        for kind in ("end_to_end", "per_layer"):
            listed = [m["name"] for m in BENCH[kind]
                      if w["name"] in m.get("workloads", [w["name"]])]
            assert sorted(listed) == sorted(cell[kind]), (w["name"], kind)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert c["reduced"] == []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert cells.load_metric(m["name"]).UNIT == m["unit"]
    names = [m["name"] for m in BENCH["per_layer"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    assert len(set(names)) == len(names)


def test_unknown_and_malformed_names_are_refused():
    with pytest.raises(FileNotFoundError):
        cells.load_cell("no.such.cell")
    with pytest.raises(ValueError):
        cells.load_json("workloads", "../BENCHMARK")
