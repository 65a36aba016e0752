"""Every cell rehearsed on the CPU at its tiny sizes prints the contract's
last line, and a cell and a metric added as new files only run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import cells
from perfbench.tests.conftest import (ROOT, coco18_config,
                                      coco18_spec_text)

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cwd, workload, trace, seed=4294967311, env_path=None):
    env = dict(os.environ, PYTHONPATH=str(env_path or ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", "1", "--trace", str(trace),
         "--cpu"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", cells.names("workloads"))
def test_cell_rehearses_on_the_cpu(name, trace):
    out, err = _run(ROOT, name, trace)
    extra = ["breakdown"] if trace else []
    assert list(out) == KEYS + extra + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    cell = cells.load_json("workloads", name)
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(out["metrics"]) <= set(wanted)
    if not trace:
        assert set(out["metrics"]) == set(wanted)
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] == cell["chips"]
    # the numbers compared, each beside its limit, end standard error
    tail = err.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def _add(base, rel, text):
    path = base / rel
    assert not path.exists(), rel
    path.write_text(text)


def _crowd_cell_and_metric(base):
    cell = json.loads((base / "workloads" / "body25.live_b1.json")
                      .read_text())
    cell.update(traffic="live_b1_crowd", why="a test cell",
                end_to_end=["frames_answered", "setup_s"])
    _add(base, "workloads/body25.crowd_b1.json", json.dumps(cell))
    traffic = json.loads((base / "traffic" / "live_b1.json").read_text())
    traffic["people"] = [5, 6]
    _add(base, "traffic/live_b1_crowd.json", json.dumps(traffic))
    _add(base, "metrics/frames_answered.py",
         'UNIT = "frames"\n\n\ndef read(run):\n'
         '    return float(sum(r["frames"] for r in run.ranks))\n')
    return "body25.crowd_b1"


def _coco18_keypoint_set(base):
    """Another net's keypoint set: a configuration, its spec's copy and a
    cell."""
    _add(base, "configs/coco18.json", json.dumps(coco18_config()))
    _add(base, "reference/specs/coco_18.json", coco18_spec_text())
    cell = json.loads((base / "workloads" / "body25.video_b8.json")
                      .read_text())
    cell.update(config="coco18", why="a test cell")
    _add(base, "workloads/coco18.video_b8.json", json.dumps(cell))
    return "coco18.video_b8"


@pytest.mark.parametrize("new_files", [_crowd_cell_and_metric,
                                       _coco18_keypoint_set])
def test_a_new_cell_and_metric_are_new_files_only(tmp_path, new_files):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    workload = new_files(tmp_path / "perfbench")
    env_path = os.pathsep.join([str(tmp_path), str(ROOT)])
    out, _ = _run(tmp_path, workload, 0, env_path=env_path)
    assert out["correct"] is True and out["failed"] == 0
    if "frames_answered" in out["metrics"]:
        assert out["metrics"]["frames_answered"]["value"] == \
            out["attempted"]


def test_traffic_that_misfits_the_net_stops_the_run_at_set_up(tmp_path):
    """COCO_18 without `keypoints_from_body25` would be fed BODY_25's 25
    parts: the run stops before its window and prints no result."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "perfbench"
    workload = _coco18_keypoint_set(base)
    cfg = coco18_config()
    del cfg["keypoints_from_body25"]
    (base / "configs" / "coco18.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path),
                                                        str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", "1", "--seconds", "1", "--trace", "0", "--cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "ValueError: configuration 'coco18'" in proc.stderr
    assert "set-up done" not in proc.stderr


def test_without_a_card_a_run_prints_nothing_and_fails():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "body25.video_b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_benchmark_alone_fails(tmp_path):
    """In a directory with BENCHMARK.json and perfbench/ only, the port
    is missing: no result."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "body25.video_b8", "--seed", "1", "--seconds", "1", "--trace", "0",
         "--cpu"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
