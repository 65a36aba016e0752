"""The reduction of the program's own spans (`perfbench/program.py`): a
chrome trace's device time and idle gaps by span, the host spans' per-step
self time and tails, and the metrics they give on a CPU rehearsal."""

import json
import os
import statistics
import subprocess
import sys
import types

import pytest

from perfbench import program, run
from perfbench.tests.conftest import ROOT


def _x(name, ts, dur, cat="user_annotation", tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _launch(ts, corr, tid=1):
    return _x("cudaLaunchKernel", ts, 1, cat="cuda_runtime", tid=tid,
              correlation=corr)


def _op(ts, dur, corr, name="k"):
    return _x(name, ts, dur, cat="kernel", tid=7, correlation=corr)


def test_reduce_program_ties_ops_to_their_innermost_path_and_names_gaps(
        tmp_path):
    events = [
        _x("perfbench.window", 0, 100),
        _x("perfbench.decode", 10, 46),
        _x("openpose.pose.decode", 12, 36),
        _x("openpose.pose.decode.merge", 13, 5),
        _x("openpose.pose.decode.nms", 20, 20),
        _x("perfbench.fetch_end", 60, 30),
        _x("openpose.pose.fetch.wait", 61, 28),
        # another thread's span at the same time owns none of thread 1's
        _x("openpose.pose.assemble", 0, 100, tid=2),
        _launch(14, 1), _launch(21, 2), _launch(45, 3), _launch(52, 4),
        _launch(5, 5, tid=2),
        _op(15, 4, 1), _op(22, 10, 2), _op(46, 8, 3), _op(55, 2, 4),
        _op(95, 3, 5),
        _op(200, 5, 6),                        # outside the window
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = program.reduce_program(str(path))
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(27e-6)
    dev = {k: v * 1e6 for k, v in got["span_device_s"].items()}
    assert dev == pytest.approx({"pose.decode": 22, "pose.decode.merge": 4,
                                 "pose.decode.nms": 10,
                                 "pose.assemble": 3})
    assert got["span_ops"] == {"pose.decode": 3, "pose.decode.merge": 1,
                               "pose.decode.nms": 1, "pose.assemble": 1}
    paths = {k: v * 1e6 for k, v in got["path_device_s"].items()}
    assert paths == pytest.approx({
        "pose.decode/pose.decode.nms": 10, "pose.decode": 8,
        "pose.decode/pose.decode.merge": 4, "pose.assemble": 3,
        "outside_program": 2})
    gaps = {k: v * 1e6 for k, v in got["idle_gaps"]}
    # 0-15 outside any span; 19-22 in merge's parent after merge ended;
    # 32-46 in nms then decode; 54-55 in the harness's decode span after
    # the program's ended; 57-95 from the harness span's end, past
    # fetch.wait's start, is one gap begun outside; 98-100 outside
    assert gaps == pytest.approx({"outside_spans": 15 + 38 + 2,
                                  "pose.decode": 3, "pose.decode.nms": 14,
                                  "decode": 1})
    assert program.device_ms_per_frame(got, ["pose.decode.nms"], 2) \
        == pytest.approx(10e-3 / 2)
    assert program.device_ms_per_frame(got, ["wholebody.face"], 2) is None


def test_reduce_program_without_a_window_or_program_spans(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [_x("openpose.pose.net", 0,
                                                   9)]}))
    assert program.reduce_program(str(path)) is None
    path.write_text(json.dumps({"traceEvents": [
        _x("perfbench.window", 0, 10), _x("perfbench.decode", 0, 10),
        _launch(1, 1), _op(2, 3, 1)]}))
    got = program.reduce_program(str(path))
    assert got["span_device_s"] == {}
    assert [k for k, _ in got["idle_gaps"]] == ["decode"]
    assert program.device_ms_per_frame(got, ["pose.decode.nms"], 1) is None


def _drained():
    """Two steps of a live loop, the first with a collector pause inside
    the CNN's dispatch; times in ms."""
    ms = 1_000_000
    spans = [
        ("pose.net", 0, 10 * ms, None, 4),
        ("gc.0", 2 * ms, 5 * ms, 0, 4),
        ("pose.decode", 10 * ms, 14 * ms, None, 4),
        ("pose.decode.nms", 11 * ms, 13 * ms, 2, 4),
        ("pose.fetch.wait", 14 * ms, 20 * ms, None, 4),
        ("pose.net", 20 * ms, 26 * ms, None, 5),
        ("pose.decode", 26 * ms, 27 * ms, None, 5),
        ("pose.fetch.wait", 27 * ms, 28 * ms, None, 5),
        ("pose.assemble", 28 * ms, 30 * ms, None, 5),
        ("pose.assemble", 30 * ms, 31 * ms, None, 5),
        ("gc.2", 50 * ms, 51 * ms, None, 3),            # before any step
    ]
    return {"spans": spans, "counters": {"topdown.crops_computed": 8,
                                         "topdown.crops_active": 5}}


def test_host_summary_per_step_self_time_and_tails():
    host = program.host_summary(_drained())
    assert host["steps"] == [4, 5]
    spans = host["spans"]
    assert spans["pose.net"]["dur_ms"] == [10, 6]
    assert spans["pose.net"]["self_ms"] == [7, 6]
    assert spans["pose.decode"]["dur_ms"] == [4, 1]
    assert spans["pose.decode"]["self_ms"] == [2, 1]
    assert spans["pose.decode.nms"]["self_ms"] == [2, 0]
    assert spans["pose.assemble"]["dur_ms"] == [0, 3]
    assert host["gc_ms"] == [3, 0]
    assert host["top_level"] == ["pose.assemble", "pose.decode",
                                 "pose.fetch.wait", "pose.net"]
    # the CNN's and the decode's dispatch, the collector's pause left out
    assert program.host_dispatch_ms(host) == [11, 7]

    def q(values):
        return statistics.quantiles(values, n=100)[94]

    assert program.host_dispatch_ms_p95(host) == pytest.approx(q([11, 7]))
    assert program.device_wait_ms_p95(host) == pytest.approx(q([6, 1]))
    assert program.gc_ms_p95(host) == pytest.approx(q([3, 0]))
    assert program.crop_useful_share(host) == pytest.approx(62.5)


def test_the_host_metrics_are_none_where_nothing_was_traced():
    host = program.host_summary({"spans": [], "counters": {}})
    assert host["steps"] == []
    for read in (program.host_dispatch_ms_p95, program.device_wait_ms_p95,
                 program.gc_ms_p95, program.crop_useful_share):
        assert read(host) is None and read(None) is None


@pytest.mark.parametrize("when", ["at start", "after the windows"])
def test_the_span_run_refuses_a_process_that_loaded_jax(monkeypatch, capsys,
                                                        when):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if when == "at start":
        load_jax()
    monkeypatch.setattr(program, "measure", lambda args: load_jax())
    with pytest.raises(SystemExit) as exit_:
        program.main(["--workload", "body25.live_b1", "--seed", "1",
                      "--seconds", "1", "--cpu"])
    assert exit_.value.code == 3
    captured = capsys.readouterr()
    assert f"perfbench: {when}, loaded: jax;" in captured.err
    assert captured.out == ""


def _rehearse(workload):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.program", "--workload", workload,
         "--seed", "4294967311", "--seconds", "1", "--cpu"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("workload,host,absent", [
    ("body25.live_b1", ["host_dispatch_ms_p95", "device_wait_ms_p95",
                        "gc_ms_p95"], ["crop_useful_share"]),
    ("body25.video_b8", ["host_dispatch_ms_p95", "device_wait_ms_p95",
                         "gc_ms_p95"], ["crop_useful_share"]),
    ("wholebody.video_b8", ["crop_useful_share", "host_dispatch_ms_p95"],
     [])])
def test_the_host_metrics_read_on_the_cpu(workload, host, absent):
    out, err = _rehearse(workload)
    metrics = out["metrics"]
    for name in host:
        assert isinstance(metrics[name], float) and metrics[name] >= 0, name
    for name in absent:
        assert metrics[name] is None
    # the CPU's trace has no device operation: the device readings are none
    for name in ("nms_device_ms", "merge_device_ms", "paf_device_ms",
                 "topdown_device_ms"):
        assert metrics[name] is None
    assert out["device"] == "cpu"
    assert "program: pose.net deciles over steps, ms:" in err


def test_crop_share_equals_the_share_the_pools_people_give():
    """Each frame of a pool holds a fixed count of people; every person
    gives a face crop and two hand crops, and a batch crops its frames'
    leading slots up to its most people: the share is the people over
    the batch times its most, over the pool.  At the cell's net size and
    batch (its people, its rects); the face and hand nets at the
    rehearsal's size, which crops the same slots."""
    import torch
    from perfbench import cells, inputs, loops
    from openpose_tpu_torch.utils.profiler import TRACE
    _, cfg, traffic = cells.load_cell("wholebody.video_b8")
    for key in ("face", "hand"):
        cfg[key] = cfg["cpu_rehearsal"][key]
    traffic = {**traffic, "pool": 2}
    torch.set_num_threads(2)
    device = torch.device("cpu")
    params = {k: inputs.make_params(cfg[k]["spec"] if k != "body"
                                    else cfg["spec"], 7, device)
              for k in ("body", "face", "hand")}
    rows = slice(0, traffic["batch"])
    pool = inputs.Pool(cfg, traffic, 7, rows, device)
    prog = loops.Program(cfg, params, device)
    TRACE.enable()
    try:
        # the cascade on the rendered outputs, as the cell's loop calls it
        # after the body CNN
        for b in range(len(pool)):
            prog.whole(pool.frames[b], net_output=pool.maps[b])
        host = program.host_summary(TRACE.drain())
    finally:
        TRACE.disable()
    counts = [(p[:, :, 0, 2] > 0).sum(axis=1) for p in pool.people]
    assert sorted(counts[0].tolist()) == [1, 1, 2, 2, 3, 3, 4, 4]
    want = 100.0 * sum(int(c.sum()) for c in counts) / sum(
        len(c) * int(c.max()) for c in counts)
    assert want == 62.5
    assert program.crop_useful_share(host) == pytest.approx(want)
    assert host["counters"]["topdown.crops_computed"] == 2 * 8 * 4 * 3
