"""The port's span and counter store, `utils/profiler.py::TRACE` (CPU, tiny
sizes, the port's own seeded weights).

Off, tracing records nothing, reads no clock and hooks nothing; on, it
changes no output, and every span of the inference layers appears once a
call with its parent and step; the top-down crop counters equal the slots
computed and the active rows; under torch.profiler the spans' ranges nest
in the exported chrome trace; `--profile_speed` prints the spans' averages
on the CLI's batched path.
"""

import gc
import json
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from openpose_tpu_torch import cli, synthetic
from openpose_tpu_torch.io import native_loader
from openpose_tpu_torch.models import graph, zoo
from openpose_tpu_torch.ops import nms, paf
from openpose_tpu_torch.parallel.inference import (
    PoseInference, TopDownInference)
from openpose_tpu_torch.runtime.whole_body import WholeBodyInference
from openpose_tpu_torch.utils import profiler
from openpose_tpu_torch.utils.profiler import NO_SPAN, TRACE

NET_HW = (184, 328)
BATCH = 2
PEOPLE = (1, 3)          # people in the two frames
TOPDOWN_NET = 64
DECODE = ["pose.decode", "pose.decode.merge", "pose.decode.nms",
          "pose.decode.paf"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _tracing_off():
    TRACE.disable()
    TRACE.drain()
    yield
    TRACE.disable()
    TRACE.drain()


@pytest.fixture(scope="module")
def scene():
    """Seeded frames, the net outputs a trained net gives for their people,
    and the inference objects over the port's seeded weights."""
    body = zoo.load_pose_model(seed=0, device="cpu")
    rng = np.random.RandomState(5)
    people = np.zeros((BATCH, max(PEOPLE), 25, 3), np.float32)
    for i, n in enumerate(PEOPLE):
        people[i, :n] = synthetic.random_people(
            rng, n, NET_HW, height_range=(120, 160), min_spacing=100.0)
    pairs, map_idx = paf.pair_tables(body.info)
    maps = synthetic.make_targets(people, pairs, map_idx, NET_HW,
                                  body.info.num_parts,
                                  body.info.heatmap_channels)
    frames = rng.randint(0, 256, (BATCH, *NET_HW, 3)).astype(np.uint8)
    kw = dict(net_hw=NET_HW, device="cpu", compute_dtype=torch.float32)
    return {
        "frames": torch.from_numpy(frames), "maps": torch.from_numpy(maps),
        "cnn": PoseInference(body, **kw),
        "decode": PoseInference(body, net_bypass=True, **kw),
        "whole": WholeBodyInference(
            body, zoo.load_face_model(device="cpu"),
            zoo.load_hand_model(device="cpu"), frame_hw=None,
            people_cap=4, face_net_size=TOPDOWN_NET,
            hand_net_size=TOPDOWN_NET, net_bypass=True, **kw)}


def pose_step(scene):
    """One frame batch as a live loop drives it: the CNN, the decode of the
    rendered outputs, the fetch and each frame's assembly."""
    src = scene["cnn"].net_outputs(scene["frames"])
    pi = scene["decode"]
    peaks, scores = pi.fetch_end(pi.fetch_begin(*pi.decode([scene["maps"]])))
    people = [pi.assemble(peaks[i], scores[i]) for i in range(BATCH)]
    return [s.numpy() for s in src] + [peaks, scores] + [
        a for kp in people for a in kp]


def whole_step(scene):
    """The whole body's closed loop: the body CNN, then the cascade."""
    src = scene["cnn"].net_outputs(scene["frames"])
    results = scene["whole"](scene["frames"], net_output=scene["maps"])
    return [s.numpy() for s in src] + [
        getattr(r, f) for r in results
        for f in ("pose_keypoints", "pose_scores", "face_keypoints",
                  "hand_left_keypoints", "hand_right_keypoints")]


STEPS = {"pose": pose_step, "wholebody": whole_step}


def test_off_records_nothing_reads_no_clock_and_hooks_nothing(scene,
                                                              monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert TRACE.span("pose.net") is TRACE.span("wholebody.face") is NO_SPAN
    assert TRACE._on_gc not in gc.callbacks
    TRACE.count("topdown.crops_computed", 3)
    whole_step(scene)
    pose_step(scene)
    gc.collect()
    assert TRACE.drain() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("what", sorted(STEPS))
def test_outputs_bit_equal_with_tracing_on_and_off(scene, what):
    off = STEPS[what](scene)
    TRACE.enable(ranges=True)
    on = STEPS[what](scene)
    TRACE.disable()
    assert TRACE.drain()["spans"]
    assert len(on) == len(off)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def _net_parts(parent, step):
    """The CNN's trunk and CPM stages inside its `pose.net` span, once at
    the one scale."""
    return [("pose.net.trunk", parent, step),
            ("pose.net.stages", parent, step)]


def _convs(*inferences):
    """The convolutions of one forward of each inference object's net."""
    return sum(len(inf.net.epilogues) for inf in inferences)


def _tree(spans):
    """(name, parent's name, step) of each span, gc pauses left out."""
    return [(s[0], None if s[3] is None else spans[s[3]][0], s[4])
            for s in spans if not s[0].startswith("gc.")]


def test_pose_spans_once_a_call_with_parent_and_step(scene):
    TRACE.enable()
    step = TRACE.step + 1
    pose_step(scene)
    got = TRACE.drain()
    assert _tree(got["spans"]) == [
        ("pose.net", None, step), *_net_parts("pose.net", step),
        ("pose.decode", None, step),
        ("pose.decode.merge", "pose.decode", step),
        ("pose.decode.nms", "pose.decode", step),
        ("pose.decode.paf", "pose.decode", step),
        ("pose.fetch.wait", None, step)] + [
        ("pose.assemble", None, step)] * BATCH
    # the CNN's call and the decode's, both eager: the CPU replays no graph;
    # every convolution of the CNN takes the plain epilogue, the decode the
    # plain NMS
    assert got["counters"] == {"pose.graph.eager": 2,
                               graph.EPILOGUE_PLAIN: _convs(scene["cnn"]),
                               nms.PLAIN: 1}


def test_whole_body_spans_and_crop_counters(scene):
    TRACE.enable()
    step = TRACE.step + 1
    whole_step(scene)
    got = TRACE.drain()
    assert _tree(got["spans"]) == [
        ("pose.net", None, step), *_net_parts("pose.net", step),
        ("wholebody.body", None, step),
        # the body's net_bypass call runs no CNN, so it has no parts
        ("pose.net", "wholebody.body", step),
        ("pose.decode", "wholebody.body", step),
        ("pose.decode.merge", "pose.decode", step),
        ("pose.decode.nms", "pose.decode", step),
        ("pose.decode.paf", "pose.decode", step),
        ("pose.fetch.wait", "wholebody.body", step)] + [
        ("pose.assemble", "wholebody.body", step)] * BATCH + [
        ("wholebody.face", None, step),
        ("topdown.fetch", "wholebody.face", step),
        ("wholebody.hand", None, step),
        ("topdown.fetch", "wholebody.hand", step)]
    # every person found gives an active face and two active hands, and
    # every frame computes the leading slots up to the most people
    most, total = max(PEOPLE), sum(PEOPLE)
    # and the body's CNN and decode are one eager call each (its
    # net_bypass upload counts nothing); the body CNN, the face net and
    # the hand net (both hands in one call) each run every convolution's
    # plain epilogue once
    whole = scene["whole"]
    assert got["counters"] == {
        "topdown.crops_computed": BATCH * most * 3,
        "topdown.crops_active": total * 3, "pose.graph.eager": 2,
        graph.EPILOGUE_PLAIN: _convs(scene["cnn"], whole.face, whole.hand),
        nms.PLAIN: 1}


@pytest.mark.parametrize("what", sorted(STEPS))
def test_children_lie_inside_their_parent_so_self_time_is_what_they_leave(
        scene, what):
    TRACE.enable()
    STEPS[what](scene)
    spans = TRACE.drain()["spans"]
    children = {}
    for i, s in enumerate(spans):
        assert s[1] <= s[2]
        if s[3] is not None:
            parent = spans[s[3]]
            assert parent[1] <= s[1] <= s[2] <= parent[2], (s, parent)
            children.setdefault(s[3], []).append(s)
    assert children
    for i, kids in children.items():
        kids.sort(key=lambda s: s[1])
        # siblings do not overlap: the duration less the children's is
        # the part of the interval no child covers
        for a, b in zip(kids, kids[1:]):
            assert a[2] <= b[1]
        own = spans[i][2] - spans[i][1] - sum(k[2] - k[1] for k in kids)
        assert own >= 0


@pytest.mark.parametrize("rows", [
    [[True, False, True], [False, False, False]],
    [[False, True, False], [True, False, False]],
    [[False, False, False], [False, False, False]]])
def test_crop_counters_equal_slots_sent_and_active_rows(scene, rows):
    td = scene["whole"].face
    active = np.asarray(rows)
    transforms = np.tile(np.asarray(td.INACTIVE, np.float32),
                         (BATCH, td.people_cap, 1))
    transforms[:, :3][active] = (0.25, 0.25, 10.0, 10.0)
    TRACE.enable()
    td(scene["frames"], transforms)
    counters = TRACE.drain()["counters"]
    k = TopDownInference.active_slots(transforms)
    if k == 0:
        assert counters == {}
    else:
        assert counters == {"topdown.crops_computed": BATCH * k,
                            "topdown.crops_active": int(active.sum()),
                            graph.EPILOGUE_PLAIN: _convs(td)}


def test_ranges_nest_in_the_profilers_chrome_trace(scene, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    pi = scene["decode"]
    TRACE.enable(ranges=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            pi.fetch_end(pi.fetch_begin(*pi.decode([scene["maps"]])))
    TRACE.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"}

    def inside(child, parent):
        return spans[parent][0] <= spans[child][0] \
            and spans[child][1] <= spans[parent][1]

    prefix = profiler.RANGE_PREFIX
    for name in DECODE[1:]:
        assert inside(prefix + name, prefix + "pose.decode")
    assert inside(prefix + "pose.decode", "outer")
    assert inside(prefix + "pose.fetch.wait", "outer")


def test_gc_pauses_are_spans_inside_the_open_span_and_the_hook_goes():
    TRACE.enable()
    assert gc.callbacks.count(TRACE._on_gc) == 1
    TRACE.enable(ranges=False)
    assert gc.callbacks.count(TRACE._on_gc) == 1
    with TRACE.span("pose.net"):
        gc.collect()
    TRACE.disable()
    assert TRACE._on_gc not in gc.callbacks
    spans = TRACE.drain()["spans"]
    assert spans[0][0] == "pose.net"
    pauses = [s for s in spans if s[0] == "gc.2"]
    assert pauses and all(s[3] == 0 for s in pauses)


def test_profiler_timers_land_among_the_spans():
    prof = profiler.Profiler()
    TRACE.enable()
    with TRACE.span("pose.net"):
        prof.timer_init("pose")
        prof.timer_end("pose")
    got = [s for s in TRACE.drain()["spans"] if not s[0].startswith("gc.")]
    assert [(s[0], s[3]) for s in got] == [("pose.net", None), ("pose", 0)]
    assert prof.averages_ms()["pose"] == pytest.approx(
        (got[1][2] - got[1][1]) / 1e6)


def test_drain_hands_over_parents_as_indices_and_keeps_counting_steps():
    TRACE.enable()
    with TRACE.span("pose.net"):
        pass
    first = TRACE.drain()
    with TRACE.span("pose.decode"):
        with TRACE.span("pose.decode.nms"):
            TRACE.count("topdown.crops_active", 2)
            TRACE.count("topdown.crops_active")
    with TRACE.span("pose.net"):
        with TRACE.span("pose.net"):         # nested: the same step
            pass
    second = TRACE.drain()
    step = first["spans"][0][4]
    assert [(s[0], s[3], s[4]) for s in second["spans"]] == [
        ("pose.decode", None, step), ("pose.decode.nms", 0, step),
        ("pose.net", None, step + 1), ("pose.net", 2, step + 1)]
    assert second["counters"] == {"topdown.crops_active": 3}
    assert TRACE.drain() == {"spans": [], "counters": {}}


def test_a_span_open_at_a_drain_is_handed_over_once_it_closes():
    """Another thread's span open at a drain (an assembly worker's, as
    `--profile_speed` drains every N frames) is not lost."""
    TRACE.enable()
    with TRACE.span("pose.assemble"):
        with TRACE.span("pose.decode"):
            pass
        early = TRACE.drain()
    late = TRACE.drain()
    assert [(s[0], s[3]) for s in early["spans"]] == [("pose.decode", None)]
    assert [(s[0], s[3]) for s in late["spans"]] == [("pose.assemble", None)]
    assert late["spans"][0][1] <= early["spans"][0][1] \
        <= early["spans"][0][2] <= late["spans"][0][2]
    assert TRACE.drain()["spans"] == []


def test_spans_of_many_threads_keep_their_own_parents():
    """More threads than cores, switching often: each span's parent is the
    span its own thread had open."""
    n_threads, n_spans = 16, 200
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    TRACE.enable()
    try:
        def work(t):
            for _ in range(n_spans):
                with TRACE.span(f"outer.{t}"):
                    with TRACE.span(f"inner.{t}"):
                        pass

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(before)
        TRACE.disable()
    spans = TRACE.drain()["spans"]
    mine = [s for s in spans if not s[0].startswith("gc.")]
    assert len(mine) == 2 * n_threads * n_spans
    for s in mine:
        kind, t = s[0].split(".")
        if kind == "outer":
            assert s[3] is None
        else:
            assert spans[s[3]][0] == f"outer.{t}"


def test_profile_speed_prints_span_averages_on_the_batched_path(
        tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    if not native_loader.available():
        pytest.skip("needs the native frame pump")
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        people = synthetic.random_people(rng, 2, (120, 200),
                                         height_range=(60, 100))
        cv2.imwrite(str(images / f"scene_{i:03d}.png"),
                    synthetic.render_scene_image(people, (120, 200), rng))
    argv = ["--image_dir", str(images), "--net_resolution=-1x64", "--fp32",
            "--batch", "2", "--profile_speed", "2", "--render_pose", "0"]
    assert cli.fast_path_eligible(cli.build_parser().parse_args(argv))
    assert cli.main(argv, device="cpu") == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[profiler]")]
    line = re.compile(r"\[profiler\] ([\w.]+): \d+\.\d\d ms avg over (\d+)$")
    counter = re.compile(r"\[profiler\] ([\w.]+): (\d+) over \d+ frames$")
    counts = [counter.match(ln).groups() for ln in lines
              if counter.match(ln)]
    assert {name for name, _ in counts} == {
        "pose.graph.eager", graph.EPILOGUE_PLAIN, nms.PLAIN}, lines
    eager = [int(n) for name, n in counts if name == "pose.graph.eager"]
    # the CPU runs every call eagerly: two batches, a CNN and a decode each
    assert eager and eager[-1] == 4, lines
    # and every convolution of the two batches' BODY_25 CNN runs its
    # epilogue's plain version, each decode the plain NMS
    plain = [int(n) for name, n in counts if name == graph.EPILOGUE_PLAIN]
    n_convs = len(graph.epilogue_plan(graph.load_spec("body_25")))
    assert plain and plain[-1] == 2 * n_convs, lines
    plain_nms = [int(n) for name, n in counts if name == nms.PLAIN]
    assert plain_nms and plain_nms[-1] == 2, lines
    parsed = [line.match(ln) for ln in lines if not counter.match(ln)]
    assert all(parsed), lines
    # after frame 2, then at the end: every span of the batched path twice
    names = [m.group(1) for m in parsed]
    for name in ["pose.net", *DECODE, "pose.fetch.wait", "pose.assemble"]:
        assert names.count(name) == 2, (name, lines)
    final = {m.group(1): int(m.group(2)) for m in parsed}
    assert final["pose.net"] == 2 and final["pose.assemble"] == 3
    assert not TRACE.enabled and TRACE._on_gc not in gc.callbacks


def test_profile_speed_prints_the_crop_counters_with_the_spans(scene,
                                                                capsys):
    """The whole body's batched path under `--profile_speed 1`: after each
    frame batch the spans' averages, then each counter's total so far."""
    report = profiler.SpanReport(1, "[rank 0] ")
    try:
        for _ in range(2):
            whole_step(scene)
            report.frames += BATCH - 1
            report.frame()
    finally:
        report.close()
    lines = capsys.readouterr().out.splitlines()
    assert lines and all(ln.startswith("[rank 0] [profiler] ")
                         for ln in lines)
    counted = re.compile(r"\[rank 0\] \[profiler\] (topdown\.crops_\w+): "
                         r"(\d+) over (\d+) frames$")
    got = [m.groups() for m in map(counted.match, lines) if m]
    most, total = max(PEOPLE), sum(PEOPLE)
    one = {"topdown.crops_computed": BATCH * most * 3,
           "topdown.crops_active": total * 3}
    # after each batch, and again at the end
    assert got == [(name, str(n * one[name]), str(n * BATCH))
                   for n in (1, 2, 2) for name in sorted(one)]
    assert any(ln.startswith("[rank 0] [profiler] wholebody.face: ")
               for ln in lines)
    assert not TRACE.enabled and TRACE._on_gc not in gc.callbacks
