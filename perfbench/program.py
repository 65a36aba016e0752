"""The program's own spans and counters (`openpose_tpu_torch.utils.profiler
.TRACE`), reduced to numbers, and a run that measures them.

* `reduce_program(path)`: a torch.profiler chrome trace taken with the
  tracer's ranges on.  Each device operation is tied by correlation id to
  the `openpose.` spans open in its launching thread at its launch; its
  time goes to each of them (`span_device_s`, inclusive) and to their path
  (`path_device_s`).  Each idle gap of the device goes to the innermost
  program span open in the window's thread when the gap began, else to
  the harness span (`trace.Spans`), else to `outside_spans`.
* `host_summary(drained)`: what `TRACE.drain()` returned for a window with
  the tracer on and no profiler: per step, each span's duration and self
  time (its duration less its child spans'), the collector's time, and the
  counters.
* The arithmetic of the metrics these give (`device_ms_per_frame`,
  `crop_useful_share`, `host_dispatch_ms_p95`, `device_wait_ms_p95`,
  `gc_ms_p95`), each None where a run holds nothing to read.

    python3 -m perfbench.program --workload <cell> --seed <n> \
        --seconds <s> [--cpu]

runs a one-card cell's set-up as `perfbench.run` does, times one span off
and on, then runs an untraced window of --seconds, a window of
`SPAN_SECONDS` with the tracer on without ranges (the host spans), the
same length untraced again (what tracing costs is read against the
untraced windows on both sides of it), and a window of
`perfbench.run.TRACE_SECONDS` under torch.profiler with the tracer's
ranges on (with --cpu, the two windows are `CPU_SPAN_SECONDS` and
`CPU_TRACE_SECONDS`); it prints the numbers as one JSON line, and the
per-step deciles of each span and the idle gaps by span on standard
error.  Like `perfbench.run` it exits 3 where JAX or the JAX package was
loaded, at the start or after the windows.
It judges no answers: `perfbench.run` does.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gc
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Iterable, List, Optional

from openpose_tpu_torch.utils.profiler import RANGE_PREFIX, STEP_SPAN
from perfbench.trace import DEVICE_CATS, WINDOW
from perfbench.trace import PREFIX as HARNESS_PREFIX

# the host's own work between launches in a step: the CNN's and the
# decode's dispatch
DISPATCH_SPANS = ("pose.net", "pose.decode", "pose.decode.merge",
                  "pose.decode.nms", "pose.decode.paf")
SPAN_SECONDS = 8.0
# a CPU rehearsal's spans and profiled windows
CPU_SPAN_SECONDS = 1.5
CPU_TRACE_SECONDS = 0.5


# --- the device trace --------------------------------------------------------


def _segments(spans):
    """(times, paths): from times[i] on, the spans open are paths[i], for
    one thread's properly nested (t0, t1, name) spans."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    times, paths, stack = [], [], []

    def mark(t):
        times.append(t)
        paths.append(tuple(name for _, name in stack))

    for t0, t1, name in spans:
        while stack and stack[-1][0] <= t0:
            end = stack.pop()[0]
            mark(end)
        if stack:
            # a child ends no later than its parent (rounding of the trace)
            t1 = min(t1, stack[-1][0])
        stack.append((t1, name))
        mark(t0)
    while stack:
        end = stack.pop()[0]
        mark(end)
    return times, paths


def _path_at(segments, t) -> tuple:
    if segments is None:
        return ()
    times, paths = segments
    i = bisect.bisect_right(times, t) - 1
    return paths[i] if i >= 0 else ()


def reduce_program(path: str, top: int = 10) -> Optional[dict]:
    """The program's spans' share of a chrome trace's device time and idle
    gaps; None where the trace holds no harness window."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window, window_tid = None, None
    program = collections.defaultdict(list)
    harness = collections.defaultdict(list)
    launches, ops = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation":
            span = (e["ts"], e["ts"] + e["dur"])
            if name == WINDOW:
                window, window_tid = span, e.get("tid")
            elif name.startswith(RANGE_PREFIX):
                program[e.get("tid")].append(
                    (*span, name[len(RANGE_PREFIX):]))
            elif name.startswith(HARNESS_PREFIX):
                harness[e.get("tid")].append(
                    (*span, name[len(HARNESS_PREFIX):]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["ts"], e.get("tid"))
        elif cat in DEVICE_CATS:
            ops.append(e)
    if window is None:
        return None
    w0, w1 = window
    prog_seg = {tid: _segments(s) for tid, s in program.items()}
    harn_seg = {tid: _segments(s) for tid, s in harness.items()}

    def where(t, tid) -> tuple:
        return _path_at(prog_seg.get(tid), t)

    def gap_name(t) -> str:
        path = where(t, window_tid)
        if path:
            return path[-1]
        path = _path_at(harn_seg.get(window_tid), t)
        return path[-1] if path else "outside_spans"

    span_us = collections.defaultdict(float)
    span_ops = collections.defaultdict(int)
    path_us = collections.defaultdict(float)
    intervals = []
    for e in ops:
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        if t1 < w0 or t0 > w1:
            continue
        t0, t1 = max(t0, w0), min(t1, w1)
        intervals.append((t0, t1))
        corr = e.get("args", {}).get("correlation")
        path = where(*launches[corr]) if corr in launches else ()
        path_us["/".join(path) or "outside_program"] += t1 - t0
        for name in set(path):
            span_us[name] += t1 - t0
            span_ops[name] += 1
    intervals.sort()
    gaps = collections.defaultdict(float)
    busy, cursor = 0.0, w0
    for t0, t1 in intervals:
        if t0 > cursor:
            gaps[gap_name(cursor)] += t0 - cursor
        if t1 > cursor:
            busy += t1 - max(t0, cursor)
            cursor = t1
    if w1 > cursor:
        gaps[gap_name(cursor)] += w1 - cursor
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "span_device_s": {k: v / 1e6 for k, v in span_us.items()},
            "span_ops": dict(span_ops),
            "path_device_s": {k: v / 1e6 for k, v in sorted(
                path_us.items(), key=lambda kv: -kv[1])[:4 * top]},
            "idle_gaps": [[k, v / 1e6] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:top]]}


# --- the host spans ----------------------------------------------------------


def host_summary(drained: dict) -> dict:
    """Per step (those with a `pose.net` span opened at the top), each
    span's duration and self time in ms, summed over its calls in the step
    (0 where it has none), the `gc.*` time, and the counters:
    {"steps": [...], "spans": {name: {"dur_ms": [...], "self_ms": [...]}},
    "top_level": [...], "gc_ms": [...], "counters": {...}}.  "top_level"
    names the spans that had no parent."""
    spans = drained["spans"]
    children_ns = collections.defaultdict(int)
    for s in spans:
        if s[3] is not None:
            children_ns[s[3]] += s[2] - s[1]
    steps = sorted({s[4] for s in spans
                    if s[0] == STEP_SPAN and s[3] is None})
    where = {step: i for i, step in enumerate(steps)}
    names = sorted({s[0] for s in spans if not s[0].startswith("gc.")})
    dur = {n: [0.0] * len(steps) for n in names}
    own = {n: [0.0] * len(steps) for n in names}
    gc_ms = [0.0] * len(steps)
    top_level = set()
    for k, s in enumerate(spans):
        i = where.get(s[4])
        if i is None:
            continue
        ms = (s[2] - s[1]) / 1e6
        if s[0].startswith("gc."):
            gc_ms[i] += ms
            continue
        if s[3] is None:
            top_level.add(s[0])
        dur[s[0]][i] += ms
        own[s[0]][i] += ms - children_ns[k] / 1e6
    return {"steps": steps,
            "spans": {n: {"dur_ms": dur[n], "self_ms": own[n]}
                      for n in names},
            "top_level": sorted(top_level), "gc_ms": gc_ms,
            "counters": dict(drained["counters"])}


def p95(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100)[94]


def deciles(values: List[float]) -> List[float]:
    if len(values) < 2:
        return list(values)
    return statistics.quantiles(values, n=10)


# --- the metrics' arithmetic ------------------------------------------------


def device_ms_per_frame(summary: Optional[dict], names, frames: int
                        ) -> Optional[float]:
    """Device ms a frame launched inside any of the spans `names` (each
    operation once), from `reduce_program`'s summary; None where none ran.
    Spans in `names` must not nest in one another."""
    if not summary or not frames:
        return None
    got = [summary["span_device_s"][n] for n in names
           if n in summary["span_device_s"]]
    return 1e3 * sum(got) / frames if got else None


def crop_useful_share(host: Optional[dict]) -> Optional[float]:
    """100 x crops with a person to crop / crops sent through the nets."""
    counters = (host or {}).get("counters", {})
    computed = counters.get("topdown.crops_computed")
    if not computed:
        return None
    return 100.0 * counters.get("topdown.crops_active", 0) / computed


def host_dispatch_ms(host: dict) -> List[float]:
    """Per step, the self time of the CNN's and the decode's spans: the
    host's dispatch, the collector excluded (its spans are children)."""
    spans = host["spans"]
    return [sum(spans[n]["self_ms"][i] for n in DISPATCH_SPANS
                if n in spans) for i in range(len(host["steps"]))]


def host_dispatch_ms_p95(host: Optional[dict]) -> Optional[float]:
    if not host or "pose.net" not in host["spans"]:
        return None
    return p95(host_dispatch_ms(host))


def device_wait_ms_p95(host: Optional[dict]) -> Optional[float]:
    if not host or "pose.fetch.wait" not in host["spans"]:
        return None
    return p95(host["spans"]["pose.fetch.wait"]["dur_ms"])


def gc_ms_p95(host: Optional[dict]) -> Optional[float]:
    if not host or not host["steps"]:
        return None
    return p95(host["gc_ms"])


# --- the run -----------------------------------------------------------------


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.program")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="the untraced window that tracing's cost is "
                         "read against")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at the tiny sizes")
    return ap.parse_args(argv)


def _pace(rec) -> dict:
    out = {"frames": rec.frames, "window_s": rec.t1 - rec.t0,
           "frames_per_s": rec.frames / max(rec.t1 - rec.t0, 1e-9)}
    if len(rec.latencies) >= 2:
        q = statistics.quantiles(rec.latencies, n=100)
        out["latency_p50_ms"] = q[49] * 1e3
        out["latency_p95_ms"] = q[94] * 1e3
        out["latency_deciles_ms"] = [x * 1e3 for x in deciles(
            rec.latencies)]
    return out


def span_cost_us(tracer, n: int = 20000) -> dict:
    """The host's cost of one span (open and close, nothing inside), in
    us: tracing off, on, and on with ranges (no profiler running)."""
    out = {}
    for mode, ranges in (("off", None), ("on", False), ("ranges", True)):
        if ranges is not None:
            tracer.enable(ranges=ranges)
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                with tracer.span("pose.decode"):
                    pass
            out[mode] = (time.perf_counter() - t0) / n * 1e6
        finally:
            tracer.disable()
            tracer.drain()
    return out


def measure(args: argparse.Namespace) -> dict:
    import numpy as np
    import torch
    from perfbench import cells, inputs, loops, trace
    from perfbench import run as harness
    from openpose_tpu_torch.utils.profiler import TRACE

    cell, cfg, traffic = cells.load_cell(args.workload)
    if cell["chips"] != 1:
        raise SystemExit(f"{args.workload}: one-card cells only")
    cfg, traffic = harness.sized(cfg, traffic, args.cpu)
    if args.cpu:
        torch.set_num_threads(2)
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rows = slice(0, traffic["batch"])
    params = {"body": inputs.make_params(cfg["spec"], args.seed, device)}
    for key in ("face", "hand"):
        if key in cfg:
            params[key] = inputs.make_params(cfg[key]["spec"], args.seed,
                                             device)
    pool = inputs.Pool(cfg, traffic, args.seed, rows, device)
    prog = loops.Program(cfg, params, device, None)
    rng = np.random.default_rng(inputs.stream(args.seed, "order"))
    order = [int(b) for b in rng.permutation(len(pool))]
    loop = loops.LOOPS[traffic["loop"]]

    def window(seconds, spans):
        rec = loops.Record(loops.Sample(0, rng))
        loop(prog, pool, order, lambda _, t: t >= seconds, spans, rec)
        return rec

    # warm-up: every batch of the pool once, every shape the windows use
    loop(prog, pool, order, lambda i, _: i >= len(order), trace.Spans(),
         loops.Record(loops.Sample(0, rng)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()

    span_s, trace_s = (CPU_SPAN_SECONDS, CPU_TRACE_SECONDS) if args.cpu \
        else (SPAN_SECONDS, harness.TRACE_SECONDS)
    cost = span_cost_us(TRACE)
    plain = window(args.seconds, trace.Spans())
    TRACE.enable(ranges=False)
    try:
        span_spans = trace.Spans()
        spanned = window(span_s, span_spans)
        drained = TRACE.drain()
    finally:
        TRACE.disable()
    host = host_summary(drained)
    # the same length untraced again: the host's pace drifts in a process
    plain_after = window(span_s, trace.Spans())

    fd, trace_path = tempfile.mkstemp(suffix=".json", prefix="perfbench_")
    os.close(fd)
    tspans = trace.Spans(profiling=True)
    TRACE.enable(ranges=True)
    try:
        with trace.Profiled(trace_path) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                traced = window(trace_s, tspans)
        TRACE.disable()
        TRACE.drain()
        device_view = reduce_program(trace_path)
    finally:
        TRACE.disable()
        os.unlink(trace_path)

    steps = tspans.calls.get("net_outputs", 0)
    frames = steps * traffic["batch"]
    harness_view = prof.summary or {}
    decode_ms = None
    if harness_view.get("span_device_s", {}).get("decode") and frames:
        decode_ms = 1e3 * harness_view["span_device_s"]["decode"] / frames
    parts = ("pose.decode.merge", "pose.decode.nms", "pose.decode.paf")
    parts_ms = device_ms_per_frame(device_view, parts, frames)
    metrics = {
        "nms_device_ms": device_ms_per_frame(
            device_view, ("pose.decode.nms",), frames),
        "merge_device_ms": device_ms_per_frame(
            device_view, ("pose.decode.merge",), frames),
        "paf_device_ms": device_ms_per_frame(
            device_view, ("pose.decode.paf",), frames),
        "topdown_device_ms": device_ms_per_frame(
            device_view, ("wholebody.face", "wholebody.hand"), frames),
        "crop_useful_share": crop_useful_share(host),
        "host_dispatch_ms_p95": host_dispatch_ms_p95(host),
        "device_wait_ms_p95": device_wait_ms_p95(host),
        "gc_ms_p95": gc_ms_p95(host)}
    dispatch = host_dispatch_ms(host) if "pose.net" in host["spans"] \
        else []
    coverage = None
    if spanned.latencies and host["steps"]:
        covered = [sum(host["spans"][n]["dur_ms"][i]
                       for n in host["top_level"])
                   + host["gc_ms"][i] for i in range(len(host["steps"]))]
        upload_ms = 1e3 * span_spans.seconds.get("upload", 0.0) / max(
            span_spans.calls.get("upload", 0), 1)
        coverage = (statistics.median(covered) + upload_ms) / (
            1e3 * statistics.median(spanned.latencies))
    return {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        "metrics": metrics,
        "decode_device_ms_harness": decode_ms,
        "decode_parts_over_harness": parts_ms / decode_ms
        if parts_ms and decode_ms else None,
        "live_coverage_of_median_latency": coverage,
        "span_cost_us": cost, "spans_per_step": len(drained["spans"])
        / max(len(host["steps"]), 1),
        "untraced": _pace(plain), "spans_window": _pace(spanned),
        "untraced_after": _pace(plain_after),
        "profiled": {"frames": traced.frames, "steps": steps,
                     "busy_share": device_view["busy_s"]
                     / device_view["window_s"] if device_view else None,
                     "harness_busy_share": harness_view["busy_s"]
                     / harness_view["window_s"] if harness_view else None,
                     "launches_per_step": harness_view.get("device_ops", 0)
                     / max(steps, 1)},
        "span_deciles_ms": {
            **{n: deciles(v["dur_ms"]) for n, v in host["spans"].items()},
            "host_dispatch": deciles(dispatch), "gc": deciles(host["gc_ms"])},
        "counters": host["counters"],
        "idle_gaps": device_view["idle_gaps"] if device_view else None,
        "path_device_s": device_view["path_device_s"] if device_view
        else None}


def main(argv=None) -> int:
    from perfbench.run import _guard
    args = parse(argv)
    _guard("at start")
    t0 = time.time()
    out = measure(args)
    _guard("after the windows")
    for name, d in out["span_deciles_ms"].items():
        print(f"program: {name} deciles over steps, ms: "
              + " ".join(f"{x:.3f}" for x in d), file=sys.stderr)
    for name, sec in out["idle_gaps"] or ():
        print(f"program: idle begun in {name}: {sec:.4f} s",
              file=sys.stderr)
    print(f"program: done in {time.time() - t0:.1f} s", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
