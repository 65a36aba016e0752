"""Spans of the harness and the reduction of a profiler trace to numbers.

`Spans` times, on the host clock, every call the harness makes into a
layer of the program (upload, CNN, decode, fetch, assembly, whole body);
in a traced run each span is also a `record_function` range, so the
profiler's trace carries it.

`reduce` reads a torch.profiler chrome trace: the device operations
(kernels, copies, memsets) inside the traced window, each attributed to
the harness span its launch was made in (by the launch's correlation id),
the union of their intervals (busy time), the idle gaps between them named
by the span the host was in when the gap began, and the operations that
took most time.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import time
from typing import Dict, List, Optional

import torch

PREFIX = "perfbench."
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock totals and counts of the harness's spans."""

    def __init__(self, profiling: bool = False):
        self.profiling = profiling
        self.seconds: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.seconds[name] += time.perf_counter() - t0
        self.calls[name] += 1


def reduce(path: str, top: int = 10) -> Optional[dict]:
    """The numbers of a chrome trace, or None where it holds no window."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = None
    spans, launches, ops = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name.startswith(PREFIX):
            if name == WINDOW:
                window = (e["ts"], e["ts"] + e["dur"])
            else:
                spans.append((e["ts"], e["ts"] + e["dur"],
                              name[len(PREFIX):]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e["ts"]
        elif cat in DEVICE_CATS:
            ops.append(e)
    if window is None:
        return None
    w0, w1 = window
    spans.sort()
    starts = [s[0] for s in spans]

    def span_at(t: float) -> str:
        # spans do not nest: the last one begun by t holds t or none does
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][1] >= t:
            return spans[i][2]
        return "outside_spans"

    by_span_us = collections.defaultdict(float)
    ops_by_span = collections.defaultdict(int)
    by_name_us = collections.defaultdict(float)
    intervals = []
    n_ops = 0
    for e in ops:
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        if t1 < w0 or t0 > w1:
            continue
        n_ops += 1
        t0, t1 = max(t0, w0), min(t1, w1)
        intervals.append((t0, t1))
        by_name_us[e.get("name", "?")] += t1 - t0
        corr = e.get("args", {}).get("correlation")
        span = span_at(launches[corr]) if corr in launches else "unknown"
        by_span_us[span] += t1 - t0
        ops_by_span[span] += 1
    intervals.sort()
    busy, gaps = 0.0, collections.defaultdict(float)
    cursor = w0
    for t0, t1 in intervals:
        if t0 > cursor:
            gaps[span_at(cursor)] += t0 - cursor
        if t1 > cursor:
            busy += t1 - max(t0, cursor)
            cursor = t1
    if w1 > cursor:
        gaps[span_at(cursor)] += w1 - cursor
    top_ops = sorted(by_name_us.items(), key=lambda kv: -kv[1])[:top]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "device_ops": n_ops,
            "span_device_s": {k: v / 1e6 for k, v in by_span_us.items()},
            "span_ops": dict(ops_by_span),
            "top_ops": [[name[:120], us / 1e6] for name, us in top_ops],
            "idle_gaps": [[name, us / 1e6] for name, us in top_gaps]}


class Profiled:
    """A torch.profiler session over a traced window, reduced on exit into
    `self.summary` (None where the trace held no window)."""

    def __init__(self, trace_path: str):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.trace_path = trace_path
        self.summary: Optional[dict] = None

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.trace_path)
            self.summary = reduce(self.trace_path)
        return False


def mean_over_ranks(summaries: List[dict], key: str, top: int = 10) -> list:
    """Average a per-rank [[name, seconds], ...] list over ranks."""
    acc = collections.defaultdict(float)
    for s in summaries:
        for name, sec in s[key]:
            acc[name] += sec / len(summaries)
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            [:top]]
