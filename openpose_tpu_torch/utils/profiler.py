"""Keyed timers + averaged reports (reference Profiler,
include/openpose/utilities/profiler.hpp:66-100).

Counterpart of `openpose_tpu/utils/profiler.py`.  CUDA launches are
asynchronous: `timer_end` waits for the streams of the tensors it is given
before it reads the clock, mirroring the reference's
cudaDeviceSynchronize-bracketed OP_CUDA_PROFILE macros (profiler.hpp:31-65).
A stage that ends in a device->host copy is already synchronised.
`speed_of_light_ms` is the original's roofline helper, its default rates
those of the card in use (`utils/benchmark.py`'s datasheet table).

`TRACE` is the port's span and counter store: off unless `TRACE.enable`
(or `--profile_speed` on the CLI's batched path, through `SpanReport`)
turns it on.  The inference layers open spans at their boundaries
(`pose.net` and its `trunk` and `stages`, `pose.decode` and its `merge`,
`nms` and `paf`, `pose.fetch.wait`, `pose.assemble`,
`wholebody.body`/`face`/`hand`, `topdown.fetch`) and count the top-down
crops (`topdown.crops_computed`, `topdown.crops_active`); the garbage
collector's pauses come in as `gc.<generation>` spans, and
`Profiler.timer_end`'s intervals as spans of their keys.
`TRACE.drain()` hands everything over as plain lists and dicts.
"""

from __future__ import annotations

import collections
import gc
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch

from openpose_tpu_torch.utils import benchmark


class Profiler:
    enabled: bool = True

    def __init__(self, report_every: int = 1000):
        self.report_every = report_every
        self._acc: Dict[str, float] = collections.defaultdict(float)
        self._count: Dict[str, int] = collections.defaultdict(int)
        self._open: Dict[str, float] = {}

    def timer_init(self, key: str) -> None:
        if self.enabled:
            self._open[key] = time.perf_counter_ns()

    def timer_end(self, key: str,
                  device_tensors: Optional[Iterable[torch.Tensor]] = None
                  ) -> float:
        if not self.enabled or key not in self._open:
            return 0.0
        for device in {t.device for t in device_tensors or () if t.is_cuda}:
            torch.cuda.synchronize(device)
        t0, t1 = self._open.pop(key), time.perf_counter_ns()
        TRACE.record(key, t0, t1)
        dt = (t1 - t0) / 1e9
        self.add(key, dt)
        if self._count[key] % self.report_every == 0:
            print(self.report_line(key))
        return dt

    def add(self, key: str, seconds: float) -> None:
        """One interval of `seconds` under `key`."""
        self._acc[key] += seconds
        self._count[key] += 1

    def report_line(self, key: str) -> str:
        avg = self._acc[key] / max(self._count[key], 1) * 1000.0
        return f"[profiler] {key}: {avg:.2f} ms avg over {self._count[key]}"

    def report(self) -> str:
        return "\n".join(self.report_line(k) for k in sorted(self._acc))

    def averages_ms(self) -> Dict[str, float]:
        return {k: self._acc[k] / max(self._count[k], 1) * 1000.0
                for k in self._acc}


# the span whose opening, with no span open, starts a step
STEP_SPAN = "pose.net"
# what `torch.profiler` ranges of spans are called: "openpose.pose.decode"
RANGE_PREFIX = "openpose."


class _NoSpan:
    """The one context every span is while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "record", "range")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.record, self.range = self.tracer._open(self.name)
        return self

    def __exit__(self, *exc):
        self.tracer._close(self.record, self.range)
        return False


class Tracer:
    """Spans and counters of the port's layers, kept in memory.

    Off, `span` returns `NO_SPAN` (no clock read, nothing allocated) and
    `count` returns at once.  On, a span records (name, t0_ns, t1_ns,
    parent, step) with `time.perf_counter_ns`: `parent` is the enclosing
    span open in the same thread, `step` the number of `pose.net` spans
    opened so far with no span open, i.e. the step the span began in.  In
    a loop that keeps one batch in flight, the assembly of batch n runs
    after batch n+1's `pose.net` and so carries the next step's number.
    With `ranges`, every span also opens a `torch.profiler.record_function`
    named `RANGE_PREFIX + name`, so a profiler trace carries the spans on
    its own clock and ties each device operation to the span it was
    launched in.  While on, a `gc.callbacks` hook records every collection
    as a `gc.<generation>` span.
    """

    def __init__(self):
        self.enabled = False
        self.ranges = False
        self.step = 0
        self._spans: List[list] = []
        self._counters: Dict[str, int] = {}
        self._ids = itertools.count()
        self._local = threading.local()
        self._gc_t0: Optional[int] = None

    def enable(self, ranges: bool = False) -> None:
        self.ranges = ranges
        if not self.enabled:
            self.enabled = True
            gc.callbacks.append(self._on_gc)

    def disable(self) -> None:
        if self.enabled:
            self.enabled = False
            self.ranges = False
            gc.callbacks.remove(self._on_gc)
            self._gc_t0 = None

    def span(self, name: str):
        """A context manager timing the enclosed work as `name`."""
        if not self.enabled:
            return NO_SPAN
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self._counters[name] = self._counters.get(name, 0) + n

    def record(self, name: str, t0_ns: int, t1_ns: int) -> None:
        """A closed interval as a span inside the innermost open one."""
        if self.enabled:
            stack = self._stack()
            self._spans.append([name, t0_ns, t1_ns,
                                stack[-1] if stack else None, self.step,
                                next(self._ids)])

    def drain(self) -> dict:
        """Hand over and clear the records of the closed spans and the
        counters: {"spans": [(name, t0_ns, t1_ns, parent, step)],
        "counters": {name: n}}, where parent is the index of the enclosing
        span in the same list (None where it has none, or where it is not
        in the list).  A span still open, such as another thread's, stays
        and is handed over by the first drain after it closes."""
        held, self._spans = self._spans, []
        counters, self._counters = self._counters, {}
        spans = [r for r in held if r[2] is not None]
        self._spans[:0] = [r for r in held if r[2] is None]
        where = {r[5]: i for i, r in enumerate(spans)}
        return {"spans": [(r[0], r[1], r[2], where.get(r[3]), r[4])
                          for r in spans],
                "counters": dict(counters)}

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str):
        stack = self._stack()
        if name == STEP_SPAN and not stack:
            self.step += 1
        rng = None
        if self.ranges:
            rng = torch.profiler.record_function(RANGE_PREFIX + name)
            rng.__enter__()
        record = [name, 0, None, stack[-1] if stack else None, self.step,
                  next(self._ids)]
        self._spans.append(record)
        stack.append(record[5])
        record[1] = time.perf_counter_ns()
        return record, rng

    def _close(self, record: list, rng) -> None:
        record[2] = time.perf_counter_ns()
        self._stack().pop()
        if rng is not None:
            rng.__exit__(None, None, None)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
        elif self._gc_t0 is not None:
            self.record(f"gc.{info['generation']}", self._gc_t0,
                        time.perf_counter_ns())
            self._gc_t0 = None


TRACE = Tracer()


class SpanReport:
    """`--profile_speed N` where the work runs outside the `Profiler`'s
    stage timers (the CLI's batched path): turns `TRACE` on without ranges
    and prints each span's average ms in `Profiler.report_line`'s format,
    then each counter's total so far, every `every` frames and on `close`,
    which turns `TRACE` off.

    The spans are host times and do not synchronise the device: a span
    that only launches work (`pose.net`, `pose.decode`) is the dispatch,
    and the device's time shows where the host waits for it
    (`pose.fetch.wait`, `topdown.fetch`)."""

    def __init__(self, every: int, prefix: str = ""):
        self.every, self.prefix, self.frames = every, prefix, 0
        self.profiler = Profiler()
        self.counters: Dict[str, int] = collections.Counter()
        TRACE.enable(ranges=False)

    def frame(self) -> None:
        """One frame done."""
        self.frames += 1
        if self.frames % self.every == 0:
            self.report()

    def report(self) -> None:
        drained = TRACE.drain()
        for name, t0, t1, _, _ in drained["spans"]:
            self.profiler.add(name, (t1 - t0) / 1e9)
        self.counters.update(drained["counters"])
        for line in self.profiler.report().splitlines():
            print(self.prefix + line)
        for name in sorted(self.counters):
            print(f"{self.prefix}[profiler] {name}: {self.counters[name]} "
                  f"over {self.frames} frames")

    def close(self) -> None:
        try:
            self.report()
        finally:
            TRACE.disable()



def speed_of_light_ms(flops: float, bytes_moved: float,
                      peak_tflops: Optional[float] = None,
                      hbm_gbps: Optional[float] = None) -> float:
    """Roofline lower bound in ms: the larger of flops over the peak rate
    and bytes_moved over the memory rate.  Defaults: the bf16 peak and the
    HBM rate of the card in use; raises ValueError where the datasheet
    table does not hold that device (the CPU included) and no rate was
    given."""
    if peak_tflops is None:
        peak_tflops = benchmark.bf16_peak_tflops()
    if hbm_gbps is None:
        hbm_gbps = benchmark.hbm_bytes_per_s() / 1e9
    if not peak_tflops or not hbm_gbps:
        raise ValueError(f"no datasheet rates for {benchmark.device_name()!r}"
                         ": pass peak_tflops and hbm_gbps")
    compute_ms = flops / (peak_tflops * 1e12) * 1e3
    memory_ms = bytes_moved / (hbm_gbps * 1e9) * 1e3
    return max(compute_ms, memory_ms)
