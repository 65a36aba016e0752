"""Asynchronous host pipeline: overlap frame IO, device compute, and output.

Counterpart of `openpose_tpu/runtime/pipeline.py` (the same code: it needs
no device library).  It replaces the reference's worker/queue thread graph
(ThreadManager + WQueueOrderer etc., include/openpose/thread/): instead of
one thread per worker, three stages connected by bounded queues —

  reader thread  ->  [frame queue]  ->  device loop  ->  [result queue]  ->  writer thread

The device loop keeps multiple frames in flight (CUDA launches are
asynchronous; `process` may return a callable, e.g. one that ends a
`PoseInference.fetch_begin`, and it is only called one step behind), so
JPEG decode, host assembly, and output writing overlap device execution.
Frame order is preserved by construction (single in-order device stream),
which replaces WQueueOrderer.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

_SENTINEL = object()


@dataclasses.dataclass
class PipelineStats:
    frames: int = 0
    seconds: float = 0.0

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else 0.0


class AsyncPipeline:
    """produce -> process (in-flight window) -> consume, each overlapped."""

    def __init__(self, producer: Iterable, process: Callable,
                 consumer: Optional[Callable] = None,
                 queue_size: int = 8, in_flight: int = 2):
        self.producer = producer
        self.process = process
        self.consumer = consumer
        self.queue_size = queue_size
        self.in_flight = max(1, in_flight)
        self.stats = PipelineStats()
        self._error: Optional[BaseException] = None

    def _reader(self, q: queue.Queue) -> None:
        try:
            for item in self.producer:
                q.put(item)
        except BaseException as e:  # propagate to main thread
            self._error = e
        finally:
            q.put(_SENTINEL)

    def _writer(self, q: queue.Queue) -> None:
        # On consumer error: record it but KEEP DRAINING (discarding) until
        # the sentinel, so the main loop's out_q.put never deadlocks on a
        # full queue behind a dead writer (the reference's analogue is
        # checkWorkerErrors + queue stop(), threadManager.hpp:238).
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if self._error is None and self.consumer is not None:
                try:
                    self.consumer(item)
                except BaseException as e:
                    self._error = e

    def run(self) -> PipelineStats:
        in_q: queue.Queue = queue.Queue(maxsize=self.queue_size)
        out_q: queue.Queue = queue.Queue(maxsize=self.queue_size)
        reader = threading.Thread(target=self._reader, args=(in_q,),
                                  daemon=True)
        writer = threading.Thread(target=self._writer, args=(out_q,),
                                  daemon=True)
        reader.start()
        writer.start()

        pending = []
        t0 = time.perf_counter()
        frames = 0
        try:
            while True:
                if self._error is not None:
                    raise self._error
                item = in_q.get()
                if item is _SENTINEL:
                    break
                pending.append(self.process(item))
                # Bounded in-flight window: resolve the oldest result
                if len(pending) >= self.in_flight:
                    out_q.put(_resolve(pending.pop(0)))
                    frames += 1
            for p in pending:
                out_q.put(_resolve(p))
                frames += 1
        finally:
            out_q.put(_SENTINEL)
            writer.join()
            # Unblock a reader stuck on a full in_q (error exit), bounded
            deadline = time.perf_counter() + 2.0
            while reader.is_alive() and time.perf_counter() < deadline:
                try:
                    in_q.get_nowait()
                except queue.Empty:
                    pass
                reader.join(timeout=0.05)
        if self._error is not None:
            raise self._error
        self.stats = PipelineStats(frames, time.perf_counter() - t0)
        return self.stats


def _resolve(result):
    """Force any deferred/lazy result (callables resolve themselves)."""
    return result() if callable(result) else result
