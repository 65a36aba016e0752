"""Throughput path: native decode -> batched device -> host tail.

Counterpart of `openpose_tpu/runtime/video_runner.py`.  Combines the pieces
into the serving pipeline the reference builds with its thread/queue graph:

  NativeFramePump / NativeVideoPump (C++ worker pool, ordered)
  ->  fixed-size uint8 frame batches
  ->  PoseInference (one batched device call, its outputs left on the card)
  ->  thread-pool greedy assembly  ->  results in frame order

CUDA launches are asynchronous: batch k+1 is decoded and submitted while
batch k executes and batch k-1 is assembled on the host pool.  The loop that
does this is one method, `_run_batches`; `run_files` and `run_video` only
feed it from a pump.

Over a meshed `PoseInference`, `batch_size` is the global batch: every rank
runs its own runner over its own rows of each global batch and gets its
own frames' results, in frame order, under their global frame indices.
Files are decoded only by the rank that owns them; a video is decoded on
every rank (its frames come in stream order), which keeps its own rows.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from openpose_tpu_torch.parallel.inference import PoseInference

# (uint8 frames [batch_size, net_h, net_w, 3], input->net scale per frame
# [batch_size], number of real frames: the rest pads the tail batch)
Batch = Tuple[np.ndarray, np.ndarray, int]


@dataclasses.dataclass
class FrameResult:
    index: int
    keypoints: np.ndarray
    scores: np.ndarray
    source_wh: Tuple[int, int]


class VideoRunner:
    def __init__(self, inference: PoseInference,
                 batch_size: int = 8, decode_threads: int = 4,
                 assembly_workers: int = 4, max_in_flight: int = 4):
        """batch_size: frames a device call takes; over a mesh the global
        batch, which must tile it (this rank's share is `rows` of it)."""
        self.inference = inference
        self.global_batch = batch_size
        self.rows = inference.local_rows(batch_size)
        self.batch_size = self.rows.stop - self.rows.start
        self.decode_threads = decode_threads
        self.assembly_workers = assembly_workers
        # device batches in flight before the oldest is resolved: while one
        # is copied to the host the next ones compute
        self.max_in_flight = max(2, max_in_flight)

    # ------------------------------------------------------------------ #
    def _run_batches(self, batches: Iterable[Batch],
                     source_wh: Callable[[int], Tuple[int, int]]
                     ) -> Iterator[FrameResult]:
        """The dispatch / fetch / assemble loop.  Yields one FrameResult per
        real frame, in frame order, as soon as it and all before it are
        assembled.  source_wh(i): frame i's source size, asked after its
        batch was taken from `batches`.

        At most `max_in_flight` batches wait on the card for their copy to
        the host, and at most `max_in_flight` batches of frames wait for
        assembly: a slow host tail holds the device back instead of piling
        up its outputs."""
        pending = collections.deque()    # (start index, handle, scales, real)
        futures = collections.deque()    # one per real frame, in order
        pool = concurrent.futures.ThreadPoolExecutor(self.assembly_workers)

        def resolve():
            start, handle, scales, real = pending.popleft()
            peaks, scores = self.inference.fetch_end(handle)
            for bi in range(real):
                s_n2o = 1.0 / scales[bi] if scales[bi] > 0 else 1.0
                futures.append(pool.submit(
                    self._assemble_one, start + bi, peaks[bi], scores[bi],
                    s_n2o, source_wh(start + bi)))

        try:
            start = 0
            for batch, scales, real in batches:
                while len(futures) >= self.max_in_flight * self.batch_size:
                    yield futures.popleft().result()
                # uint8 NHWC straight to the card; it normalizes there
                out = self.inference(batch)
                pending.append((start, self.inference.fetch_begin(*out),
                                [float(s) for s in scales], real))
                start += real
                if len(pending) >= self.max_in_flight:
                    resolve()
                while futures and futures[0].done():
                    yield futures.popleft().result()
            while pending:
                resolve()
            while futures:
                yield futures.popleft().result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _assemble_one(self, index, peaks, scores, scale_net_to_output,
                      src_wh) -> FrameResult:
        keypoints, person_scores = self.inference.assemble(
            peaks, scores, scale_net_to_output)
        return FrameResult(index, keypoints, person_scores, src_wh)

    def _collect(self, batches: Iterable[Batch], source_wh,
                 on_result, index=None) -> List[FrameResult]:
        """index(i): the global index of this rank's i-th frame (over a
        mesh)."""
        results = []
        for res in self._run_batches(batches, source_wh):
            if index is not None:
                res.index = index(res.index)
            results.append(res)
            if on_result is not None:
                on_result(res)
        return results

    def _upload_buffers(self, frames: Optional[int] = None
                        ) -> List[np.ndarray]:
        """One [frames, net_h, net_w, 3] uint8 buffer (batch_size frames
        when None) per batch that can be on its way to the card at once,
        plus the one being filled; in pinned memory when the inference runs
        on a card, so the upload does not wait for the host."""
        net_h, net_w = self.inference.net_hw
        pin = self.inference.device.type == "cuda"
        return [torch.empty((frames or self.batch_size, net_h, net_w, 3),
                            dtype=torch.uint8, pin_memory=pin).numpy()
                for _ in range(self.max_in_flight + 1)]

    # ------------------------------------------------------------------ #
    def run_files(self, paths: List[str],
                  on_result: Optional[Callable[[FrameResult], None]] = None
                  ) -> List[FrameResult]:
        """Image files, decoded and resized to the net input by the native
        pump's worker pool, in the order given."""
        from openpose_tpu_torch.io.native_loader import (
            NativeFramePump, available)
        if not available():
            raise RuntimeError("native frame pump not built (make -C native)")
        net_h, net_w = self.inference.net_hw
        index = None
        if self.inference.mesh is not None:
            # this rank's rows of each global batch, by global index
            rows, g = self.rows, self.global_batch
            mine = [i for i in range(len(paths))
                    if rows.start <= i % g < rows.stop]
            index, paths = mine.__getitem__, [paths[i] for i in mine]
        pump = NativeFramePump(net_w, net_h, threads=self.decode_threads,
                               capacity=self.batch_size * 4)
        sizes: List[Tuple[int, int]] = []
        try:
            return self._collect(self._file_batches(pump, paths, sizes),
                                 sizes.__getitem__, on_result, index)
        finally:
            pump.close()

    def _file_batches(self, pump, paths: List[str],
                      sizes: List[Tuple[int, int]]) -> Iterator[Batch]:
        """Batches of the pump's decoded files; each frame's source size is
        appended to `sizes` as it is taken."""
        buffers = self._upload_buffers()
        scales = np.ones((self.batch_size,), np.float64)
        filled = count = 0      # batches yielded, frames in the one filling
        for _, net_in, scale, src_wh in self._decoded(pump, paths):
            buf = buffers[filled % len(buffers)]
            buf[count] = net_in
            scales[count] = scale
            sizes.append(src_wh)
            count += 1
            if count == self.batch_size:
                yield buf, scales.copy(), count
                filled, count = filled + 1, 0
        if count:
            # pad the tail batch to the static batch size
            buf = buffers[filled % len(buffers)]
            buf[count:] = buf[count - 1]
            scales[count:] = scales[count - 1]
            yield buf, scales.copy(), count

    def _decoded(self, pump, paths: List[str]):
        """Submit the files and yield the pump's items in order, popping
        while submitting once `decode_threads` files are in the pump."""
        submitted = popped = 0
        for path in paths:
            pump.submit_file(path)
            submitted += 1
            while pump.pending() > 0 and (submitted - popped) >= \
                    self.decode_threads:
                item = pump.next(timeout_ms=50)
                if item is None:
                    break
                popped += 1
                yield item
        while popped < submitted:
            item = pump.next()
            if item is None:
                raise TimeoutError("native frame pump: decode timeout")
            popped += 1
            yield item

    # ------------------------------------------------------------------ #
    def run_video(self, path: str, frame_step: int = 1,
                  on_result: Optional[Callable[[FrameResult], None]] = None,
                  max_frames: int = -1) -> List[FrameResult]:
        """Whole-video throughput path: native sequential decode + parallel
        preprocessing (NativeVideoPump) feeding batched device inference.

        Frames arrive via vp_next_batch: the C++ pump writes each device
        batch into ONE contiguous uint8 buffer (no per-frame ctypes calls,
        no original-frame copies, no np.stack): the Python thread only
        dispatches device batches and assembly futures."""
        from openpose_tpu_torch.io.native_loader import (
            NativeVideoPump, available)
        if not available():
            raise RuntimeError("native frame pump not built (make -C native)")
        net_h, net_w = self.inference.net_hw
        pump = NativeVideoPump(path, net_w, net_h,
                               threads=self.decode_threads,
                               capacity=self.batch_size * 4,
                               frame_step=frame_step)
        src_wh = pump.frame_size
        index = None
        if self.inference.mesh is not None:
            # this rank's i-th frame: row i % b of global batch i // b
            b = self.batch_size
            index = lambda i: (i // b) * self.global_batch \
                + self.rows.start + i % b
        try:
            return self._collect(self._video_batches(pump, max_frames),
                                 lambda i: src_wh, on_result, index)
        finally:
            pump.close()

    def _video_batches(self, pump, max_frames: int = -1) -> Iterator[Batch]:
        """Batches of the stream; over a mesh, this rank's rows of each
        global batch (the rest of the stream is decoded and dropped)."""
        if self.inference.mesh is not None:
            rows = self.rows
            for buf, scl, got in self._global_video_batches(pump,
                                                            max_frames):
                real = min(max(got - rows.start, 0), self.batch_size)
                if real:
                    yield buf[rows], scl[rows], real
            return
        yield from self._global_video_batches(pump, max_frames)

    def _global_video_batches(self, pump, max_frames: int = -1
                              ) -> Iterator[Batch]:
        buffers = self._upload_buffers(self.global_batch)
        filled = taken = 0
        while True:
            want = self.global_batch
            if max_frames >= 0:
                want = min(want, max_frames - taken)
                if want <= 0:
                    return
            buf = buffers[filled % len(buffers)]
            scl = np.empty((self.global_batch,), np.float64)
            got = 0
            eof = False
            while got < want:
                item = pump.next_batch(want - got, out=buf[got:want])
                if item is None:
                    eof = True
                    break
                k, _, part_scales = item
                if k == 0:
                    # a pop that timed out with frames still to come: the
                    # pump reports end of stream as None, never as 0
                    raise TimeoutError("native video pump: no frame within "
                                       "the pop's time limit")
                scl[got:got + k] = part_scales[:k]
                got += k
            if got == 0:
                return
            if got < self.global_batch:     # pad the tail batch
                buf[got:] = buf[got - 1]
                scl[got:] = scl[got - 1]
            yield buf, scl, got
            filled, taken = filled + 1, taken + got
            if eof:
                return

    # ------------------------------------------------------------------ #
    @staticmethod
    def run_video_whole_body(whole_body, path: str, frame_step: int = 1,
                             on_result=None, max_frames: int = -1,
                             batch_size: int = 8, decode_threads: int = 4):
        """Whole-body (pose+face+hand) batched video path.

        Feeds RAW decoded frames to `WholeBodyInference` (its body stage
        does the per-scale resize on the device, and the face/hand stages
        crop from the full-resolution frame exactly like the reference
        cascade, wrapperAuxiliary.hpp:324-337).  Batch-synchronous: the
        cascade has host geometry between device stages, so batches are not
        overlapped.  Over a meshed `whole_body`, batch_size is the global
        batch and this rank runs its own rows of each.

        Returns a list of (frame_index, WholeBodyResult).
        """
        rows = whole_body.local_rows(batch_size)
        from openpose_tpu_torch.io.native_loader import (
            NativeVideoPump, available)
        if not available():
            raise RuntimeError("native frame pump not built (make -C native)")
        # net inputs from the pump are unused (resize happens on device)
        pump = NativeVideoPump(path, 16, 16, threads=decode_threads,
                               capacity=batch_size * 2,
                               frame_step=frame_step)
        results = []
        try:
            batch, idx0, n = [], 0, 0

            def flush(frames, start):
                real = min(max(len(frames) - rows.start, 0),
                           rows.stop - rows.start)
                if real == 0:
                    return
                pad = batch_size - len(frames)
                frames = (frames + [frames[-1]] * pad)[rows]
                start += rows.start
                for off, res in enumerate(
                        whole_body(np.stack(frames))[:real]):
                    results.append((start + off, res))
                    if on_result is not None:
                        on_result(start + off, res)
            for _, frame, _net, _scale in pump:
                if 0 <= max_frames <= n:
                    break
                n += 1
                batch.append(frame)
                if len(batch) == batch_size:
                    flush(batch, idx0)
                    idx0 += batch_size
                    batch = []
            if batch:
                flush(batch, idx0)
        finally:
            pump.close()
        return results
