"""The program under test, built from a configuration, and the loops that
drive it.

The program is the port, `openpose_tpu_torch`: `PoseInference` (upload,
`net_outputs` -- the body CNN --, `decode`, `fetch_begin`/`fetch_end`,
`assemble`) and, for whole-body configurations, `WholeBodyInference` over
a `net_bypass` body.  The frames go through the CNN as a video's would;
the decode takes the rendered net outputs of the same frames (a trained
net's output for the frames' people, `inputs.py`) through the program's
injection path, since random weights find no real people.

Loops (the traffic file's `loop`):

* `overlapped`: a closed loop of batches.  Each step uploads a batch, runs
  the CNN and the decode, starts the fetch, assembles the previous batch
  on the host while the card works, then ends the fetch -- the runner's
  one batch in flight.
* `live`: one frame at a time, frame to keypoints on the host; each
  frame's latency is taken from its upload to its keypoints.
* `closed`: a closed loop of whole-body batches: upload, the body CNN,
  then `WholeBodyInference(frames, net_output=rendered)` (decode, fetch,
  assembly, KeepTopN, face and hand rectangles, crops, face and hand nets,
  map-back), which returns on the host.

Each runs until `stop(steps, seconds)` says so, and records every answer
it produced (the pool batch and, per frame, the keypoints) and a seeded
sample of the CNN outputs (whole steps, on the device), for the check
after the window.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from openpose_tpu_torch.models import caffe_proto, zoo
from openpose_tpu_torch.parallel.inference import PoseInference
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
from openpose_tpu_torch.runtime.whole_body import WholeBodyInference
from perfbench.reference import cnn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Program:
    """The port's inference objects for one configuration on one rank."""

    def __init__(self, cfg: dict, params: Dict[str, dict],
                 device: torch.device, mesh=None):
        def model(key, spec_name, info):
            spec = caffe_proto.NetSpec.from_json(cnn.load_spec(spec_name))
            return zoo.from_params(spec, params[key], info, device)

        th = cfg["thresholds"]
        body = model("body", cfg["spec"],
                     POSE_MODEL_INFO[PoseModel(cfg["model"])])
        kw = dict(net_hw=tuple(cfg["net_hw"]), device=device,
                  max_peaks=cfg["max_peaks"], nms_threshold=th["nms"],
                  inter_threshold=th["inter"],
                  inter_min_above_threshold=th["inter_min_above"],
                  compute_dtype=DTYPES[cfg["compute_dtype"]], mesh=mesh)
        self.body = PoseInference(body, **kw)
        self.device = self.body.device
        self.whole = None
        if "face" in cfg:
            face, hand = cfg["face"], cfg["hand"]
            kw.pop("net_hw")
            self.whole = WholeBodyInference(
                body, model("face", face["spec"], None),
                model("hand", hand["spec"], None), frame_hw=None,
                net_hw=tuple(cfg["net_hw"]), people_cap=cfg["people_cap"],
                face_net_size=face["net_size"],
                hand_net_size=hand["net_size"], net_bypass=True, **kw)


class Sample:
    """Each offered item kept with probability 1 / every, drawn from the
    seed, so the sample grows with the window and is spread over it; the
    last item stands in when none was drawn.  every = 0 keeps nothing."""

    def __init__(self, every: int, rng: np.random.Generator):
        self.every, self.rng, self.kept, self.last = every, rng, [], None

    def offer(self, item) -> None:
        if self.every:
            self.last = item
            if self.rng.random() * self.every < 1.0:
                self.kept.append(item)

    @property
    def items(self) -> list:
        return self.kept or ([self.last] if self.last is not None else [])


class Record:
    """What one window produced."""

    def __init__(self, sample: Sample):
        self.answers: List[tuple] = []     # (pool batch, [per-frame answer])
        self.cnn = sample                  # (pool batch, CNN output)
        self.latencies: List[float] = []
        self.frames = 0
        self.t0 = self.t1 = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _assemble(prog: Program, spans, arrays) -> list:
    peaks, scores = arrays
    with spans("assemble"):
        return [prog.body.assemble(peaks[i], scores[i])
                for i in range(peaks.shape[0])]


def overlapped(prog: Program, pool, order, stop, spans,
               rec: Record) -> None:
    pi, dev = prog.body, prog.device
    prev = None
    i = 0
    rec.t0 = time.perf_counter()
    while not stop(i, time.perf_counter() - rec.t0):
        b = order[i % len(order)]
        with spans("upload"):
            x = pool.frames[b].to(dev, non_blocking=True)
        with spans("net_outputs"):
            src = pi.net_outputs(x)
        with spans("decode"):
            peaks, scores = pi.decode([pool.maps[b]])
        with spans("fetch_begin"):
            handle = pi.fetch_begin(peaks, scores)
        if prev is not None:
            rec.answers.append((prev[0], _assemble(prog, spans, prev[1])))
            rec.frames += len(rec.answers[-1][1])
        with spans("fetch_end"):
            prev = (b, pi.fetch_end(handle))
        rec.cnn.offer((b, src[0]))
        i += 1
    if prev is not None:
        rec.answers.append((prev[0], _assemble(prog, spans, prev[1])))
        rec.frames += len(rec.answers[-1][1])
    _sync(dev)
    rec.t1 = time.perf_counter()


def live(prog: Program, pool, order, stop, spans, rec: Record) -> None:
    pi, dev = prog.body, prog.device
    i = 0
    rec.t0 = time.perf_counter()
    while not stop(i, time.perf_counter() - rec.t0):
        b = order[i % len(order)]
        t_in = time.perf_counter()
        with spans("upload"):
            x = pool.frames[b].to(dev, non_blocking=True)
        with spans("net_outputs"):
            src = pi.net_outputs(x)
        with spans("decode"):
            peaks, scores = pi.decode([pool.maps[b]])
        with spans("fetch_begin"):
            handle = pi.fetch_begin(peaks, scores)
        with spans("fetch_end"):
            arrays = pi.fetch_end(handle)
        answer = _assemble(prog, spans, arrays)
        rec.latencies.append(time.perf_counter() - t_in)
        rec.answers.append((b, answer))
        rec.frames += len(answer)
        rec.cnn.offer((b, src[0]))
        i += 1
    _sync(dev)
    rec.t1 = time.perf_counter()


def closed(prog: Program, pool, order, stop, spans, rec: Record) -> None:
    pi, wb, dev = prog.body, prog.whole, prog.device
    i = 0
    rec.t0 = time.perf_counter()
    while not stop(i, time.perf_counter() - rec.t0):
        b = order[i % len(order)]
        with spans("upload"):
            x = pool.frames[b].to(dev, non_blocking=True)
        with spans("net_outputs"):
            src = pi.net_outputs(x)
        with spans("whole_body"):
            results = wb(x, net_output=pool.maps[b])
        rec.answers.append((b, [(r.pose_keypoints, r.pose_scores,
                                 r.face_keypoints, r.hand_left_keypoints,
                                 r.hand_right_keypoints) for r in results]))
        rec.frames += len(results)
        rec.cnn.offer((b, src[0]))
        i += 1
    _sync(dev)
    rec.t1 = time.perf_counter()


LOOPS: Dict[str, Callable] = {"overlapped": overlapped, "live": live,
                              "closed": closed}
