"""Benchmark: BODY_25 frames/s per card at 368x656 (the reference's headline
configuration).

Counterpart of the repository's `bench.py`, with its rows and its one JSON
line on stdout:
  {"metric": ..., "value": N, "unit": "frames/s/chip", "vs_baseline": N,
   ...}
Baseline: 22 f/s BODY_25 at 368x656 on a GTX 1080 Ti, display included
(BASELINE.md, arXiv:1812.08008).

Method: every device row is `utils/benchmark.py::chain_ms`, n
data-dependent applications of a step (its inputs take the carry, `fold`
sums every output into it) and the difference of two chain lengths.  The
host dispatches every application, so where the host is slower than the
card the row measures the host.  Before a chain is timed, one
application runs with torch's sync debug mode set to raise: a step that
waits for the card (an `.item()`, a `nonzero`, a copy from pageable host
memory) would time round trips, and it fails the run.  Beside every
chained row, stderr gets the kernel ms and launches a call from
`device_busy` (on the card), which tell a host-bound row from a
device-bound one.

Workload: seeded random weights, whose heatmaps saturate NMS with noise
that a trained net never gives.  So the headline sums (a) the CNN forward
on random images and (b) the post-processing (Catmull-Rom resize of the
part maps, NMS at 127 peaks, PAF scores) on synthetic 8-person net outputs
rendered by `train.make_targets`, the injection point of the reference's
Datum::poseNetOutput.  `crowd32_fps` feeds 32 `synthetic.random_people` a
frame; `worst_case_fps` feeds net outputs of uniform noise, whose every
part fills the 127-peak budget.  The port has no peak-tier ladder, so the
three post rows run one program and differ by content only.  Host assembly
is left out of the device rows; `batch1_assembly_ms` measures it.

The host-tail and disk-to-keypoints rows need the native frame pump (built
with OpenCV) and a video (`--video`, e.g. the reference's
`examples/media/video.avi`); without either they are not measured (the
`host_tail_fps`/`tail_only_fps` keys are left out and
`e2e_disk_to_keypoints_fps` is 0.0) and stderr says why.  Every other row
that fails raises: nothing is caught.  A row whose implied CNN rate
exceeds the card's bf16 peak by more than 2% (`_roofline_ok`) is withheld:
its frames/s is published as 0.0.

Usage:
  python -m openpose_tpu_torch.bench [--video PATH]
Runs on the card; `--cpu` runs on the CPU, and `--rehearse` swaps every
shape for a tiny one (the CPU rehearsal the tests run).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import pathlib
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.models import graph, zoo
from openpose_tpu_torch.ops import nms, paf, resize
from openpose_tpu_torch.params import POSE_MAX_PEOPLE, PoseModel
from openpose_tpu_torch.utils import benchmark

BASELINE_FPS = 22.0
# the roofline guard's slack over the datasheet peak
ROOF_SLACK = 1.02

_T0 = time.perf_counter()


def _progress(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Shapes:
    """Every size the rows run at, and the chain lengths (n_lo, n_hi)."""
    net_hw: Tuple[int, int]
    batch: int
    crop: int                       # face and hand net input side
    crop_people: int                # faces a frame; hands are twice as many
    multiscale_hw: Tuple[int, int]  # scale 0 of the 4-scale row
    multiscale_batch: int
    ap_images: int
    ap_batch: int
    topdown_frames: int
    topdown_batch: int
    e2e_batch: int
    assembly_reps: int
    geometry_reps: int
    long: Tuple[int, int]
    crowd: Tuple[int, int]
    short: Tuple[int, int]
    retry: Tuple[int, int]
    reps: int


# the original's sizes and chain lengths
PUBLISHED = Shapes(
    net_hw=(368, 656), batch=8, crop=368, crop_people=4,
    multiscale_hw=(736, 1312), multiscale_batch=4, ap_images=32, ap_batch=8,
    topdown_frames=8, topdown_batch=8, e2e_batch=32, assembly_reps=50,
    geometry_reps=200, long=(2, 22), crowd=(2, 12), short=(2, 8),
    retry=(2, 44), reps=3)
REHEARSAL = Shapes(
    net_hw=(64, 96), batch=2, crop=64, crop_people=2,
    multiscale_hw=(64, 96), multiscale_batch=2, ap_images=2, ap_batch=2,
    topdown_frames=2, topdown_batch=2, e2e_batch=2, assembly_reps=2,
    geometry_reps=2, long=(1, 2), crowd=(1, 2), short=(1, 2), retry=(1, 3),
    reps=1)


class Post:
    """The headline rows' post-processing on the device: Catmull-Rom
    resize of the part maps to the net input, NMS (0.05, 127 peaks), PAF
    pair scores (the fused kernel at this budget)."""

    def __init__(self, info, net_hw: Tuple[int, int], device: torch.device):
        self.num_parts = info.num_parts
        self.net_hw = net_hw
        self.pairs, self.map_idx = (torch.from_numpy(t).to(device)
                                    for t in paf.pair_tables(info))

    def paf_args(self, src: torch.Tensor) -> tuple:
        """The PAF stage's arguments for net outputs src [N, h, w, C]
        (`paf.paf_scores_multiscale`'s, and the fused kernel's)."""
        merged = resize.resize_bicubic(src[..., :self.num_parts],
                                       self.net_hw)
        peaks = nms.nms(merged, 0.05, POSE_MAX_PEOPLE)
        return ((src,), (1.0,), self.net_hw, peaks, self.pairs, self.map_idx,
                0.05, 0.95, 0.05)

    @torch.inference_mode()
    def __call__(self, src: torch.Tensor):
        args = self.paf_args(src)
        return args[3], paf.paf_scores_multiscale(*args)


def headline_inputs(info, device: torch.device, shapes: Shapes
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The headline rows' inputs on the device, the original's draw: the
    images [batch, h, w, 3] (uniform 0..255) and the post rows' net
    outputs [batch, h/8, w/8, C]: "synth" (8 people a frame), "crowd" (32
    `random_people` a frame) and "worst" (uniform noise in [-1, 1): every
    part fills the peak budget at the published size)."""
    from openpose_tpu_torch import synthetic, train
    (net_h, net_w), batch, parts = shapes.net_hw, shapes.batch, info.num_parts
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf.pair_tables(info))

    def render(kp):
        return train.make_targets(torch.from_numpy(kp).to(device), pairs,
                                  map_idx, (net_h, net_w), parts,
                                  info.heatmap_channels)
    rng = np.random.RandomState(0)
    images = rng.uniform(0, 255, (batch, net_h, net_w, 3)).astype(np.float32)
    kp = np.zeros((batch, 8, parts, 3), np.float32)
    for b in range(batch):
        for p in range(8):
            cx = rng.uniform(60, net_w - 60)
            cy = rng.uniform(80, net_h - 80)
            kp[b, p, :, 0] = cx + rng.uniform(-40, 40, parts)
            kp[b, p, :, 1] = cy + rng.uniform(-70, 70, parts)
            kp[b, p, :, 2] = 1.0
    kp32 = np.stack([synthetic.random_people(
        np.random.RandomState(100 + b), 32, (net_h, net_w),
        min_spacing=30.0)[:, :parts] for b in range(batch)])
    noise = np.random.RandomState(3).uniform(
        -1, 1, (batch, net_h // 8, net_w // 8, info.heatmap_channels))
    return torch.from_numpy(images).to(device), {
        "synth": render(kp), "crowd": render(kp32),
        "worst": torch.from_numpy(noise.astype(np.float32)).to(device)}


def multiscale_inputs(model, device: torch.device, shapes: Shapes):
    """(`PoseInference` of the 4-scale row, its frames on the device)."""
    from openpose_tpu_torch.parallel.inference import PoseInference
    inference = PoseInference(model, net_hw=shapes.multiscale_hw,
                              scale_number=4, scale_gap=0.25, max_peaks=16,
                              nms_threshold=0.05, device=device)
    frames = np.random.RandomState(2).uniform(
        0, 255, (shapes.multiscale_batch, *shapes.multiscale_hw, 3))
    return inference, torch.from_numpy(frames.astype(np.float32)).to(device)


def _no_host_sync(label: str, step, device: torch.device) -> None:
    """One application of a chained step with torch's sync debug mode set
    to raise (after one that warms it up): a step that waits for the card
    would make `chain_ms` time round trips."""
    if device.type != "cuda":
        return
    carry = torch.zeros((), device=device)
    step(carry)
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(carry)
    except RuntimeError as exc:
        raise RuntimeError(f"{label}: a chained step waits for the card; "
                           f"chain_ms would time round trips") from exc
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _chained(label: str, step, device: torch.device, chain: Tuple[int, int],
             shapes: Shapes, traces: dict) -> float:
    """chain_ms of step after `_no_host_sync`; on the card the step's
    `device_busy` trace goes to stderr and into traces[label]."""
    _no_host_sync(label, step, device)
    ms = benchmark.chain_ms(step, *chain, reps=shapes.reps, device=device)
    trace = None
    if device.type == "cuda":
        carry = torch.zeros((), device=device)
        trace = benchmark.device_busy(lambda: step(carry), 3)
    traces[label] = {"chain_ms": ms, "trace": trace}
    if trace is None:
        _progress(f"{label}: {ms:.3f} ms a call chained; kernels not "
                  "measured (no card)")
    else:
        _progress(f"{label}: {ms:.3f} ms a call chained; kernels "
                  f"{trace['device_ms_per_call']:.3f} ms and "
                  f"{trace['device_launches_per_call']:.0f} launches a call,"
                  f" busy {trace['busy_share']:.0%} of the traced wall")
    return ms


def _roofline_ok(label: str, gflops_per_frame: float, ms_per_frame: float,
                 device_kind: str) -> bool:
    """Refuse to publish a rate the card cannot reach: False (and the
    caller withholds the row) where the implied CNN rate exceeds the
    card's dense bf16 peak (`utils/benchmark.py`) by more than 2%, which
    means the timed program skipped some of the claimed work.  True with
    no basis where the table has no rate (the CPU)."""
    peak = benchmark.bf16_peak_tflops(device_kind)
    if not peak or not ms_per_frame:
        return True
    # GFLOP a frame over ms a frame is TFLOP/s
    implied = gflops_per_frame / ms_per_frame
    if implied > peak * ROOF_SLACK:
        print(f"ROOFLINE GUARD: {label} implies {implied:.0f} TFLOP/s "
              f"> peak {peak:.0f} of {device_kind}: measurement invalid, "
              "row WITHHELD", file=sys.stderr)
        return False
    print(f"roofline: {label} implies {implied:.0f} TFLOP/s "
          f"({implied / peak:.0%} of {peak:.0f} peak) [ok]", file=sys.stderr)
    return True


def _gflops(spec, hw) -> float:
    return sum(graph.count_flops(spec, hw).values()) / 1e9




def _ratio(num: float, den: float) -> float:
    """num / den, 0.0 where den is not positive: a chain whose longer run
    was no slower than its shorter one measured nothing, and a rate of 0.0
    shows it."""
    return num / den if den > 0 else 0.0


@torch.inference_mode()
def run(device: torch.device, shapes: Shapes = PUBLISHED,
        video: Optional[str] = None) -> Tuple[dict, dict]:
    """Every row on `device`: (the JSON row, {chained step: its chain_ms
    and, on the card, its `device_busy` trace})."""
    _progress(f"loading BODY_25 on {device}")
    model = zoo.load_pose_model(PoseModel.BODY_25, seed=0, device=device)
    batch = shapes.batch
    post = Post(model.info, shapes.net_hw, device)
    images, sources = headline_inputs(model.info, device, shapes)
    _progress("synthetic targets ready")
    traces: dict = {}

    def step_net(c):
        out = model.forward(resize.normalize_vgg(images + c * 1e-12),
                            torch.bfloat16)
        return benchmark.fold(c, out)

    def step_post(src):
        return lambda c: benchmark.fold(c, *post(src + c * 1e-12))

    net_ms = _chained(f"net (batch {batch})", step_net, device, shapes.long,
                      shapes, traces)
    post_ms = _chained("post (8 people a frame)", step_post(sources["synth"]),
                       device, shapes.long, shapes, traces)
    crowd_ms = _chained("post (32 people a frame)",
                        step_post(sources["crowd"]), device, shapes.crowd,
                        shapes, traces)
    worst_ms = _chained("post (worst case, noise)",
                        step_post(sources["worst"]), device, shapes.short,
                        shapes, traces)

    # CNN rate against the card's datasheet peak
    gflops_frame = _gflops(model.spec, shapes.net_hw)
    kind = benchmark.device_name(device)
    peak = benchmark.bf16_peak_tflops(kind)
    withheld = False
    if not _roofline_ok("cnn_headline", gflops_frame, net_ms / batch, kind):
        # one retry with a longer chain; if the rate is still impossible
        # the headline publishes as 0.0
        _progress(f"re-measuring the net chain ({shapes.retry}) after the "
                  "roofline guard")
        net_ms = _chained(f"net (batch {batch}, longer chain)", step_net,
                          device, shapes.retry, shapes, traces)
        withheld = not _roofline_ok("cnn_headline_retry", gflops_frame,
                                    net_ms / batch, kind)
    achieved_tflops = _ratio(gflops_frame, net_ms / batch)
    mfu = _ratio(achieved_tflops, peak)
    fps = 0.0 if withheld else _ratio(1000.0 * batch, net_ms + post_ms)
    crowd_fps = _ratio(1000.0 * batch, net_ms + crowd_ms)
    worst_fps = _ratio(1000.0 * batch, net_ms + worst_ms)
    peaks_a_part = {name: float(post(src)[0][:, :, 0, 0].mean())
                    for name, src in sources.items()}
    print(f"batch={batch}: net {net_ms / batch:.3f} ms/frame, post "
          f"{post_ms / batch:.3f} ms/frame -> {fps:.1f} frames/s",
          file=sys.stderr)
    print(f"crowd (32 people a frame): post {crowd_ms / batch:.3f} ms/frame "
          f"-> {crowd_fps:.1f} frames/s", file=sys.stderr)
    print(f"worst case (uniform noise): post {worst_ms / batch:.3f} ms/frame"
          f" -> {worst_fps:.1f} frames/s", file=sys.stderr)
    print(f"peaks a part (mean): {json.dumps(peaks_a_part)}",
          file=sys.stderr)
    print(f"CNN: {gflops_frame:.1f} GFLOP/frame @ {net_ms / batch:.3f} "
          f"ms/frame = {achieved_tflops:.1f} TFLOP/s on {kind} (bf16 peak "
          f"{peak:.1f}) -> MFU {mfu:.1%}", file=sys.stderr)

    batch1 = _bench_batch1(model, images, sources["synth"], post, device,
                           shapes, traces)
    wb = _bench_whole_body(device, shapes, net_ms, post_ms, gflops_frame,
                           kind, traces)
    ms4 = _bench_multiscale(model, device, shapes, kind, traces)
    e2e_fps = _bench_end_to_end(model, device, shapes, video)
    tail = _bench_host_tail(model, post, device, shapes, video)
    ap = _bench_synthetic_ap(model, device, shapes)
    td_acc = _bench_topdown_accuracy(device, shapes)

    # in the runner the host tail (decode, assembly, JSON) overlaps the
    # device, so a host that keeps up sustains min(device, host tail)
    host_tail_fps = tail.get("host_tail_fps", 0.0)
    colocated = round(min(fps, host_tail_fps), 2) if host_tail_fps else 0.0
    row = {
        "metric": "BODY_25 368x656 device pipeline frames/s/chip (batch 8)",
        "value": round(fps, 2),
        "unit": "frames/s/chip",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "worst_case_fps": round(worst_fps, 2),
        "crowd32_fps": round(crowd_fps, 2),
        "e2e_disk_to_keypoints_fps": e2e_fps,
        "e2e_colocated_est_fps": colocated,
        **tail,
        "synthetic_ap": ap["AP"],
        "synthetic_ap50": ap["AP50"],
        "synthetic_ar": ap["AR"],
        "face_rmse_px": td_acc["face_rmse_px"],
        "hand_rmse_px": td_acc["hand_rmse_px"],
        "cnn_gflops_per_frame": round(gflops_frame, 1),
        "cnn_tflops": round(achieved_tflops, 1),
        "cnn_mfu": round(mfu, 3),
        "device_kind": kind,
        **batch1,
        **wb,
        **ms4,
    }
    return row, traces


def _bench_batch1(model, images, synth, post, device, shapes,
                  traces) -> dict:
    """One frame at a time, as the reference's real-time figure runs: the
    batch-1 net and post chains, the host assembly of one frame's peaks
    and scores (single thread, `PoseExtractor.assemble`), and their sum
    as the frame's latency."""
    from openpose_tpu_torch.pose.extractor import PoseExtractor
    img1, synth1 = images[:1], synth[:1]

    def step_net1(c):
        out = model.forward(resize.normalize_vgg(img1 + c * 1e-12),
                            torch.bfloat16)
        return benchmark.fold(c, out)

    def step_post1(c):
        return benchmark.fold(c, *post(synth1 + c * 1e-12))

    net1_ms = _chained("batch-1 net", step_net1, device, shapes.long, shapes,
                       traces)
    post1_ms = _chained("batch-1 post", step_post1, device, shapes.long,
                        shapes, traces)
    peaks, scores = post(synth1)
    pk_np, sc_np = peaks[0].cpu().numpy(), scores[0].cpu().numpy()
    extractor = PoseExtractor(model, device=device)
    extractor.assemble(pk_np, sc_np, 1.0)           # warm
    t0 = time.perf_counter()
    for _ in range(shapes.assembly_reps):
        extractor.assemble(pk_np, sc_np, 1.0)
    asm_ms = (time.perf_counter() - t0) / shapes.assembly_reps * 1e3
    device_ms = net1_ms + post1_ms
    latency = device_ms + asm_ms
    print(f"batch-1: net {net1_ms:.3f} + post {post1_ms:.3f} + assembly "
          f"{asm_ms:.3f} ms -> latency {latency:.3f} ms "
          f"({_ratio(1000.0, device_ms):.1f} f/s device)", file=sys.stderr)
    return {
        "batch1_fps": round(_ratio(1000.0, device_ms), 2),
        "batch1_latency_ms": round(latency, 2),
        "batch1_net_ms": round(net1_ms, 3),
        "batch1_post_ms": round(post1_ms, 3),
        "batch1_assembly_ms": round(asm_ms, 3),
    }


def _bench_whole_body(device, shapes, net_ms, post_ms, body_gflops, kind,
                      traces) -> dict:
    """The whole-body cascade: BODY_25 + face + 2 hands a person, batch 8,
    4 people a frame, every crop slot active (the top-down stages' worst
    case; the reference loops over crops, one batched call a stage covers
    them all here).  The stages share the card, so the cascade's time is
    the sum of the three device calls.  The "typical" row passes the same
    caps with only the first 2 faces and 4 hands active: the port crops
    the leading active slots.  The host geometry between the stages
    (face and hand rectangles from body keypoints) is timed apart."""
    from openpose_tpu_torch import synthetic
    from openpose_tpu_torch.face.detector import detect_faces
    from openpose_tpu_torch.hand.detector import detect_hands
    from openpose_tpu_torch.ops import warp
    from openpose_tpu_torch.parallel.inference import TopDownInference
    batch, people, crop = shapes.batch, shapes.crop_people, shapes.crop
    h, w = shapes.net_hw
    _progress("whole-body: building face/hand stages")
    face_model = zoo.load_face_model(device=device)
    hand_model = zoo.load_hand_model(device=device)
    face_td = TopDownInference(face_model, net_size=crop, people_cap=people,
                               device=device)
    hand_td = TopDownInference(hand_model, net_size=crop,
                               people_cap=2 * people, device=device)
    rng = np.random.RandomState(1)
    frames = torch.from_numpy(rng.uniform(
        0, 255, (batch, h, w, 3)).astype(np.float32)).to(device)

    def rand_transforms(cap, mirror_alt):
        tr = np.zeros((batch, cap, 4), np.float32)
        for b in range(batch):
            for s in range(cap):
                side = rng.uniform(60, 140)
                x = rng.uniform(0, w - side)
                y = rng.uniform(0, h - side)
                tr[b, s] = warp.rect_to_transform(
                    (x, y, side, side), crop, mirror_alt and s % 2 == 0)
        return tr

    def stage_step(td, transforms):
        return lambda c: benchmark.fold(c, td(frames + c * 1e-12,
                                              transforms))

    face_tr = rand_transforms(people, False)
    hand_tr = rand_transforms(2 * people, True)
    face_ms = _chained("whole-body face (all active)",
                       stage_step(face_td, face_tr), device, shapes.short,
                       shapes, traces)
    hand_ms = _chained("whole-body hands (all active)",
                       stage_step(hand_td, hand_tr), device, shapes.short,
                       shapes, traces)

    typical = people // 2
    inactive = np.asarray(TopDownInference.INACTIVE, np.float32)
    face_typ = np.tile(inactive, (batch, people, 1))
    face_typ[:, :typical] = face_tr[:, :typical]
    hand_typ = np.tile(inactive, (batch, 2 * people, 1))
    hand_typ[:, :2 * typical] = hand_tr[:, :2 * typical]
    ft = TopDownInference.active_slots(face_typ)
    ht = TopDownInference.active_slots(hand_typ)
    face_t_ms = _chained("whole-body face (typical)",
                         stage_step(face_td, face_typ), device, shapes.short,
                         shapes, traces)
    hand_t_ms = _chained("whole-body hands (typical)",
                         stage_step(hand_td, hand_typ), device, shapes.short,
                         shapes, traces)

    kp = synthetic.random_people(rng, people, (h, w))
    t0 = time.perf_counter()
    for _ in range(shapes.geometry_reps):
        for r in detect_faces(kp, PoseModel.BODY_25):
            warp.rect_to_transform(r, crop, False)
        for left, right in detect_hands(kp, PoseModel.BODY_25):
            warp.rect_to_transform(left, crop, True)
            warp.rect_to_transform(right, crop, False)
    geom_ms = (time.perf_counter() - t0) / shapes.geometry_reps * 1e3

    face_gflops = _gflops(face_model.spec, (crop, crop))
    hand_gflops = _gflops(hand_model.spec, (crop, crop))
    total_gflops = body_gflops + people * face_gflops \
        + 2 * people * hand_gflops
    frame_ms = (net_ms + post_ms + face_ms + hand_ms) / batch
    fps = _ratio(1000.0, frame_ms)
    tflops = _ratio(total_gflops, frame_ms)
    mfu = _ratio(tflops, benchmark.bf16_peak_tflops(kind))
    typ_frame_ms = (net_ms + post_ms + face_t_ms + hand_t_ms) / batch
    typ_fps = _ratio(1000.0, typ_frame_ms)
    typ_gflops = body_gflops + ft * face_gflops + ht * hand_gflops
    print(f"whole-body ({people} people, all crops active): body "
          f"{(net_ms + post_ms) / batch:.3f} + face {face_ms / batch:.3f} + "
          f"hands {hand_ms / batch:.3f} ms/frame -> {fps:.1f} frames/s, "
          f"{total_gflops:.0f} GFLOP/frame, MFU {mfu:.1%} (host geometry "
          f"{geom_ms:.3f} ms/frame, apart)", file=sys.stderr)
    print(f"whole-body typical ({typical} people; the leading {ft} face and "
          f"{ht} hand slots cropped): face {face_t_ms / batch:.3f} + hands "
          f"{hand_t_ms / batch:.3f} ms/frame -> {typ_fps:.1f} frames/s",
          file=sys.stderr)
    if not _roofline_ok("whole_body", total_gflops, frame_ms, kind):
        fps = 0.0
    if not _roofline_ok("whole_body_typical", typ_gflops, typ_frame_ms,
                        kind):
        typ_fps = 0.0
    return {
        "whole_body_fps": round(fps, 2),
        "whole_body_face_ms": round(face_ms / batch, 3),
        "whole_body_hand_ms": round(hand_ms / batch, 3),
        "whole_body_gflops_per_frame": round(total_gflops, 1),
        "whole_body_mfu": round(mfu, 3),
        "whole_body_host_geom_ms": round(geom_ms, 3),
        "whole_body_typical_fps": round(typ_fps, 2),
        "whole_body_typical_face_ms": round(face_t_ms / batch, 3),
        "whole_body_typical_hand_ms": round(hand_t_ms / batch, 3),
    }


def _bench_multiscale(model, device, shapes, kind, traces) -> dict:
    """The reference's maximum-accuracy configuration (doc/01_demo.md:
    --net_resolution 1312x736 --scale_number 4 --scale_gap 0.25) through
    `PoseInference` at batch 4 with a 16-peak budget, the people-capped
    path: the sampled PAF backend and the hand-written sampler.  FLOPs
    are summed over the four scales' net inputs."""
    _progress("multi-scale: building the 4-scale program")
    inference, frames = multiscale_inputs(model, device, shapes)

    def step(c):
        return benchmark.fold(c, *inference(frames + c * 1e-12))

    ms = _chained("multiscale4", step, device, shapes.short, shapes, traces)
    gflops = sum(_gflops(model.spec, (h, w))
                 for w, h in inference.plan.net_input_sizes)
    batch = shapes.multiscale_batch
    fps = _ratio(1000.0 * batch, ms)
    h, w = shapes.multiscale_hw
    print(f"max-accuracy (4 scales, {w}x{h} scale 0): {ms / batch:.3f} "
          f"ms/frame -> {fps:.2f} frames/s ({gflops:.0f} GFLOP/frame)",
          file=sys.stderr)
    if not _roofline_ok("multiscale4", gflops, ms / batch, kind):
        fps = 0.0
    return {"multiscale4_fps": round(fps, 3),
            "multiscale4_gflops_per_frame": round(gflops, 1)}


def _bench_topdown_accuracy(device, shapes) -> dict:
    """Face and hand localisation through the real top-down decode
    (`accuracy.synthetic_topdown_eval`): frame-pixel RMSE at the crop
    size."""
    from openpose_tpu_torch.accuracy import synthetic_topdown_eval
    out = {}
    for kind, seed in (("face", 0), ("hand", 1)):
        _progress(f"topdown accuracy: {kind} closed loop")
        m = synthetic_topdown_eval(kind, n_frames=shapes.topdown_frames,
                                   batch=shapes.topdown_batch, seed=seed,
                                   net_size=shapes.crop, device=device)
        print(f"{kind} RMSE {m['rmse_px']:.3f} px (PCK05 {m['pck05']:.3f}, "
              f"n={m['n_instances']})", file=sys.stderr)
        out[f"{kind}_rmse_px"] = round(m["rmse_px"], 3)
    return out


def _bench_synthetic_ap(model, device, shapes) -> dict:
    """Synthetic COCO AP through the closed loop (net-output injection,
    assembly, the COCO JSON saver and evaluator):
    `accuracy.synthetic_coco_eval`."""
    from openpose_tpu_torch.accuracy import synthetic_coco_eval
    _progress(f"synthetic AP: closed loop ({shapes.ap_images} images)")
    m = synthetic_coco_eval(n_images=shapes.ap_images, net_hw=shapes.net_hw,
                            batch=shapes.ap_batch, seed=0, model=model,
                            device=device)
    print(f"synthetic AP={m['AP']:.4f} AP50={m['AP50']:.4f} AR={m['AR']:.4f}"
          f" ({m['n_detections']} dets / {m['n_gt']} gt)", file=sys.stderr)
    return {k: round(float(m[k]), 4) for k in ("AP", "AP50", "AP75", "AR")}


def _media_missing(video: Optional[str]) -> Optional[str]:
    """Why the decoder-bound rows cannot run, or None where they can."""
    if video is None:
        return "no --video given"
    if not pathlib.Path(video).exists():
        return f"no video at {video}"
    from openpose_tpu_torch.io.native_loader import available
    if not available():
        return "the native frame pump (built with OpenCV) is not available"
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench_host_tail(model, post, device, shapes, video) -> dict:
    """The host tail's capacity: disk -> keypoints JSON with the device
    stage replaced by one frame's precomputed peaks and scores (4
    people): the native decode pump, thread-pool assembly and the people
    JSON saver, and that tail alone without decoding.  It shows whether
    the host keeps up with the device in the runner."""
    from openpose_tpu_torch import synthetic, train
    from openpose_tpu_torch.io import json_io
    from openpose_tpu_torch.io.native_loader import NativeVideoPump
    from openpose_tpu_torch.pose.extractor import PoseExtractor
    reason = _media_missing(video)
    if reason is not None:
        _progress(f"host tail: {reason}; not measured")
        return {}
    _progress("host tail: preparing the device outputs")
    info, (h, w) = model.info, shapes.net_hw
    people = synthetic.random_people(np.random.RandomState(0), 4, (h, w))
    tgt = train.make_targets(torch.from_numpy(people[None]).to(device),
                             post.pairs, post.map_idx, (h, w),
                             info.num_parts, info.heatmap_channels)
    peaks, scores = post(tgt)
    peaks, scores = peaks[0].cpu().numpy(), scores[0].cpu().numpy()
    extractor = PoseExtractor(model, device=device)

    with tempfile.TemporaryDirectory(prefix="host_tail_") as out_dir:
        def tail_one(idx):
            kp, _ = extractor.assemble(peaks, scores, 1.0)
            json_io.save_people_json(
                f"{out_dir}/{idx:012d}_keypoints.json", pose_keypoints=kp)
            return idx

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            list(pool.map(tail_one, range(32)))           # warm
            t0 = time.perf_counter()
            list(pool.map(tail_one, range(400)))
            tail_only = 400 / (time.perf_counter() - t0)
        print(f"host tail only (assembly + JSON, 2 threads): "
              f"{tail_only:.1f} frames/s", file=sys.stderr)

        best = 0.0
        for threads in (2, 3, 2):
            pump = NativeVideoPump(video, w, h, threads=threads, capacity=64)
            try:
                with concurrent.futures.ThreadPoolExecutor(threads) as pool:
                    futures, n = [], 0
                    t0 = time.perf_counter()
                    while True:    # batched pop: one GIL-releasing call / 8
                        item = pump.next_batch(8)
                        if item is None:
                            break
                        for _ in range(item[0]):
                            futures.append(pool.submit(tail_one, n))
                            n += 1
                    for f in futures:
                        f.result()
                    dt = time.perf_counter() - t0
            finally:
                pump.close()
            best = max(best, n / dt)
    print(f"host tail (decode + assembly + JSON, device stage precomputed):"
          f" {best:.1f} frames/s", file=sys.stderr)
    return {"host_tail_fps": round(best, 2),
            "tail_only_fps": round(tail_only, 2)}


def _bench_end_to_end(model, device, shapes, video) -> float:
    """Disk -> keypoints frames/s through the user path: the native decode
    pump, uint8 batches of 32 uploaded to the card, batched
    `PoseInference`, fetch and host assembly (`VideoRunner.run_video`, the
    CLI's video path), best of three runs after a warm one.  Random
    weights saturate every peak budget, so it runs people-capped (16
    peaks) with an NMS threshold that gives random activations a trained
    net's peak counts.  An upload probe times the host-to-card copy of
    one batch beside it."""
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.runtime.video_runner import VideoRunner
    reason = _media_missing(video)
    if reason is not None:
        _progress(f"e2e: {reason}; not measured")
        return 0.0
    buf = torch.zeros((shapes.e2e_batch, *shapes.net_hw, 3),
                      dtype=torch.uint8)
    buf.to(device)                                  # warm
    _sync(device)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        buf.to(device)
        _sync(device)
        rates.append(buf.numel() / (time.perf_counter() - t0) / 1e6)
    print(f"e2e: host-to-card upload ~{max(rates):.0f} MB/s (reps: "
          f"{', '.join(f'{r:.0f}' for r in rates)})", file=sys.stderr)

    _progress("e2e: building the people-capped pipeline")
    inference = PoseInference(model, net_hw=shapes.net_hw, max_peaks=16,
                              nms_threshold=2.0, device=device)
    runner = VideoRunner(inference, batch_size=shapes.e2e_batch,
                         max_in_flight=6)
    runner.run_video(video, max_frames=64)          # warm
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = runner.run_video(video)
        rates.append(len(res) / (time.perf_counter() - t0))
    print(f"e2e disk->keypoints (batch {shapes.e2e_batch}, people-capped): "
          f"{max(rates):.1f} frames/s (reps: "
          f"{', '.join(f'{r:.1f}' for r in rates)})", file=sys.stderr)
    return round(max(rates), 2)


def main(argv=None) -> Tuple[dict, dict]:
    """Prints the JSON row as one line; returns (row, chained-step
    traces) as `run` does."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny shapes everywhere (a CPU rehearsal)")
    ap.add_argument("--video",
                    help="a video for the host-tail and disk-to-keypoints "
                         "rows (they also need the native frame pump)")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu \
        else device_rule.default_device()
    if device.type == "cuda":
        # the heatmap path in full float32: TF32 resizing makes flat-top
        # peaks, which the strict NMS rule then drops
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
    row, traces = run(device, REHEARSAL if args.rehearse else PUBLISHED,
                      args.video)
    print(json.dumps(row), flush=True)
    return row, traces


if __name__ == "__main__":
    main()
