#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`openpose_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, `nvcc` (CUDA_HOME or /usr/local/cuda) and the
repository; it imports nothing of JAX.  Phases, each of which ends the run
with a non-zero exit when it fails:

1. device: the card's name and power limit;
2. build: compiles `openpose_tpu_torch/kernels/*.cu` for sm_90a;
3. kernel: the PAF scoring kernel against its plain PyTorch version, both
   on the card, on small scenes (peak counts of 0, 1 and the whole budget,
   a budget that is no multiple of the lanes of a line, every staging
   layout) and at the full BODY_25 shape (batch 8, 26 pairs, K = 127,
   46x82 low-res maps); both timed with CUDA events and held against the
   kernel's bound;
4. sampler: the bicubic sampling kernel against its plain version on the
   JAX suite's scene, a non-integer scale, a ragged sample count, large
   planes, every staging choice, the multi-scale entry and the profile
   shape (8 frames x 26 pairs x 403,225 samples at 46x82); the profile
   shape is timed and held against the bound;
5. main path: BODY_25 (seeded random weights) through `PoseExtractor` on
   720x1280 frames at net resolution 368x656 in float32 and bfloat16, and
   through batch-8 `PoseInference`, timed; the PAF kernel's launch count in
   this phase must be > 0; a per-stage breakdown (with the sampled PAF
   backend timed against the fused one at K = 127) and a CPU-vs-GPU check
   of the CNN follow;
6. people-capped multi-scale: batch-4 `PoseInference` at 4 scales of
   736x1312 with a 16-peak budget, on pre-sized frames and on 1080x1920
   raw frames; the sampler must launch and the fused kernel must not; the
   sampler is held to its plain version on this path's tensors, and the
   PAF stage is timed routed (sampled) against forced fused;
7. whole body: BODY_25 + FACE + HAND at 720x1280, batch 4, people cap 8,
   timed per stage; the batched face and hand keypoints are held to the
   per-crop extractors, and injected people must come back with face and
   hand crops around them;
8. injection: a synthetic BODY_25 net output with known people goes
   through `PoseExtractor.forward(net_output=...)` and must assemble exactly
   those people, written out as people JSON;
9. wrapper: a `Wrapper` (BODY_25 + face + hand, 4 people kept, bf16) on
   720x1280 frames: plain `process`, with top-down refinement, with
   `tracking=1` over 8 frames of one scene moved by a known shift (the LK
   frames must carry the kept keypoints by that shift), and with injected
   people; per-stage times, CNN frames against LK frames, LK's launches
   and device-busy share, and LK on the card against LK on the CPU;
10. runner: `VideoRunner`'s batch loop over batch-8 `PoseInference`, 4
   batches of frames in memory, held to the sequential path on the same
   frames; frames/s by assembly workers and batches in flight;
11. accuracy: the closed loop in float32: `accuracy.synthetic_coco_eval`
   (64 scenes of 1-4 placed people, rendered as net outputs, decoded by
   the real path) must reach AP 0.95 at 368x656 and 0.90 at 176x320,
   `synthetic_topdown_eval` an RMSE under 2 px for faces and hands; the
   fused kernel against its plain version on one of the loop's batches,
   and where such a batch's time goes;
12. train: one loss and its gradients at BODY_25's full width on the card
   against the CPU in float64 (three readings of the card, the
   convolution kernels that ran, a TF32 run as the control);
   `train_loop.train` at 368x368, batch 8, in float32
   and with bfloat16 operands (step time and its parts, fed rate, FLOP
   rate against the datasheet peak, memory; the loss must fall); the
   checkpoint it wrote, loaded into a serving model, must answer bit for
   bit as the trained net; `accuracy.train_to_ap` at 184x328 (1500 cosine
   steps), and
   the fused kernel against its plain version on a held-out frame of the
   net it trained (1 frame, 22x40 maps, that net's peaks);
13. cli: the user entry points on the net `train_to_ap` trained, frames
   reaching the CLI from memory (the card's machine has no OpenCV): the
   CLI's `Wrapper` path on 16 held-out frames, its JSON bit-equal to
   `Wrapper.process`, people found == placed on 14 or more; the CLI at its
   defaults on 720x1280 frames; `--3d` over three views with cameras
   written by `threed/camera.py`, and `reconstruct_array` on 8 people x 4
   cameras on the card against the CPU and the truth; `pyopenpose` at
   render_pose 0, `capi` and its C shim (built where the machine has
   Python's headers), each bit-equal to the CLI;
14. threed: the rest of 3-D at ROADMAP's 3-D row (8 people x 25 parts x 4
   cameras, 1280x720): `accuracy3d.bundle_eval` and `bundle_adjust` on
   the card against the CPU (equal within 1e-3, the JAX suite's recovery
   gates), their time, launches per LM iteration and card-busy share; the
   sharded `bundle_adjust` over a one-rank NCCL mesh equal to the
   unsharded one; `accuracy3d.noise_sweep` card against CPU; the VisualSFM
   `.sift` and match files written and read back (the calibration modes
   need OpenCV, which the card's machine lacks).

The kernel phase also holds the fused kernel to its plain version at the
refinement's shape (8 crops of 368x368, thresholds 0.02 and 0.01).

`python3 chip_smoke.py --capped-trace` runs the people-capped call alone,
timed and traced (to set two trees side by side on one card).
`python3 chip_smoke.py --train-to-ap` trains BODY_25 from scratch for 1500
steps (cosine schedule) and scores it through the whole pipeline, then
serves the trained net from its checkpoint: the fused kernel against its
plain version on a held-out frame, batch-8 `PoseInference` on held-out
scenes and one frame through `Wrapper`s that load the checkpoint, without
and with refinement (details in build/chip_smoke/train_to_ap.json).

Each path's kernel launches are also counted for one call.  A kernel's
bound is the least time the card could take for the same work: the larger
of its bytes (each input read once, each output written once) over the
card's memory rate and its float operations (counted from this run's peak
counts and line lengths) over the card's float32 rate.  The line before the
last is the kernel summary, the last line {"ok": true, "device": {...}}.  Details go to build/chip_smoke/chip_smoke.json.
The default run took 413 s on one H100 80GB HBM3 at 700 W, the build and
every phase included, when the train phase trained 400 steps (62.2 s);
its 1500 steps take 156.6 s.  `--train-to-ap` takes 175 s.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"
# Kernel vs plain version: the two run the same IEEE-rounded float32
# operations in the same order (the kernel is built with -fmad=false), so
# they are expected to agree bit for bit; 1e-5 leaves room for a last-bit
# difference in a math routine that does not cross a threshold.
KERNEL_TOL = 1e-5
# Dense peak rates of the H100 SXM5 (NVIDIA H100 datasheet), the yardstick
# of the CNN's FLOP utilisation: bf16 on tensor cores, float32 without TF32.
PEAK_TFLOPS = {"cnn_bf16": 989.4, "cnn_f32": 66.9}
# The kernels' bounds: float32 outside the tensor cores, and HBM3 (same
# datasheet).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Float operations of the PAF kernels, counted from `kernels/paf_score.cu`
# with every multiply and add on its own (the build forbids fused ones).
# Per sample and scale: 2 source coordinates (2 each), 2 x `axis_taps` (3 to
# clamp the floor, 3 for d, d^2, d^3, 17 for the four cubics), the 4x4
# window for x and y (4 rows of 7 + 7 + 4) and the 2 sums over scales.
OPS_PER_SAMPLE_SCALE = 4 + 2 * 23 + 72 + 2
# Per sample: its pixel (2 x 6), the projection (4), the threshold and sums.
OPS_PER_SAMPLE = 12 + 4 + 2
# Per line: its geometry (two roots, four divisions) and the final score.
OPS_PER_LINE = 24
# Limits of float32 gradients against a float64 run, as shares of each
# tensor's largest entry: the worst tensor and the median tensor
# (`gradient_check` says where they come from).
GRAD_WORST = 2e-2
GRAD_MEDIAN = 2e-3


def log(*args):
    print(*args, flush=True)


def timed(fn, warmup, iters, device):
    """Mean milliseconds of fn() over iters calls, after warmup calls."""
    import torch
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def host_ms(fn, iters):
    """Mean host milliseconds of fn() (work that ends in a device->host
    copy, so it is synchronised) over iters calls, after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_busy(fn, iters):
    """torch.profiler trace of iters calls of fn (work that ends in a host
    sync): the share of the host's wall time in which the card ran kernels
    or copies, their number and device time per call, and the five kernels
    with the most device time per call.  None where the trace holds no
    device events.  The profiler's own cost lengthens the wall time, so the
    share is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            launches += 1
    if not by_name:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_share": sum(by_name.values()) / wall_us,
            "wall_ms_per_call": wall_us / iters / 1e3,
            "device_ms_per_call": sum(by_name.values()) / iters / 1e3,
            "device_launches_per_call": launches / iters,
            "top_kernels_ms_per_call": [(name[:80], us / iters / 1e3)
                                        for name, us in top]}


def paf_scene(rng, counts, max_peaks, n, hw_low, n_channels, near_pair=False):
    """Random low-res PAF maps and peaks; pairs chain the parts."""
    import numpy as np
    hs, ws = hw_low
    th, tw = hs * 8, ws * 8
    n_parts = len(counts)
    src = rng.uniform(-1, 1, (n, hs, ws, n_channels)).astype(np.float32)
    peaks = np.zeros((n, n_parts, max_peaks + 1, 3), np.float32)
    for b in range(n):
        for part, cnt in enumerate(counts):
            peaks[b, part, 0, 0] = cnt
            peaks[b, part, 1:cnt + 1, 0] = rng.uniform(1, tw - 2, cnt)
            peaks[b, part, 1:cnt + 1, 1] = rng.uniform(1, th - 2, cnt)
            peaks[b, part, 1:cnt + 1, 2] = rng.uniform(0.1, 1.0, cnt)
    if near_pair:   # close-keypoint fallback: |AB| < sqrt(W*H)/150
        peaks[0, 1, 1, :2] = peaks[0, 0, 1, :2] + 0.3
    return src, peaks, (th, tw)


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from openpose_tpu_torch.ops import paf_cuda
    paf_cuda.paf_scores_fused.launches = 0
    paf_cuda.sample_bicubic_scales.launches = 0


def read_launches(path, *must_launch):
    """Every wrapper's launch count since `reset_launches`; each wrapper in
    must_launch must have launched on this path."""
    from openpose_tpu_torch.ops import paf_cuda
    counts = {w.__name__: w.launches
              for w in (paf_cuda.paf_scores_fused,
                        paf_cuda.sample_bicubic_scales)}
    log(f"{path} kernel launches: {counts}")
    for wrapper in must_launch:
        assert counts[wrapper.__name__] > 0, \
            f"the {path} did not launch {wrapper.__name__}"
    return counts


def launches_per_call(path, call):
    """Every wrapper's launch count over one call of a path."""
    from openpose_tpu_torch.ops import paf_cuda
    before = (paf_cuda.paf_scores_fused.launches,
              paf_cuda.sample_bicubic_scales.launches)
    call()
    counts = {"paf_scores_fused": paf_cuda.paf_scores_fused.launches
              - before[0],
              "sample_bicubic_scales":
                  paf_cuda.sample_bicubic_scales.launches - before[1]}
    log(f"{path}: kernel launches per call {counts}")
    return counts


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by) of a kernel that must move n_bytes and do n_ops
    float32 operations."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def fused_bound(sources, peaks, pairs, map_idx):
    """The scoring kernel's bound on these inputs.  Bytes: the PAF planes
    that map_idx names, the peaks, the scores.  Operations: those of the
    lines inside each pair's count_A x count_B block and of their n_s
    samples, from the peaks themselves."""
    import torch
    counts = peaks[:, :, 0, 0]
    xy = peaks[:, :, 1:, :2]
    k = xy.shape[2]
    a, b = pairs[:, 0].long(), pairs[:, 1].long()
    d = xy[:, b][:, :, None, :, :] - xy[:, a][:, :, :, None, :]
    linf = d.abs().amax(dim=-1)                     # [N, P, K, K]
    n_s = torch.clamp(torch.floor(torch.sqrt(5.0 * linf) + 0.5), 5, 25)
    ki = torch.arange(k, device=peaks.device)
    valid = ((ki[:, None] < counts[:, a][..., None, None])
             & (ki[None, :] < counts[:, b][..., None, None]))
    lines = int(valid.sum())
    samples = int((n_s * (valid & (d.norm(dim=-1) > 1e-6))).sum())
    n_ops = lines * OPS_PER_LINE + samples * (
        OPS_PER_SAMPLE + OPS_PER_SAMPLE_SCALE * len(sources))
    planes = len(set(map_idx.flatten().tolist()))
    n_bytes = 4 * (sum(s.shape[0] * s.shape[1] * s.shape[2] * planes
                       for s in sources)
                   + peaks.numel() + peaks.shape[0] * pairs.shape[0] * k * k)
    ms, by = bound(n_bytes, n_ops)
    return {"bound_ms": ms, "bound_by": by, "lines": lines,
            "samples": samples, "bytes": n_bytes, "operations": n_ops}


def sampler_bound(lows, my):
    """The sampler's bound: coordinates in, values out (16 + 8 bytes per
    sample) and the planes once, against its operations."""
    samples = my.numel()
    n_bytes = 24 * samples + 4 * sum(t.numel() for t in lows)
    n_ops = samples * OPS_PER_SAMPLE_SCALE * len(lows)
    ms, by = bound(n_bytes, n_ops)
    return {"bound_ms": ms, "bound_by": by, "samples": samples,
            "bytes": n_bytes, "operations": n_ops}


def kernel_phase(device, info, full_shape=(8, 46, 82, 127)):
    """Kernel vs plain version on the device; returns the summary dict."""
    import numpy as np
    import torch
    from openpose_tpu_torch.ops import paf, paf_cuda

    def both(sources, ratios, hw, peaks, pairs, map_idx, thr):
        args = ([torch.from_numpy(s).to(device) for s in sources], ratios, hw,
                torch.from_numpy(peaks).to(device),
                torch.from_numpy(pairs).to(device),
                torch.from_numpy(map_idx).to(device), *thr)
        got = paf_cuda.paf_scores_fused(*args)
        want = paf.paf_scores_multiscale_reference(*args)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return got, want, args

    rng = np.random.RandomState(3)
    pairs3 = np.array([[0, 1], [1, 2], [2, 0]], np.int32)
    map3 = np.array([[4, 5], [6, 7], [4, 7]], np.int32)
    cases = [("sparse", [4, 3, 2], False), ("close_fallback", [4, 3, 2], True),
             ("saturated", [12, 12, 12], False), ("empty_part", [0, 3, 2], False)]
    max_err = 0.0
    for name, counts, near in cases:
        src, peaks, hw = paf_scene(rng, counts, 12, 2, (11, 15), 10, near)
        got, want, _ = both([src], [1.0], hw, peaks, pairs3, map3,
                            (0.05, 0.5, 0.05))
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        log(f"kernel case {name}: max_abs_err={err} tol={KERNEL_TOL}")
        assert err <= KERNEL_TOL, name
    # a map_idx entry outside the maps: that pair scores NaN, the kernel
    # reads nothing out of bounds (the plain version is not run on it)
    bad_map = map3.copy()
    bad_map[1, 0] = 10_000
    got = paf_cuda.paf_scores_fused(
        [torch.from_numpy(src).to(device)], [1.0], hw,
        torch.from_numpy(peaks).to(device), torch.from_numpy(pairs3).to(device),
        torch.from_numpy(bad_map).to(device), 0.05, 0.5, 0.05)
    assert bool(got[:, 1].isnan().all()) and not bool(got[:, 0::2].isnan().any())
    log("kernel case bad_table: the pair outside the maps scores NaN")
    src, peaks, hw = paf_scene(rng, [5, 4, 3], 8, 2, (11, 15), 10)
    src2 = rng.uniform(-1, 1, (2, 8, 11, 10)).astype(np.float32)
    got, want, args2 = both([src, src2], [1.0, 0.73], hw, peaks, pairs3,
                            map3, (0.05, 0.5, 0.05))
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    log(f"kernel case two_scales: max_abs_err={err} tol={KERNEL_TOL}")
    assert err <= KERNEL_TOL, "two_scales"
    # the kernel's staging layouts on that scene: with the border the two
    # scales take 14 x 19 + 11 x 15 float2 (3448 bytes, the default);
    # without, 11 x 15 + 8 x 11 (2024 bytes: a 2560-byte limit); one scale
    # left in global memory (1320 bytes fit a 1536-byte limit); none staged
    if device.type == "cuda":
        for name, limit in (("unbordered", 2560), ("one_global", 1536),
                            ("all_global", 1)):
            got = paf_cuda.paf_scores_fused(*args2, smem_limit=limit)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            log(f"kernel case two_scales_{name}: max_abs_err={err} "
                f"tol={KERNEL_TOL}")
            assert err <= KERNEL_TOL, name
    # peak counts of 0, 1 and the whole budget, with a budget (13) that is
    # no multiple of the 5 lanes of a line, and a whole budget of 127
    for name, counts, budget in (("counts_0_1_13", [0, 1, 13], 13),
                                 ("counts_1_127_0", [1, 127, 0], 127),
                                 ("counts_127", [127, 127, 127], 127)):
        src, peaks, hw = paf_scene(rng, counts, budget, 2, (11, 15), 10)
        got, want, _ = both([src], [1.0], hw, peaks, pairs3, map3,
                            (0.05, 0.5, 0.05))
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        log(f"kernel case {name}: max_abs_err={err} tol={KERNEL_TOL}")
        assert err <= KERNEL_TOL, name

    # one scale of 736x1312: 127 KB of bordered planes, more than half of
    # what an SM can stage, so the kernel's 512-thread form runs
    src, peaks, hw = paf_scene(rng, [16, 9, 12], 16, 2, (92, 164), 10)
    got, want, _ = both([src], [1.0], hw, peaks, pairs3, map3,
                        (0.05, 0.5, 0.05))
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    log(f"kernel case one_large_scale: max_abs_err={err} tol={KERNEL_TOL}")
    assert err <= KERNEL_TOL, "one_large_scale"

    # full BODY_25 shape: every part at K peaks
    n, hs, ws, k = full_shape
    pairs, map_idx = paf.pair_tables(info)
    src, peaks, hw = paf_scene(rng, [k] * info.num_parts, k, n, (hs, ws),
                               info.heatmap_channels)
    got, want, args = both([src], [1.0], hw, peaks, pairs, map_idx,
                           (0.05, 0.95, 0.05))
    err = float((got - want).abs().max())
    mismatches = int((got != want).sum())
    max_err = max(max_err, err)
    log(f"kernel case body25_full {tuple(got.shape)}: max_abs_err={err} "
        f"mismatches={mismatches} accepted={int((want > 0).sum())} "
        f"tol={KERNEL_TOL}")
    assert err <= KERNEL_TOL, "body25_full"
    ms = timed(lambda: paf_cuda.paf_scores_fused(*args), 3, 20, device)
    plain_ms = timed(lambda: paf.paf_scores_multiscale_reference(*args), 1, 3,
                     device)
    full_bound = fused_bound(args[0], args[3], args[4], args[5])
    log(f"kernel time body25_full: kernel_ms={ms} plain_ms={plain_ms} "
        f"bound={json.dumps(full_bound)} "
        f"share_of_bound={full_bound['bound_ms'] / ms}")

    # 4-scale 1312x736: the four planes fit a block's shared memory only
    # without their borders (226 KB)
    sizes = [(92, 164), (69, 123), (46, 82), (23, 41)]
    ratios = [1.0, 0.75, 0.5, 0.25]
    src, peaks, hw = paf_scene(rng, [k] * info.num_parts, k, n, sizes[0],
                               info.heatmap_channels)
    srcs = [src] + [rng.uniform(-1, 1, (n, *s, info.heatmap_channels))
                    .astype(np.float32) for s in sizes[1:]]
    got, want, args4 = both(srcs, ratios, hw, peaks, pairs, map_idx,
                            (0.05, 0.95, 0.05))
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    ms4 = timed(lambda: paf_cuda.paf_scores_fused(*args4), 3, 20, device)
    plain_ms4 = timed(lambda: paf.paf_scores_multiscale_reference(*args4), 1,
                      2, device)
    bound4 = fused_bound(args4[0], args4[3], args4[4], args4[5])
    log(f"kernel case four_scales {tuple(got.shape)}: max_abs_err={err} "
        f"tol={KERNEL_TOL}; kernel_ms={ms4} plain_ms={plain_ms4} "
        f"bound={json.dumps(bound4)} "
        f"share_of_bound={bound4['bound_ms'] / ms4}")
    assert err <= KERNEL_TOL, "four_scales"
    refinement = refinement_kernel_cases(device, info, both, rng,
                                         n=min(n, 8), k=k)
    max_err = max(max_err, *(c["max_abs_err"] for c in refinement.values()))
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound": full_bound, "full_shape_mismatches": mismatches,
            "four_scales_ms": ms4, "four_scales_plain_ms": plain_ms4,
            "four_scales_bound": bound4, "refinement": refinement}


def refinement_kernel_cases(device, info, both, rng, n=8, k=127,
                            crop_hw=(368, 368)):
    """The fused kernel at the shape top-down refinement gives it
    (`pose/refine.py`): n crops of 368x368 (46x46 maps), one scale, the
    refinement's thresholds (NMS 0.02, line samples above 0.01), peaks
    without the NMS offset.  `full`: every part at its whole budget, random
    maps.  `realistic`: three placed people per crop rendered as the net's
    output, peaks from `nms.nms(..., offset=(0, 0))` on its merged maps."""
    import numpy as np
    import torch
    from openpose_tpu_torch import synthetic
    from openpose_tpu_torch.ops import nms, paf, paf_cuda, resize
    from openpose_tpu_torch.pose import refine
    thr = (refine.INTER_THRESHOLD_REFINED, 0.95, refine.NMS_THRESHOLD_REFINED)
    pairs, map_idx = paf.pair_tables(info)
    th, tw = crop_hw
    scenes = {}
    src, peaks, hw = paf_scene(rng, [k] * info.num_parts, k, n,
                               (th // 8, tw // 8), info.heatmap_channels)
    assert hw == crop_hw
    scenes["full"] = (src, peaks)
    people = np.stack([synthetic.random_people(
        rng, 3, crop_hw, height_range=(0.5 * th, 0.9 * th))
        for _ in range(n)])
    src = synthetic.make_targets(people, pairs, map_idx, crop_hw,
                                 info.num_parts, info.heatmap_channels)
    with torch.inference_mode():
        merged = resize.upsample_merge(
            [torch.from_numpy(src).to(device)[..., :info.num_parts]], [1.0],
            crop_hw)
        peaks = nms.nms(merged, thr[2], k, offset=(0.0, 0.0)).cpu().numpy()
    scenes["realistic"] = (src, peaks)
    out = {}
    for name, (src, peaks) in scenes.items():
        got, want, args = both([src], [1.0], crop_hw, peaks, pairs, map_idx,
                               thr)
        err = float((got - want).abs().max())
        case = {"max_abs_err": err, "mismatches": int((got != want).sum()),
                "accepted": int((want > 0).sum()),
                "peaks_per_part_mean": float(peaks[:, :, 0, 0].mean()),
                "ms": timed(lambda: paf_cuda.paf_scores_fused(*args), 3, 20,
                            device),
                "plain_ms": timed(
                    lambda: paf.paf_scores_multiscale_reference(*args), 1, 2,
                    device),
                "bound": fused_bound(args[0], args[3], args[4], args[5])}
        case["share_of_bound"] = case["bound"]["bound_ms"] / case["ms"]
        log(f"kernel case refinement_{name} {tuple(got.shape)}, "
            f"{src.shape[1]}x{src.shape[2]} maps, thresholds {thr}: "
            f"tol={KERNEL_TOL} " + json.dumps(case))
        assert err <= KERNEL_TOL, f"refinement_{name}"
        out[name] = case
    return out


def sampler_phase(device, profile_shape=(8, 26, 403_225, 46, 82)):
    """The sampling kernel against its plain version, both on the device.
    Returns the summary dict; the profile shape is timed."""
    import numpy as np
    import torch
    from openpose_tpu_torch.ops import paf, paf_cuda

    rng = np.random.RandomState(11)

    def case(name, n, p, hs, ws, s, scale_h, scale_w, edges=False,
             outside=False):
        th, tw = int(round(hs * scale_h)), int(round(ws * scale_w))
        low = torch.from_numpy(rng.uniform(-1, 1, (n, p, 2, hs, ws))
                               .astype(np.float32)).to(device)
        my = rng.randint(0, th, (n, p, s)).astype(np.int32)
        mx = rng.randint(0, tw, (n, p, s)).astype(np.int32)
        if edges:      # the grid's first and last pixels
            my[..., :2], mx[..., :2] = (0, th - 1), (0, tw - 1)
        if outside:    # coordinates off the grid read the clamped taps
            my[..., -2:], mx[..., -2:] = (-9, th + 9), (tw + 9, -9)
        args = (low, torch.from_numpy(my).to(device),
                torch.from_numpy(mx).to(device), scale_h, scale_w)
        want = paf.sample_bicubic_reference(*args)
        err, mismatches = 0.0, 0
        # the one-scale entry (planes staged), then the planes read from
        # global memory (on the CPU both are the plain version)
        runs = [paf_cuda.sample_bicubic(*args),
                paf_cuda.sample_bicubic_scales(
                    [low], args[1], args[2], [(scale_h, scale_w)],
                    smem_limit=1)]
        for got in runs:
            err = max(err, max(float((g - w).abs().max())
                               for g, w in zip(got, want)))
            mismatches += sum(int((g != w).sum()) for g, w in zip(got, want))
        log(f"sampler case {name} N={n} P={p} {hs}x{ws} S={s} "
            f"scale=({scale_h}, {scale_w}): max_abs_err={err} "
            f"mismatches={mismatches} tol={KERNEL_TOL} (staged, not staged)")
        assert err <= KERNEL_TOL, name
        return err, args

    def multi_scale_case(name, n, p, s, sizes, **kwargs):
        """The multi-scale entry against the in-order sum of the plain
        one-scale version."""
        th, tw = sizes[0][0] * 8, sizes[0][1] * 8
        lows = [torch.from_numpy(rng.uniform(-1, 1, (n, p, 2, h, w))
                                 .astype(np.float32)).to(device)
                for h, w in sizes]
        my = torch.from_numpy(rng.randint(0, th, (n, p, s))
                              .astype(np.int32)).to(device)
        mx = torch.from_numpy(rng.randint(0, tw, (n, p, s))
                              .astype(np.int32)).to(device)
        scales = [(th / h, tw / w) for h, w in sizes]
        got = paf_cuda.sample_bicubic_scales(lows, my, mx, scales, **kwargs)
        want = paf.sample_bicubic_scales_reference(lows, my, mx, scales)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        log(f"sampler case {name} N={n} P={p} S={s} scales={sizes} "
            f"{kwargs}: max_abs_err={err} tol={KERNEL_TOL}")
        assert err <= KERNEL_TOL, name
        return err

    max_err = 0.0
    # the JAX suite's scene (tests/test_ops.py TestPafPallasKernel)
    for name, shape in (
            ("jax_suite", (1, 3, 12, 16, 700, 8.0, 8.0, True)),
            # the 0.75 scale of a 4-scale 736x1312 plan: 69x123 maps,
            # 68 KB of planes staged above the 48 KB default
            ("scale_0.75", (2, 26, 69, 123, 6400, 8.0 / 0.75, 8.0 / 0.75)),
            # S not a multiple of the 2048-sample block, coordinates off
            # the grid
            ("ragged_S", (2, 5, 46, 82, 3 * 2048 + 77, 8.0, 8.0, True, True)),
            # scale 0 of that plan: 92x164 maps (127 KB staged)
            ("large_planes", (2, 26, 92, 164, 6400, 8.0, 8.0))):
        err, _ = case(name, *shape)
        max_err = max(max_err, err)
    # all four scales of that plan in one launch: by the rule (all staged,
    # without their borders: 222 KB), under a 96 KB limit (not all fit, so
    # none is staged), and too few samples for staging to pay (S = 40)
    plan = [(92, 164), (69, 123), (46, 82), (23, 41)]
    for name, s_count, kwargs in (
            ("four_scales", 6400, {}),
            ("four_scales_96k", 6400, {"smem_limit": 96 * 1024}),
            ("four_scales_few_samples", 40, {})):
        max_err = max(max_err, multi_scale_case(name, 2, 26, s_count, plan,
                                                **kwargs))
    n, p, s, hs, ws = profile_shape
    err, args = case("profile", n, p, hs, ws, s, 8.0, 8.0)
    max_err = max(max_err, err)
    ms = timed(lambda: paf_cuda.sample_bicubic(*args), 3, 20, device)
    plain_ms = timed(lambda: paf.sample_bicubic_reference(*args), 1, 3, device)
    profile_bound = sampler_bound([args[0]], args[1])
    log(f"sampler time profile {profile_shape}: kernel_ms={ms} "
        f"plain_ms={plain_ms} bound={json.dumps(profile_bound)} "
        f"share_of_bound={profile_bound['bound_ms'] / ms}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound": profile_bound, "profile_shape": list(profile_shape)}


def scene_frames(rng, count, frame_hw, n_people=3):
    import numpy as np
    from openpose_tpu_torch import synthetic
    height = (0.45 * frame_hw[0], 0.85 * frame_hw[0])
    return np.stack([synthetic.render_scene_image(
        synthetic.random_people(rng, n_people, frame_hw, height_range=height),
        frame_hw, rng) for _ in range(count)])


def main_path_phase(device, model, frame_hw=(720, 1280), net_h=368, batch=8,
                    iters=6):
    """PoseExtractor (f32 and bf16) and batched PoseInference on BODY_25."""
    import numpy as np
    import torch
    from openpose_tpu_torch.ops import paf_cuda
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.pose.extractor import PoseExtractor

    rng = np.random.RandomState(0)
    frames = scene_frames(rng, 3, frame_hw)
    res = {}
    reset_launches()
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        extractor = PoseExtractor(model, device=device, compute_dtype=dtype)
        people = []
        for frame in frames:
            pred = extractor.forward(frame, net_resolution=(-1, net_h))
            assert np.isfinite(pred.keypoints).all()
            assert pred.peaks.shape == (25, 128, 3)
            people.append(int(pred.keypoints.shape[0]))
        res[f"extractor_{name}_people"] = people
        res["net_input_size"] = pred.net_input_sizes[0]
        log(f"extractor {name}: net input (w, h)={pred.net_input_sizes[0]} "
            f"people per frame={people} "
            f"peaks per part (frame 0)={pred.peaks[:, 0, 0].astype(int).tolist()}")

    net_w = res["net_input_size"][0]
    batch_frames = scene_frames(rng, batch, (net_h, net_w))
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        inference = PoseInference(model, net_hw=(net_h, net_w), device=device,
                                  compute_dtype=dtype)
        images = torch.from_numpy(batch_frames).to(device)
        peaks, scores = inference(images)
        assert peaks.shape == (batch, 25, 128, 3)
        assert scores.shape == (batch, 26, 127, 127)
        assert bool(torch.isfinite(peaks).all() & torch.isfinite(scores).all())
        res["launches_per_call"] = launches_per_call(
            f"main path, batch {batch}", lambda: inference(images))
        ms_device = timed(lambda: inference(images), 2, iters, device)
        ms_fetch = host_ms(lambda: inference.fetch(*inference(images)), iters)
        pk, sc = inference.fetch(*inference(images))
        people = [len(inference.assemble(pk[b], sc[b])[0])
                  for b in range(batch)]
        ms_assembly = host_ms(lambda: [inference.assemble(pk[b], sc[b])
                                       for b in range(batch)], 3)

        def end_to_end():
            pk, sc = inference.fetch(*inference(images))
            return [inference.assemble(pk[b], sc[b]) for b in range(batch)]
        ms_e2e = host_ms(end_to_end, iters)
        if name == "bf16" and device.type == "cuda":
            res["trace_bf16_end_to_end"] = trace = device_busy(end_to_end, 2)
            log(f"trace, batch-8 bf16 end to end: {json.dumps(trace)}")
        res[f"inference_{name}"] = {
            "batch": batch, "ms_per_batch_device": ms_device,
            "fps_device": batch * 1e3 / ms_device,
            "ms_per_batch_with_fetch": ms_fetch,
            "ms_assembly_per_batch": ms_assembly,
            "ms_per_batch_end_to_end": ms_e2e,
            "fps_end_to_end": batch * 1e3 / ms_e2e,
            "people_per_frame": people}
        log(f"inference {name} batch {batch} at {net_h}x{net_w}: "
            f"device {ms_device} ms/batch = {batch * 1e3 / ms_device} f/s; "
            f"with fetch {ms_fetch} ms/batch; host assembly {ms_assembly} "
            f"ms/batch; end to end {ms_e2e} ms/batch = "
            f"{batch * 1e3 / ms_e2e} f/s; people per frame={people}")

    one = torch.from_numpy(batch_frames[:1]).to(device)
    inference1 = PoseInference(model, net_hw=(net_h, net_w), device=device)
    lat_device = timed(lambda: inference1(one), 3, 20, device)
    lat_fetch = host_ms(lambda: inference1.fetch(*inference1(one)), 20)

    def frame_latency():
        pk, sc = inference1.fetch(*inference1(one))
        inference1.assemble(pk[0], sc[0])
    for _ in range(3):
        frame_latency()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        frame_latency()
        lat.append((time.perf_counter() - t0) * 1e3)
    res["batch1_latency_ms"] = {"median": float(np.median(lat)),
                                "min": float(np.min(lat)),
                                "device": lat_device, "with_fetch": lat_fetch}
    log(f"batch-1 bf16 latency: device {lat_device} ms; with fetch "
        f"{lat_fetch} ms; with fetch + assembly median {np.median(lat)} ms, "
        f"min {np.min(lat)} ms")
    res["launches"] = read_launches("main path", paf_cuda.paf_scores_fused)
    res["breakdown"] = stage_breakdown(model, batch_frames, device, iters)
    res["cnn_cpu_vs_gpu"] = cnn_cpu_check(model, device)
    return res


def stage_breakdown(model, frames, device, iters):
    """Per-stage device time at batch 8 (bf16 CNN, f32 heatmap path), the
    CNN's FLOPs (torch's FLOP counter: 2 per multiply-add of every
    convolution) and rate, and the kernel held to its plain version on these
    main-path tensors."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from openpose_tpu_torch.ops import nms, paf, paf_cuda, resize
    info = model.info
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf.pair_tables(info))
    x = torch.from_numpy(frames).to(device).to(torch.float32)
    th, tw = x.shape[1], x.shape[2]
    out = {}
    with torch.inference_mode():
        net_in = resize.normalize_vgg(x)
        for name, dtype in (("cnn_bf16", torch.bfloat16),
                            ("cnn_f32", torch.float32)):
            out[name] = timed(lambda: model.forward(net_in, dtype), 1, iters,
                              device)
        with FlopCounterMode(display=False) as counter:
            src = model.forward(net_in, torch.bfloat16)
        out["cnn_flops"] = counter.get_total_flops()
        for name, peak in PEAK_TFLOPS.items():
            out[f"{name}_tflops"] = out["cnn_flops"] / out[name] * 1e-9
            out[f"{name}_share_of_peak"] = out[f"{name}_tflops"] / peak
        merge = lambda: resize.upsample_merge([src[..., :info.num_parts]],
                                              [1.0], (th, tw))
        out["upsample_merge"] = timed(merge, 1, iters, device)
        merged = merge()
        out["nms"] = timed(lambda: nms.nms(merged, 0.05, 127), 1, iters, device)
        peaks = nms.nms(merged, 0.05, 127)
        args = ([src], [1.0], (th, tw), peaks, pairs, map_idx, 0.05, 0.95, 0.05)
        out["paf_kernel"] = timed(lambda: paf_cuda.paf_scores_fused(*args), 1,
                                  iters, device)
        out["paf_plain"] = timed(
            lambda: paf.paf_scores_multiscale_reference(*args), 1, 3, device)
        got = paf_cuda.paf_scores_fused(*args)
        want = paf.paf_scores_multiscale_reference(*args)
        out["paf_main_path_max_abs_err"] = float((got - want).abs().max())
        out["paf_bound"] = fused_bound([src], peaks, pairs, map_idx)
        out["paf_share_of_bound"] = out["paf_bound"]["bound_ms"] \
            / out["paf_kernel"]
        # the routing question at K = 127: the sampled backend (the
        # sampler kernel inside torch ops) on the same peaks
        sampled = lambda: paf.paf_scores_multiscale(*args, use_fused=False)
        out["paf_sampled_k127"] = timed(sampled, 1, 3, device)
        out.update(backend_agreement(got, sampled(), "k127"))
        out["peaks_per_part_mean"] = float(peaks[:, :, 0, 0].mean())
    log("stage breakdown at batch 8 (ms): " + json.dumps(out))
    assert out["paf_main_path_max_abs_err"] <= KERNEL_TOL
    return out


def backend_agreement(fused, sampled, tag):
    """How far the fused and sampled backends' scores are apart on one
    path: two tap formulas equal in exact arithmetic, so they differ in
    the last bits, and a line sample sitting on the threshold may flip."""
    diff = (fused - sampled).abs()
    return {f"backends_max_abs_diff_{tag}": float(diff.max()),
            f"backends_share_above_1e-4_{tag}": float((diff > 1e-4).float()
                                                      .mean())}


def sampler_on_path(inference, sources, peaks, device):
    """The sampler kernel against its plain version on the sampled
    backend's own inputs for one path: every pair's x/y planes of all
    scales at every line sample of the path's peaks, in the one launch the
    path makes and scale by scale.  Also times that launch, holds it
    against its bound, and times the gather of the planes
    (`paf.sampler_args`) that the path pays before it."""
    from openpose_tpu_torch.ops import paf, paf_cuda
    geo = paf._line_geometry(peaks, inference.pairs, inference.net_hw)
    make_args = lambda: paf.sampler_args(
        sources, inference.plan.scale_input_to_net, inference.net_hw, geo,
        inference.map_idx)
    lows, my, mx, scales = make_args()
    pairs = [(paf_cuda.sample_bicubic_scales(lows, my, mx, scales),
              paf.sample_bicubic_scales_reference(lows, my, mx, scales))]
    pairs += [(paf_cuda.sample_bicubic(low, my, mx, *scale),
               paf.sample_bicubic_reference(low, my, mx, *scale))
              for low, scale in zip(lows, scales)]
    err = max(float((g - w).abs().max())
              for got, want in pairs for g, w in zip(got, want))
    mismatches = sum(int((g != w).sum())
                     for got, want in pairs for g, w in zip(got, want))
    shapes = [list(low.shape) for low in lows] + [list(my.shape)]
    out = {"max_abs_err": err, "mismatches": mismatches, "shapes": shapes,
           "ms": timed(lambda: paf_cuda.sample_bicubic_scales(
               lows, my, mx, scales), 3, 20, device),
           "gather_ms": timed(make_args, 3, 20, device),
           "bound": sampler_bound(lows, my)}
    out["share_of_bound"] = out["bound"]["bound_ms"] / out["ms"]
    log(f"sampler on the path's tensors {shapes}: max_abs_err={err} "
        f"mismatches={mismatches} tol={KERNEL_TOL}; kernel_ms={out['ms']} "
        f"bound={json.dumps(out['bound'])} "
        f"share_of_bound={out['share_of_bound']}; gather of the planes "
        f"{out['gather_ms']} ms")
    assert err <= KERNEL_TOL
    return out


def people_capped_phase(device, model, batch=4, net_hw=(736, 1312),
                        frame_hw=(1080, 1920), iters=5):
    """The people-capped multi-scale path (4 scales, 16-peak budget), on
    pre-sized and on raw frames: the sampler carries its PAF stage."""
    import numpy as np
    import torch
    from openpose_tpu_torch.ops import paf, paf_cuda
    from openpose_tpu_torch.parallel.inference import PoseInference

    rng = np.random.RandomState(1)
    inputs = {"presized": (None, scene_frames(rng, batch, net_hw)),
              "raw": (frame_hw, scene_frames(rng, batch, frame_hw))}
    res, runs = {}, {}
    reset_launches()
    for name, (fhw, frames) in inputs.items():
        inference = PoseInference(model, net_hw=net_hw, device=device,
                                  max_peaks=16, scale_number=4,
                                  scale_gap=0.25, frame_hw=fhw)
        images = torch.from_numpy(frames).to(device)
        peaks, scores = inference(images)
        assert peaks.shape == (batch, 25, 17, 3)
        assert scores.shape == (batch, 26, 16, 16)
        assert bool(torch.isfinite(peaks).all() & torch.isfinite(scores).all())
        res[f"launches_per_call_{name}"] = launches_per_call(
            f"people-capped 4-scale {name}, batch {batch}",
            lambda: inference(images))
        ms_device = timed(lambda: inference(images), 1, iters, device)
        ms_fetch = host_ms(lambda: inference.fetch(*inference(images)), iters)
        pk, sc = inference.fetch(peaks, scores)
        people = [len(inference.assemble(pk[b], sc[b])[0])
                  for b in range(batch)]
        ms_assembly = host_ms(lambda: [inference.assemble(pk[b], sc[b])
                                       for b in range(batch)], 3)

        def end_to_end():
            pk, sc = inference.fetch(*inference(images))
            return [inference.assemble(pk[b], sc[b]) for b in range(batch)]
        ms_e2e = host_ms(end_to_end, iters)
        res[name] = {
            "batch": batch, "input_hw": list(frames.shape[1:3]),
            "net_input_sizes": [list(s) for s in inference.plan.net_input_sizes],
            "ms_per_batch_device": ms_device,
            "fps_device": batch * 1e3 / ms_device,
            "ms_per_batch_with_fetch": ms_fetch,
            "ms_assembly_per_batch": ms_assembly,
            "ms_per_batch_end_to_end": ms_e2e,
            "fps_end_to_end": batch * 1e3 / ms_e2e,
            "people_per_frame": people,
            "peaks_per_part_mean": float(peaks[:, :, 0, 0].mean())}
        if name == "presized" and device.type == "cuda":
            res["trace_presized_end_to_end"] = trace = device_busy(end_to_end, 3)
            log(f"trace, people-capped presized end to end: "
                f"{json.dumps(trace)}")
        log(f"people-capped 4-scale {name} batch {batch} "
            f"{frames.shape[1]}x{frames.shape[2]} -> net sizes "
            f"{inference.plan.net_input_sizes}: device {ms_device} ms/batch "
            f"= {batch * 1e3 / ms_device} f/s; with fetch {ms_fetch} ms; "
            f"host assembly {ms_assembly} ms; end to end {ms_e2e} ms/batch "
            f"= {batch * 1e3 / ms_e2e} f/s; people per frame={people}")
        runs[name] = (inference, images)
    counts = read_launches("people-capped path",
                           paf_cuda.sample_bicubic_scales)
    assert counts["paf_scores_fused"] == 0, \
        "the 16-peak path launched the fused kernel"
    res["launches"] = counts

    # the routing question at K = 16, on this path's own peaks
    inference, images = runs["presized"]
    nms_thr, inter_thr, inter_min = inference.thresholds
    with torch.inference_mode():
        sources = inference.net_outputs(images)
        peaks, scores = inference.decode(sources)
        args = (sources, inference.plan.scale_input_to_net, net_hw, peaks,
                inference.pairs, inference.map_idx, inter_thr, inter_min,
                nms_thr)
        routing = {
            "sampled_ms": timed(lambda: paf.paf_scores_multiscale(*args), 2,
                                10, device),
            "fused_ms": timed(lambda: paf.paf_scores_multiscale(
                *args, use_fused=True), 2, 10, device)}
        routing.update(backend_agreement(
            paf.paf_scores_multiscale(*args, use_fused=True), scores, "k16"))
        # where the device time goes on this path: the per-scale resizes and
        # CNNs, then merge + NMS + PAF
        res["breakdown_presized"] = {
            "net_outputs": timed(lambda: inference.net_outputs(images), 1,
                                 iters, device),
            "decode": timed(lambda: inference.decode(sources), 1, iters,
                            device),
            "paf_sampled": routing["sampled_ms"]}
        log("people-capped presized breakdown (ms per batch): "
            + json.dumps(res["breakdown_presized"]))
        res["sampler_on_path"] = sampler_on_path(inference, sources, peaks,
                                                 device)
        # the forced fused kernel on this path's tensors, against its bound
        routing["fused_bound"] = fused_bound(sources, peaks, inference.pairs,
                                             inference.map_idx)
        routing["fused_share_of_bound"] = \
            routing["fused_bound"]["bound_ms"] / routing["fused_ms"]
    res["routing_k16"] = routing
    log(f"PAF stage at K = 16, 4 scales, batch {batch}: " + json.dumps(routing))
    return res


def capped_trace(device, model, batch=4, net_hw=(736, 1312)):
    """`--capped-trace`: the people-capped 4-scale call on pre-sized frames
    alone, timed three times over and traced, to set two trees side by side
    on one card: its device time, and how many kernels and copies it
    launches."""
    import numpy as np
    import torch
    from openpose_tpu_torch.parallel.inference import PoseInference
    frames = scene_frames(np.random.RandomState(1), batch, net_hw)
    inference = PoseInference(model, net_hw=net_hw, device=device,
                              max_peaks=16, scale_number=4, scale_gap=0.25)
    images = torch.from_numpy(frames).to(device)
    out = {"ms_per_batch_device": [timed(lambda: inference(images), 1, 5,
                                         device) for _ in range(3)],
           "trace": device_busy(lambda: inference(images), 3)}
    log("people-capped 4-scale presized, device only: " + json.dumps(out))
    return out


def whole_body_phase(device, pose_model, batch=4, frame_hw=(720, 1280),
                     net_hw=(368, 656), people_cap=8, net_size=368, iters=3,
                     injection_hw=(368, 656)):
    """BODY_25 + FACE + HAND, bf16: the cascade timed per stage; the
    batched face and hand keypoints held to the per-crop extractors; and
    injected people through a net_bypass body."""
    import numpy as np
    import torch
    from openpose_tpu_torch import synthetic
    from openpose_tpu_torch.models import zoo
    from openpose_tpu_torch.ops import paf_cuda
    from openpose_tpu_torch.runtime.whole_body import (
        WholeBodyInference, WholeBodyResult)

    face_model = zoo.load_face_model(device=device)
    hand_model = zoo.load_hand_model(device=device)
    rng = np.random.RandomState(2)
    fh = frame_hw[0]
    placed = [synthetic.random_people(rng, min(4, people_cap), frame_hw,
                                      height_range=(0.6 * fh, 0.9 * fh))
              for _ in range(batch)]
    frames = torch.from_numpy(np.stack([
        synthetic.render_scene_image(p, frame_hw, rng) for p in placed])
    ).to(device)

    def placed_results():
        return [WholeBodyResult(p, np.ones(len(p), np.float32))
                for p in placed]

    wb = WholeBodyInference(pose_model, face_model, hand_model,
                            frame_hw=frame_hw, net_hw=net_hw,
                            people_cap=people_cap, face_net_size=net_size,
                            hand_net_size=net_size, device=device)
    reset_launches()
    results = wb(frames)
    per_call = launches_per_call(f"whole body, batch {batch}",
                                 lambda: wb(frames))
    # the whole cascade on the body's own people (random weights: up to
    # the cap of arbitrary people, so face and hand crops are near full)
    total_ms = host_ms(lambda: wb(frames), iters)
    body_device = timed(lambda: wb.body(frames), 1, iters, device)
    body_ms = host_ms(lambda: wb.body_stage(frames), iters)
    # the face and hand stages on the placed people
    face_ms = host_ms(lambda: wb.face_stage(frames, placed_results()), iters)
    hand_ms = host_ms(lambda: wb.hand_stage(frames, placed_results()), iters)
    counts = read_launches("whole-body path", paf_cuda.paf_scores_fused)
    out = {"batch": batch, "people_cap": people_cap,
           "body_people_per_frame": [len(r.pose_keypoints) for r in results],
           "placed_people_per_frame": [len(p) for p in placed],
           "ms_body_device": body_device, "ms_body_with_assembly": body_ms,
           "ms_face_placed": face_ms, "ms_hand_placed": hand_ms,
           "ms_cascade": total_ms, "fps": batch * 1e3 / total_ms,
           "launches": counts, "launches_per_call": per_call}
    log(f"whole body batch {batch} {frame_hw} -> {net_hw}, bf16: body "
        f"{body_device} ms on the device, {body_ms} ms with fetch and "
        f"assembly; face {face_ms} ms and hand {hand_ms} ms for "
        f"{out['placed_people_per_frame']} placed people per frame; whole "
        f"cascade {total_ms} ms/batch = {out['fps']} f/s on the body's own "
        f"people per frame {out['body_people_per_frame']}")

    # the fused kernel alone on the body stage's own tensors
    nms_thr, inter_thr, inter_min = wb.body.thresholds
    with torch.inference_mode():
        sources = wb.body.net_outputs(frames)
        peaks, _ = wb.body.decode(sources)
        args = (sources, wb.body.plan.scale_input_to_net, net_hw, peaks,
                wb.body.pairs, wb.body.map_idx, inter_thr, inter_min, nms_thr)
        body_paf = {
            "ms": timed(lambda: paf_cuda.paf_scores_fused(*args), 3, 20,
                        device),
            "bound": fused_bound(sources, peaks, wb.body.pairs,
                                 wb.body.map_idx),
            "peaks_per_part_mean": float(peaks[:, :, 0, 0].mean())}
    body_paf["share_of_bound"] = body_paf["bound"]["bound_ms"] / body_paf["ms"]
    out["body_paf_kernel"] = body_paf
    log(f"fused kernel on the whole-body body stage's tensors (batch "
        f"{batch}): " + json.dumps(body_paf))

    out["per_crop_check"] = per_crop_check(
        device, wb, face_model, hand_model, frames, placed_results)
    out["injection"] = whole_body_injection(
        device, pose_model, face_model, hand_model, injection_hw, people_cap,
        net_size)
    return out


def per_crop_check(device, wb, face_model, hand_model, frames,
                   placed_results):
    """The batched face and hand stages against the per-crop extractors on
    the same frames and rects, float32 with TF32 off.  Tolerance: the two
    run other batch sizes, so cuDNN may sum in another order; a keypoint
    matches when its decoded position is the same (1e-3 px) and its score
    within 1e-3.  At least 99% must match, at most 8 may not, and no
    position may differ by more than 1 px nor score by more than 1e-2
    (a near-tie of two argmax candidates moves a keypoint by a fraction of
    a crop pixel; a wrong map-back moves it by many)."""
    import numpy as np
    import torch
    from openpose_tpu_torch.face.extractor import FaceExtractor
    from openpose_tpu_torch.hand.extractor import HandExtractor
    from openpose_tpu_torch.runtime.whole_body import WholeBodyInference

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        wb32 = WholeBodyInference(
            wb.body.model, face_model, hand_model, frame_hw=wb.body.frame_hw,
            net_hw=wb.body.net_hw, people_cap=wb.people_cap, device=device,
            compute_dtype=torch.float32)
        got = placed_results()
        wb32.face_stage(frames, got)
        wb32.hand_stage(frames, got)
        face_ex = FaceExtractor(face_model, wb32.face.net_size,
                                torch.float32, device)
        hand_ex = HandExtractor(hand_model, wb32.hand.net_size,
                                torch.float32, device=device)
        pairs = []
        for i, res in enumerate(got):
            image = frames[i].cpu().numpy()
            kp = res.pose_keypoints
            want_face = face_ex.forward(image,
                                        [r for r, _ in wb32.face_rects(kp)])
            flat = [r for r, _ in wb32.hand_rects(kp)]
            want_l, want_r = hand_ex.forward(image,
                                             list(zip(flat[0::2], flat[1::2])))
            pairs += [(res.face_keypoints, want_face),
                      (res.hand_left_keypoints, want_l),
                      (res.hand_right_keypoints, want_r)]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    total = matched = 0
    max_xy = max_score = 0.0
    for g, w in pairs:
        assert g.shape == w.shape, (g.shape, w.shape)
        assert np.any(w[..., 2] != 0), "a crop decoded nothing"
        dxy = np.abs(g[..., :2] - w[..., :2]).max(axis=-1)
        ds = np.abs(g[..., 2] - w[..., 2])
        total += dxy.size
        matched += int(((dxy <= 1e-3) & (ds <= 1e-3)).sum())
        max_xy, max_score = max(max_xy, float(dxy.max())), \
            max(max_score, float(ds.max()))
    share = matched / total
    log(f"batched vs per-crop face and hand keypoints (f32): {matched} of "
        f"{total} match ({share}); max position diff {max_xy} px, max "
        f"score diff {max_score}")
    assert share >= 0.99 and total - matched <= 8, (matched, total)
    assert max_xy <= 1.0 and max_score <= 1e-2, (max_xy, max_score)
    return {"keypoints": total, "matched": matched, "share": share,
            "max_xy_diff_px": max_xy, "max_score_diff": max_score}


def whole_body_injection(device, pose_model, face_model, hand_model, net_hw,
                         people_cap, net_size, batch=4, n_people=3):
    """Known people as the body's net output (a net_bypass body): the
    cascade must assemble them and crop faces and hands around them."""
    import numpy as np
    import torch
    from openpose_tpu_torch import synthetic
    from openpose_tpu_torch.ops import paf
    from openpose_tpu_torch.runtime.whole_body import WholeBodyInference

    info = pose_model.info
    rng = np.random.RandomState(8)
    people = np.stack([synthetic.random_people(rng, n_people, net_hw)
                       for _ in range(batch)])
    pairs, map_idx = paf.pair_tables(info)
    net_output = synthetic.make_targets(people, pairs, map_idx, net_hw,
                                        info.num_parts, info.heatmap_channels)
    frames = np.stack([synthetic.render_scene_image(p, net_hw, rng)
                       for p in people])
    wb = WholeBodyInference(pose_model, face_model, hand_model,
                            frame_hw=None, net_hw=net_hw,
                            people_cap=people_cap, face_net_size=net_size,
                            hand_net_size=net_size, device=device,
                            net_bypass=True)
    results = wb(torch.from_numpy(frames).to(device), net_output=net_output)
    errs = []

    def inside(rect, xy, pad=0.0):
        return (rect[0] - pad <= xy[0] <= rect[0] + rect[2] + pad
                and rect[1] - pad <= xy[1] <= rect[1] + rect[3] + pad)
    for res, placed in zip(results, people):
        kp = res.pose_keypoints
        assert kp.shape[0] == n_people, f"{kp.shape[0]} people != {n_people}"
        for person in placed:
            dist = np.abs(kp[:, :, :2] - person[None, :, :2]).max(axis=(1, 2))
            errs.append(float(dist.min()))
        faces = [r for r, _ in wb.face_rects(kp)]
        hands = [r for r, _ in wb.hand_rects(kp)]
        assert res.face_keypoints.shape == (n_people, 70, 3)
        assert res.hand_left_keypoints.shape == (n_people, 21, 3)
        for p in range(n_people):
            # BODY_25: 0 nose, 4 right wrist, 7 left wrist
            assert inside(faces[p], kp[p, 0, :2]), "face crop misses the nose"
            assert inside(hands[2 * p], kp[p, 7, :2]), "left hand crop"
            assert inside(hands[2 * p + 1], kp[p, 4, :2]), "right hand crop"
            for rect, kps in ((faces[p], res.face_keypoints[p]),
                              (hands[2 * p], res.hand_left_keypoints[p]),
                              (hands[2 * p + 1], res.hand_right_keypoints[p])):
                assert (kps[:, 2] != 0).any()
                assert all(inside(rect, xy, 1.0) for xy in kps[:, :2])
    log(f"whole-body injection: placed {n_people} people in each of {batch} "
        f"frames, assembled {[len(r.pose_keypoints) for r in results]}; max "
        f"keypoint error {max(errs)} px; face and hand crops around each")
    assert max(errs) <= 8.0
    return {"people": n_people, "max_keypoint_err_px": max(errs)}


def cnn_cpu_check(model, device):
    """The CNN on the card (float32, TF32 off) against the same weights on
    the CPU, on a small input.  Relative tolerance 1e-3 of the output's
    range: ~100 layers of float32 sums in other orders."""
    import numpy as np
    import torch
    from openpose_tpu_torch.models import zoo
    x = torch.from_numpy(np.random.RandomState(5).uniform(
        -0.5, 0.5, (1, 64, 112, 3)).astype(np.float32))
    cpu_model = zoo.load_pose_model(seed=0, device="cpu")
    with torch.inference_mode():
        want = cpu_model.forward(x, torch.float32)
        got = model.forward(x.to(device), torch.float32).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"CNN f32 GPU vs CPU at 64x112: max_abs_err={err} "
        f"max_abs_value={scale} tol={1e-3 * scale}")
    assert err <= 1e-3 * scale
    return {"max_abs_err": err, "max_abs_value": scale}


def injection_phase(device, model, frame_hw=(368, 656), n_people=3):
    """Known people, rendered as a net output, must come back exactly."""
    import numpy as np
    from openpose_tpu_torch import synthetic
    from openpose_tpu_torch.ops import paf
    from openpose_tpu_torch.pose.extractor import PoseExtractor

    info = model.info
    people = synthetic.random_people(np.random.RandomState(7), n_people,
                                     frame_hw)
    pairs, map_idx = paf.pair_tables(info)
    net_output = synthetic.make_targets(
        people[None], pairs, map_idx, frame_hw, info.num_parts,
        info.heatmap_channels)[0]
    h, w = frame_hw
    pred = PoseExtractor(model, device=device).forward(
        np.zeros((h, w, 3), np.uint8), net_resolution=(w, h),
        net_output=net_output)
    found = pred.keypoints
    assert found.shape[0] == n_people, f"{found.shape[0]} people != {n_people}"
    errs = []
    for person in people:
        dist = np.abs(found[:, :, :2] - person[None, :, :2]).max(axis=(1, 2))
        best = int(np.argmin(dist))
        assert (found[best, :, 2] > 0).all(), "a placed part was not found"
        errs.append(float(dist[best]))
    log(f"injection: placed {n_people} people, assembled {found.shape[0]}; "
        f"max keypoint error per person (px) {errs}")
    assert max(errs) <= 8.0
    doc = pred.people_json()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / "chip_smoke_people.json"
    path.write_text(json.dumps(doc, separators=(",", ":")))
    assert len(json.loads(path.read_text())["people"]) == n_people
    return {"people": n_people, "max_keypoint_err_px": errs}


def textured_frames(rng, count, frame_hw, people, shift=(3, 2)):
    """`count` uint8 frames of one scene, each moved by `shift` (dx, dy)
    whole pixels against the one before (rolled, so exact away from the
    border): `people` drawn over a smooth random texture, so that every
    patch has gradients for optical flow to hold on to."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from openpose_tpu_torch import synthetic
    h, w = frame_hw
    coarse = torch.from_numpy(rng.uniform(40, 200, (1, 3, h // 8 + 1,
                                                    w // 8 + 1))
                              .astype(np.float32))
    texture = F.interpolate(coarse, size=(h, w), mode="bicubic",
                            align_corners=True)[0].permute(1, 2, 0).numpy()
    drawn = synthetic.render_scene_image(people, frame_hw, None)
    scene = np.where(drawn.any(axis=-1, keepdims=True), drawn,
                     np.clip(texture, 0, 255)).astype(np.uint8)
    return [np.roll(scene, (shift[1] * i, shift[0] * i), axis=(0, 1))
            for i in range(count)]


def lk_cpu_check(device, frame_hw=(720, 1280)):
    """`pyramidal_lk` on the card against the same call on the CPU: the
    same frames and points.  Points within 1e-2 px; `valid` flags equal but
    for a point whose patch or end lies within 1e-2 px of the frame's
    bound, where a last-bit difference may decide."""
    import numpy as np
    from openpose_tpu_torch import synthetic
    from openpose_tpu_torch.tracking import lk
    rng = np.random.RandomState(21)
    h, w = frame_hw
    people = synthetic.random_people(rng, 4, frame_hw,
                                     height_range=(0.4 * h, 0.8 * h))
    prev, nxt = (f.astype(np.float32).mean(axis=-1)
                 for f in textured_frames(rng, 2, frame_hw, people))
    pts = np.concatenate([
        people[..., :2].reshape(-1, 2),
        # patches that leave the frame, a point outside it, the last pixel
        [[4.0, 100.0], [w - 5.0, h / 2], [w + 50.0, 20.0], [w - 1.0, h - 1.0],
         [10.0, 10.0], [w / 2, h - 10.5]]]).astype(np.float32)
    got_pts, got_valid = (t.cpu().numpy() for t in
                          lk.pyramidal_lk(prev, nxt, pts, device=device))
    want_pts, want_valid = (t.numpy() for t in
                            lk.pyramidal_lk(prev, nxt, pts, device="cpu"))
    err = float(np.abs(got_pts - want_pts)[want_valid].max())
    half = 10.0
    margin = np.minimum.reduce([
        np.abs(pts[:, 0] - half), np.abs(w - pts[:, 0] - half),
        np.abs(pts[:, 1] - half), np.abs(h - pts[:, 1] - half),
        np.abs(want_pts[:, 0]), np.abs(w - want_pts[:, 0]),
        np.abs(want_pts[:, 1]), np.abs(h - want_pts[:, 1])])
    differ = got_valid != want_valid
    log(f"LK card vs CPU at {frame_hw}: {len(pts)} points, "
        f"{int(want_valid.sum())} valid, max_abs_err={err} px tol=1e-2; "
        f"valid flags differ on {int(differ.sum())}")
    assert err <= 1e-2
    assert (margin[differ] <= 1e-2).all(), pts[differ]
    assert want_valid[:100].sum() >= 80 and not want_valid[100:104].any()
    return {"points": len(pts), "valid": int(want_valid.sum()),
            "max_abs_err_px": err, "valid_flags_differ": int(differ.sum())}


def wrapper_phase(device, frame_hw=(720, 1280), net_size=368, n_people=4,
                  track_frames=8, shift=(3, 2), compute_dtype="bfloat16",
                  net_resolution=(-1, 368), injection_hw=(368, 656)):
    """The port's `Wrapper` on the card: BODY_25 + face + hand, the best
    `n_people` kept, `tracking=1` (so even datum ids are CNN frames).
    (a) plain `process`; (b) with top-down refinement, on the net's own
    people and on injected ones; (c) `tracking=1` over `track_frames`
    frames of one scene moved by `shift` px a frame: on the LK frames the
    kept keypoints must have moved by that shift; (d) placed people
    injected as the body net's output must come back, with face and hand
    crops around them."""
    import numpy as np
    import torch
    from openpose_tpu_torch import synthetic
    from openpose_tpu_torch.ops import paf, paf_cuda
    from openpose_tpu_torch.tracking import lk
    from openpose_tpu_torch.utils.profiler import Profiler
    from openpose_tpu_torch.wrapper import (
        FaceConfig, HandConfig, PoseConfig, Wrapper)

    wrapper = Wrapper(
        PoseConfig(net_resolution=net_resolution, compute_dtype=compute_dtype,
                   number_people_max=n_people, tracking=1),
        FaceConfig(enable=True, net_resolution=net_size),
        HandConfig(enable=True, net_resolution=net_size), device=device)
    assert wrapper.pose_extractor.device == device
    rng = np.random.RandomState(31)
    frames = scene_frames(rng, 4, frame_hw)
    out = {}

    def run(tag, images, **kwargs):
        """`process` on each image as a CNN frame: per-stage ms from a
        fresh Profiler and the datums, after a warm-up pass over the same
        images (a frame with another number of face or hand crops is a new
        batch shape, for which cuDNN's benchmark mode first tries its
        algorithms)."""
        for image in images:
            wrapper.process(image, datum_id=0, **kwargs)
        wrapper.profiler = Profiler()
        datums = [wrapper.process(image, datum_id=0, **kwargs)
                  for image in images]
        stages = wrapper.profiler.averages_ms()
        wrapper.profiler = None
        for d in datums:
            kp = d.pose_keypoints
            assert kp.ndim == 3 and kp.shape[1:] == (25, 3)
            assert kp.shape[0] <= n_people and np.isfinite(kp).all()
            assert d.pose_scores.shape == (kp.shape[0],)
            if kp.shape[0]:
                assert d.face_keypoints.shape == (kp.shape[0], 70, 3)
                assert d.hand_left_keypoints.shape == (kp.shape[0], 21, 3)
                assert d.hand_right_keypoints.shape == (kp.shape[0], 21, 3)
                assert np.isfinite(d.face_keypoints).all()
                assert np.isfinite(d.hand_left_keypoints).all()
        out[f"{tag}_stage_ms"] = stages
        out[f"{tag}_people"] = [int(d.pose_keypoints.shape[0])
                                for d in datums]
        log(f"wrapper {tag}: per-stage ms {json.dumps(stages)}; people kept "
            f"per frame {out[f'{tag}_people']}")
        return datums

    reset_launches()
    # (a) plain
    run("plain", frames)
    out["plain_launches_per_frame"] = launches_per_call(
        "wrapper plain, one frame",
        lambda: wrapper.process(frames[0], datum_id=0))

    # (d) placed people through pose_net_output (a frame of the net's size)
    info = wrapper.pose_extractor.info
    placed = synthetic.random_people(rng, 3, injection_hw)
    pairs, map_idx = paf.pair_tables(info)
    net_output = synthetic.make_targets(
        placed[None], pairs, map_idx, injection_hw, info.num_parts,
        info.heatmap_channels)[0]
    placed_frame = synthetic.render_scene_image(placed, injection_hw, rng)
    datum = run("injected", [placed_frame], pose_net_output=net_output)[0]
    found = datum.pose_keypoints
    assert found.shape[0] == len(placed), f"{found.shape[0]} people"
    errs = [float(np.abs(found[:, :, :2] - person[None, :, :2])
                  .max(axis=(1, 2)).min()) for person in placed]
    assert max(errs) <= 8.0, errs
    for p in range(len(placed)):
        face = datum.face_rectangles[p]
        nose = found[p, 0, :2]             # BODY_25 part 0
        assert face[0] <= nose[0] <= face[0] + face[2] \
            and face[1] <= nose[1] <= face[1] + face[3], "face crop"
        assert (datum.face_keypoints[p, :, 2] != 0).any()
        assert (datum.hand_left_keypoints[p, :, 2] != 0).any()
    out["injected_max_keypoint_err_px"] = max(errs)
    log(f"wrapper injected: placed {len(placed)} people, recovered all; max "
        f"keypoint error {max(errs)} px")

    # (b) top-down refinement: on the net's own people, and on the placed
    # ones (small enough that each gets a crop)
    wrapper.pose_cfg.top_down_refinement = True
    try:
        run("refined", frames)
        out["refined_launches_per_frame"] = launches_per_call(
            "wrapper refined, one frame",
            lambda: wrapper.process(frames[0], datum_id=0))
        run("refined_injected", [placed_frame], pose_net_output=net_output)
        out["refined_injected_launches_per_frame"] = launches_per_call(
            "wrapper refined, placed people",
            lambda: wrapper.process(placed_frame, datum_id=0,
                                    pose_net_output=net_output))
    finally:
        wrapper.pose_cfg.top_down_refinement = False
    assert out["refined_injected_launches_per_frame"]["paf_scores_fused"] \
        > out["plain_launches_per_frame"]["paf_scores_fused"], \
        "refinement did not launch the fused kernel on its crops"
    out["refinement_ms"] = out["refined_stage_ms"]["pose"] \
        - out["plain_stage_ms"]["pose"]
    log(f"wrapper refinement: pose stage {out['refined_stage_ms']['pose']} ms "
        f"against {out['plain_stage_ms']['pose']} ms plain")

    # (c) tracking=1 over one moving scene
    h, w = frame_hw
    people = synthetic.random_people(rng, 3, frame_hw,
                                     height_range=(0.4 * h, 0.7 * h))
    moving = textured_frames(rng, track_frames, frame_hw, people, shift)
    wrapper.process(moving[0], datum_id=0)          # warm both kinds of frame
    wrapper.process(moving[1], datum_id=1)
    times, pose_times, datums = {0: [], 1: []}, {0: [], 1: []}, []
    for i, frame in enumerate(moving):
        wrapper.profiler = Profiler()
        t0 = time.perf_counter()
        datums.append(wrapper.process(frame, datum_id=i))
        times[i % 2].append((time.perf_counter() - t0) * 1e3)
        pose_times[i % 2].append(wrapper.profiler.averages_ms()["pose"])
    wrapper.profiler = None
    moved_err, moved = [], 0
    for i in range(1, track_frames, 2):
        cnn, tracked = datums[i - 1], datums[i]
        assert tracked.pose_keypoints.shape == cnn.pose_keypoints.shape
        np.testing.assert_array_equal(tracked.pose_scores, cnn.pose_scores)
        # keypoints LK moved: confident, and still so after the frame
        keep = (cnn.pose_keypoints[..., 2] > 0.05) \
            & (tracked.pose_keypoints[..., 2] > 0.05)
        flow = (tracked.pose_keypoints - cnn.pose_keypoints)[keep][:, :2]
        moved += int(keep.sum())
        moved_err += np.abs(flow - np.asarray(shift, np.float32)) \
            .max(axis=1).tolist()
    assert moved >= 10, "LK moved too few keypoints to judge"
    within = float(np.mean(np.asarray(moved_err) <= 0.5))
    out["tracking"] = {
        "cnn_frame_ms": float(np.mean(times[0])),
        "lk_frame_ms": float(np.mean(times[1])),
        "cnn_frame_pose_stage_ms": float(np.mean(pose_times[0])),
        "lk_frame_pose_stage_ms": float(np.mean(pose_times[1])),
        "keypoints_moved": moved, "shift_px": list(shift),
        "median_err_px": float(np.median(moved_err)),
        "share_within_half_px": within}
    log(f"wrapper tracking=1 over {track_frames} frames moved by {shift} px: "
        + json.dumps(out["tracking"]))
    assert np.median(moved_err) <= 0.5 and within >= 0.9, out["tracking"]

    # LK alone, as the tracker calls it: all kept people's keypoints
    tracker = wrapper._pose_tracker
    gray0 = tracker.prev_gray
    gray1 = gray0.roll((shift[1], shift[0]), dims=(0, 1))
    pts = tracker.keypoints[..., :2].reshape(-1, 2)
    call = lambda: [t.cpu() for t in lk.pyramidal_lk(gray0, gray1, pts,
                                                     device=device)]
    out["lk_call"] = {"points": int(pts.shape[0]), "ms": host_ms(call, 10)}
    if device.type == "cuda":
        out["lk_call"]["trace"] = device_busy(call, 5)
    log(f"LK call on the tracker's {pts.shape[0]} points at {frame_hw}: "
        + json.dumps(out["lk_call"]))
    out["lk_cpu_check"] = lk_cpu_check(device, frame_hw)
    out["launches"] = read_launches("wrapper path", paf_cuda.paf_scores_fused)
    return out


def runner_phase(device, model, batch=8, net_hw=(368, 656), n_batches=4):
    """`VideoRunner`'s batch loop over batch-`batch` `PoseInference`, fed
    frames in memory: every frame's result, in order, equal to the
    sequential `inference(batch)` -> `fetch` -> `assemble` of the same
    frames (the same device work on the same inputs: 1e-4 px and 1e-4 in
    score allowed); frames/s by assembly workers and batches in flight
    beside the sequential figure, and the card's busy share of the wall
    time."""
    import numpy as np
    from openpose_tpu_torch.ops import paf_cuda
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.runtime.video_runner import VideoRunner

    rng = np.random.RandomState(41)
    frames = scene_frames(rng, batch * n_batches, net_hw)
    inference = PoseInference(model, net_hw=net_hw, device=device)
    scales = np.ones((batch,), np.float64)

    def batches():
        for i in range(0, len(frames), batch):
            yield frames[i:i + batch], scales, batch

    def sequential():
        results = []
        for images, _, real in batches():
            pk, sc = inference.fetch(*inference(images))
            results += [inference.assemble(pk[b], sc[b]) for b in range(real)]
        return results

    reset_launches()
    sequential()                                           # warm-up
    t0 = time.perf_counter()
    want = sequential()
    seq_s = time.perf_counter() - t0
    out = {"frames": len(frames), "batch": batch,
           "sequential_fps": len(frames) / seq_s,
           "people_per_frame_mean": float(np.mean([len(kp)
                                                   for kp, _ in want]))}
    log(f"runner: sequential {len(frames)} frames at {net_hw}, batch {batch}: "
        f"{out['sequential_fps']} f/s, {out['people_per_frame_mean']} people "
        f"per frame")
    runs = {}
    for workers, in_flight in ((1, 2), (4, 2), (1, 4), (4, 4)):
        runner = VideoRunner(inference, batch_size=batch,
                             assembly_workers=workers,
                             max_in_flight=in_flight)
        t0 = time.perf_counter()
        got = list(runner._run_batches(batches(), lambda i: net_hw[::-1]))
        seconds = time.perf_counter() - t0
        assert [r.index for r in got] == list(range(len(frames)))
        diff = 0.0
        for res, (kp, person_scores) in zip(got, want):
            assert res.keypoints.shape == kp.shape, (res.index, kp.shape)
            if kp.size:
                diff = max(diff, float(np.abs(res.keypoints - kp).max()),
                           float(np.abs(res.scores - person_scores).max()))
        assert diff <= 1e-4, diff
        runs[f"workers{workers}_inflight{in_flight}"] = {
            "fps": len(frames) / seconds, "max_abs_diff": diff}
    out["runs"] = runs
    log("runner: frames/s by assembly workers and batches in flight: "
        + json.dumps(runs))
    if device.type == "cuda":
        runner = VideoRunner(inference, batch_size=batch, assembly_workers=4,
                             max_in_flight=4)
        out["trace_workers4_inflight4"] = trace = device_busy(
            lambda: list(runner._run_batches(batches(),
                                             lambda i: net_hw[::-1])), 1)
        log(f"trace, runner with 4 workers and 4 in flight, "
            f"{len(frames)} frames per call: {json.dumps(trace)}")
    out["launches"] = read_launches("runner path", paf_cuda.paf_scores_fused)
    return out


def accuracy_phase(device, model, n_images=64, net_hws=((368, 656), (176, 320)),
                   ap_floors=(0.95, 0.90), batch=8, topdown_frames=16,
                   topdown_net=368, iters=10):
    """The closed accuracy loop in float32: `accuracy.synthetic_coco_eval`
    at each net size must reach its AP floor and `synthetic_topdown_eval`
    an RMSE under 2 px for faces and hands (the limits of the JAX
    package's own tests).  Then one batch of the loop (1-4 placed people a
    frame) by hand: the fused kernel against its plain version on the
    batch's tensors, and where a batch's time goes."""
    import numpy as np
    import torch
    from openpose_tpu_torch import accuracy, synthetic, train
    from openpose_tpu_torch.ops import paf, paf_cuda
    from openpose_tpu_torch.parallel.inference import PoseInference

    out = {}
    reset_launches()
    for net_hw, floor in zip(net_hws, ap_floors):
        t0 = time.perf_counter()
        metrics = accuracy.synthetic_coco_eval(
            n_images=n_images, net_hw=net_hw, batch=batch, model=model,
            device=device)
        metrics["seconds"] = time.perf_counter() - t0
        out[f"coco_{net_hw[0]}x{net_hw[1]}"] = metrics
        log(f"accuracy: synthetic_coco_eval at {net_hw}, {n_images} images: "
            f"{json.dumps(metrics)} (AP floor {floor})")
        assert metrics["AP"] >= floor, metrics
    for kind in ("face", "hand"):
        metrics = accuracy.synthetic_topdown_eval(
            kind, n_frames=topdown_frames, net_size=topdown_net, batch=batch,
            device=device)
        out[f"topdown_{kind}"] = metrics
        log(f"accuracy: synthetic_topdown_eval {json.dumps(metrics)} "
            f"(RMSE limit 2.0 px)")
        assert metrics["rmse_px"] < 2.0 and metrics["n_instances"] > 0, metrics
    out["launches"] = read_launches("accuracy loop", paf_cuda.paf_scores_fused)

    # one batch of the loop, as `synthetic_coco_eval` makes it
    net_hw = net_hws[0]
    info = model.info
    rng = np.random.RandomState(0)
    kp = np.zeros((batch, 4, info.num_parts, 3), np.float32)
    for b in range(batch):
        people = synthetic.random_people(rng, rng.randint(1, 5), net_hw)
        kp[b, :len(people)] = people
    inference = PoseInference(model, net_hw=net_hw, device=device,
                              net_bypass=True, compute_dtype=torch.float32)
    kp_dev = torch.from_numpy(kp).to(device)
    render = lambda: train.make_targets(
        kp_dev, inference.pairs, inference.map_idx, net_hw, info.num_parts,
        info.heatmap_channels)
    net_out = render()
    nms_thr, inter_thr, inter_min = inference.thresholds
    with torch.inference_mode():
        peaks, _ = inference.decode([net_out])
        args = ([net_out], [1.0], net_hw, peaks, inference.pairs,
                inference.map_idx, inter_thr, inter_min, nms_thr)
        got = paf_cuda.paf_scores_fused(*args)
        want = paf.paf_scores_multiscale_reference(*args)
        kernel = {
            "max_abs_err": float((got - want).abs().max()),
            "mismatches": int((got != want).sum()),
            "accepted": int((want > 0).sum()),
            "peaks_per_part_mean": float(peaks[:, :, 0, 0].mean()),
            "ms": timed(lambda: paf_cuda.paf_scores_fused(*args), 3, 20,
                        device),
            "plain_ms": timed(
                lambda: paf.paf_scores_multiscale_reference(*args), 1, 2,
                device),
            "bound": fused_bound([net_out], peaks, inference.pairs,
                                 inference.map_idx)}
    kernel["share_of_bound"] = kernel["bound"]["bound_ms"] / kernel["ms"]
    kernel["launches_per_batch"] = launches_per_call(
        "accuracy loop, one batch", lambda: inference(net_out))[
            "paf_scores_fused"]
    out["kernel_on_loop_batch"] = kernel
    log(f"fused kernel on a batch of the accuracy loop ({batch} x "
        f"{net_hw[0] // 8}x{net_hw[1] // 8} maps): tol={KERNEL_TOL} "
        + json.dumps(kernel))
    assert kernel["mismatches"] == 0 and kernel["max_abs_err"] <= KERNEL_TOL
    assert kernel["accepted"] > 0

    def assemble_all(pk, sc):
        return [inference.assemble(pk[b], sc[b], 1.0) for b in range(batch)]

    def end_to_end():
        return assemble_all(*inference.fetch(*inference(render())))
    pk, sc = inference.fetch(*inference(net_out))
    ms_device = timed(lambda: inference(net_out), 2, iters, device)
    ms_fetch = host_ms(lambda: inference.fetch(*inference(net_out)), iters)
    ms_e2e = host_ms(end_to_end, iters)
    timing = {
        "people_per_frame": [len(kps) for kps, _ in assemble_all(pk, sc)],
        "placed_per_frame": (kp[:, :, 0, 2] > 0).sum(axis=1).tolist(),
        "ms_render_targets": timed(render, 2, iters, device),
        "ms_decode_device": ms_device,
        "ms_fetch": ms_fetch - ms_device,
        "ms_assembly": host_ms(lambda: assemble_all(pk, sc), iters),
        "ms_end_to_end": ms_e2e, "images_per_s": batch * 1e3 / ms_e2e}
    if device.type == "cuda":
        timing["trace"] = device_busy(end_to_end, 5)
    out["batch_timing"] = timing
    log(f"accuracy loop, one batch of {batch} at {net_hw}, f32: "
        + json.dumps(timing))
    assert timing["people_per_frame"] == timing["placed_per_frame"]
    return out


def _training_batch(device, config, seed=0):
    """One batch of the trainer's scenes on the device: (uint8 images,
    keypoints)."""
    import torch
    from openpose_tpu_torch import train_loop
    images, keypoints = next(train_loop.synthetic_scene_iterator(
        config, seed=seed, device=device))
    return images, torch.from_numpy(keypoints).to(device)


def conv_kernels(prof, top=6):
    """The convolution kernels of a torch.profiler trace: the `top` names by
    device time (ms), and whether any is a Winograd or FFT algorithm (the
    cuDNN engines that do not compute the plain sums of products)."""
    from torch.autograd import DeviceType
    words = ("cudnn", "cutlass", "gemm", "conv", "grad", "fprop", "winograd",
             "fft", "xmma")
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA \
                and any(w in e.name.lower() for w in words):
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    names = sorted(by_name, key=by_name.get, reverse=True)
    return {"distinct": len(names),
            "winograd_or_fft": sorted(n[:60] for n in names if any(
                w in n.lower() for w in ("winograd", "fft"))),
            "top_ms": [(n[:60], by_name[n] / 1e3) for n in names[:top]]}


def gradient_check(device, image_size=(96, 128), batch=2, seeds=(0,)):
    """One loss and its gradients at BODY_25's full width on the card in
    float32 (TF32 off) against the same on the CPU in float64.

    Tolerance.  At He-normal weights float32 itself is far from a float64
    run: a pre-activation within rounding of 0 switches a PReLU or ReLU
    branch, and some hundred layers hand the difference on.  How far is a
    property of the batch and the weights, not of the algorithm.  NVIDIA
    H100, 96x128, batch 2, seeds 0, 1, 2, errors as shares of each tensor's
    largest entry: the card's worst tensor 8.1e-3, 8.8e-3, 4.3e-4, its
    median tensor 6.1e-4, 2.6e-4, 1.1e-6; the CPU's own float32 (plain sums
    of products) 6.2e-3, 8.6e-3, 6.6e-3 and 4.7e-4, 7.5e-5, 6.1e-5.  The
    card's float32 is read three times: with cuDNN's benchmarked algorithms
    (as the trainer runs; the trace holds the search's trials too), with
    `cudnn.deterministic` and no benchmark, and from the benchmark's cache
    after a float64 run on the card (the trace holds the chosen kernels
    only).  cuDNN picks Winograd weight-gradient kernels for some layers
    and, in the deterministic mode, FFT ones; the three readings agree in
    their first four digits all the same.  With TF32 convolutions the card
    is at 5.7e-2 to 6.0e-2 and 1.0e-2 to 1.5e-2: that run is the control
    and must fail the limits.  Limits: loss within 1e-4 relative, every
    gradient finite and within GRAD_WORST of its tensor's largest entry,
    the median tensor within GRAD_MEDIAN."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from openpose_tpu_torch import train, train_loop
    from openpose_tpu_torch.models import graph
    from openpose_tpu_torch.ops import paf
    from openpose_tpu_torch.ops.resize import normalize_vgg
    from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel

    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    spec = graph.load_spec(info.spec)
    config = train_loop.TrainConfig(image_size=image_size, batch_size=batch)
    cpu = torch.device("cpu")
    pairs, map_idx = (torch.from_numpy(t) for t in paf.pair_tables(info))
    cudnn = torch.backends.cudnn
    out = {"image_size": list(image_size), "batch": batch,
           "limits": {"loss": 1e-4, "worst": GRAD_WORST,
                      "median": GRAD_MEDIAN}, "seeds": {}}
    for seed in seeds:
        images, keypoints = _training_batch(cpu, config, seed=seed)
        targets = train.make_targets(keypoints, pairs, map_idx, image_size,
                                     info.num_parts, info.heatmap_channels)
        x = normalize_vgg(images.to(torch.float32))
        params = graph.init_params(spec, torch.Generator().manual_seed(seed))

        def run(dev, dtype=torch.float32, tf32=False, benchmark=True,
                deterministic=False):
            """(loss, gradients, convolution kernels) of one step.  The
            float32 step is the trainer's own (`train.loss_fn` inside
            `full_f32_convs`); float64 and TF32, which the port's entry
            points refuse, go through the net's layers directly."""
            net = graph.PoseNet(spec, params, trainable=True).to(dev)
            x_dev, t_dev = x.to(dev), targets.to(dev)
            trace = contextlib.nullcontext() if dev.type != "cuda" else \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
            with cudnn.flags(enabled=True, benchmark=benchmark,
                             deterministic=deterministic, allow_tf32=tf32), \
                    trace as prof:
                if dtype == torch.float32 and not tf32:
                    with graph.full_f32_convs():
                        loss = train.loss_fn(net, x_dev, t_dev, dtype)
                        loss.backward()
                else:
                    loss = torch.mean((net._run(x_dev, dtype) - t_dev) ** 2)
                    loss.backward()
                _sync(dev)
            grads = {name: p.grad.double().cpu()
                     for name, p in net.weights.items()}
            assert all(bool(torch.isfinite(g).all()) for g in grads.values())
            return float(loss.detach()), grads, \
                conv_kernels(prof) if prof is not None else None

        want_loss, want, _ = run(cpu, torch.float64)

        def errors(result):
            loss, grads, kernels = result
            rel = {name: float((grads[name] - ref).abs().max()
                               / ref.abs().max().clamp(min=1e-30))
                   for name, ref in want.items()}
            worst = max(rel, key=rel.get)
            return {"loss_rel_err": abs(loss - want_loss) / abs(want_loss),
                    "worst": rel[worst], "worst_tensor": worst,
                    "median": float(np.median(list(rel.values()))),
                    "conv_kernels": kernels}
        readings = {
            "card_f32_benchmark": errors(run(device)),
            "card_f32_deterministic": errors(
                run(device, benchmark=False, deterministic=True)),
            "card_f64": errors(run(device, torch.float64)),
            "card_f32_benchmark_after_f64": errors(run(device)),
            "card_tf32_control": errors(run(device, tf32=True)),
            "cpu_f32": errors(run(cpu))}
        readings["loss_cpu_f64"] = want_loss
        readings["tensors"] = len(want)
        out["seeds"][seed] = readings
        for name, r in readings.items():
            if isinstance(r, dict):
                log(f"train (a) seed {seed}, {name} vs CPU f64: "
                    + json.dumps(r))
        for name in ("card_f32_benchmark", "card_f32_deterministic",
                     "card_f32_benchmark_after_f64"):
            r = readings[name]
            assert r["loss_rel_err"] <= 1e-4, (name, r)
            assert r["worst"] <= GRAD_WORST, (name, r)
            assert r["median"] <= GRAD_MEDIAN, (name, r)
        if device.type == "cuda":   # the control: the limits can see TF32
            r = readings["card_tf32_control"]
            assert r["worst"] > GRAD_WORST or r["median"] > GRAD_MEDIAN, r
    return out


def step_breakdown(device, config, compute_dtype, iters=5):
    """Where one train step's time goes (CUDA events around each part, its
    inputs ready on the device), torch's FLOP count of one real step, and
    the scene renderers' times."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from openpose_tpu_torch import synthetic, train, train_loop
    from openpose_tpu_torch.models import graph
    from openpose_tpu_torch.ops.resize import normalize_vgg

    trainer = train_loop.Trainer(config, device, compute_dtype)
    images, keypoints = _training_batch(device, config)
    state, info = trainer.state, trainer.info
    make_targets = lambda: train.make_targets(
        keypoints, trainer.pairs, trainer.map_idx, config.image_size,
        info.num_parts, info.heatmap_channels, sigma=config.target_sigma)
    targets = make_targets()
    x = normalize_vgg(images.to(torch.float32))
    trainer.step(images, keypoints)                       # warm-up
    with FlopCounterMode(display=False) as counter:
        trainer.step(images, keypoints)
    out = {"step_flops_counted": counter.get_total_flops(),
           "step_flops_3x_forward": 3e9 * trainer.fwd_gflops
           * config.batch_size}

    def forward():
        with torch.no_grad():
            return train.loss_fn(state.net, x, targets, compute_dtype)

    def forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        with graph.full_f32_convs():
            train.loss_fn(state.net, x, targets, compute_dtype).backward()
    out["ms_forward"] = timed(forward, 1, iters, device)
    out["ms_forward_backward"] = timed(forward_backward, 1, iters, device)
    out["ms_optimizer"] = timed(state.optimizer.step, 1, iters, device)
    out["ms_targets"] = timed(make_targets, 1, iters, device)
    out["ms_normalize"] = timed(
        lambda: normalize_vgg(images.to(torch.float32)), 1, iters, device)
    out["ms_whole_step"] = timed(lambda: trainer.step(images, keypoints), 1,
                                 iters, device)
    if device.type == "cuda":
        out["trace_whole_step"] = device_busy(
            lambda: (trainer.step(images, keypoints), _sync(device)), 2)
    # the scenes: the numpy renderer on the host against the iterator's
    # split (people and noise on the host, strokes on the device)
    h, w = config.image_size
    kps = keypoints.cpu().numpy()
    rng = np.random.RandomState(0)
    host_images = np.stack([synthetic.scene_background((h, w), rng)
                            for _ in range(config.batch_size)])
    background = torch.from_numpy(host_images.astype(np.uint8))
    out["ms_numpy_renderer"] = host_ms(lambda: [
        synthetic.render_scene_image(people[people[:, 0, 2] > 0], (h, w), rng)
        for people in kps], 2)
    out["ms_host_noise"] = host_ms(lambda: [
        synthetic.scene_background((h, w), rng).astype(np.uint8)
        for _ in range(config.batch_size)], 2)
    out["ms_host_to_device"] = host_ms(
        lambda: (background.to(device), _sync(device)), iters)
    on_device = background.to(device)
    out["ms_device_renderer"] = timed(
        lambda: synthetic.render_scene_batch(kps, on_device), 1, iters, device)
    it = train_loop.synthetic_scene_iterator(config, device=device)
    out["ms_iterator_batch"] = host_ms(lambda: (next(it), _sync(device)), 3)
    return out


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serving_peak_mb(model, images, dtype, device):
    """Peak device memory of one `PoseInference` call on `images`, above
    what was allocated before it (0.0 on a CPU)."""
    import torch
    from openpose_tpu_torch.parallel.inference import PoseInference
    inference = PoseInference(model, net_hw=tuple(images.shape[1:3]),
                              device=device, compute_dtype=dtype)
    inference(images)                                   # warm-up
    if device.type != "cuda":
        return 0.0
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    peaks, scores = inference(images)
    torch.cuda.synchronize(device)
    assert not peaks.requires_grad and not scores.requires_grad
    return (torch.cuda.max_memory_allocated(device) - before) / 1e6


def trained_frame_kernel_check(device, trained, image_size, seed=1,
                               iters=20):
    """The fused kernel against its plain version at the shape that
    `accuracy.train_to_ap`'s evaluation gives it: the first held-out frame
    (the evaluation's own seed) through the trained net as
    `PoseExtractor.forward` runs it in float32: N = 1, one scale, maps of an
    eighth of the net input (image_size to a multiple of 16: 22x40 at
    184x328), the trained net's own peaks."""
    import numpy as np
    import torch
    from openpose_tpu_torch import accuracy
    from openpose_tpu_torch.ops import paf, paf_cuda
    from openpose_tpu_torch.pose import scaler
    from openpose_tpu_torch.pose.extractor import PoseExtractor

    h, w = image_size
    placed, frame = accuracy.held_out_scenes(1, image_size, (1, 3), seed)[0]
    extractor = PoseExtractor(trained, compute_dtype=torch.float32,
                              device=device)
    plan = scaler.extract_scales((w, h), (w, h))
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf.pair_tables(trained.info))
    cp = extractor.connect
    image = torch.tensor(frame.astype(np.float32)[None], device=device)
    with torch.inference_mode():
        sources = extractor.net_outputs(image, plan)
        peaks, _ = extractor.decode(sources, plan, 0.5)
        args = (sources, plan.scale_input_to_net, (h, w), peaks, pairs,
                map_idx, cp.inter_threshold, cp.inter_min_above_threshold,
                cp.nms_threshold)
        got = paf_cuda.paf_scores_fused(*args)
        want = paf.paf_scores_multiscale_reference(*args)
        out = {
            "maps": list(sources[0].shape), "placed": len(placed),
            "max_abs_err": float((got - want).abs().max()),
            "mismatches": int((got != want).sum()),
            "accepted": int((want > 0).sum()),
            "peaks_per_part_mean": float(peaks[:, :, 0, 0].mean()),
            "ms": timed(lambda: paf_cuda.paf_scores_fused(*args), 3, iters,
                        device),
            "plain_ms": timed(
                lambda: paf.paf_scores_multiscale_reference(*args), 1, 2,
                device),
            "bound": fused_bound(sources, peaks, pairs, map_idx)}
    out["share_of_bound"] = out["bound"]["bound_ms"] / out["ms"]
    log(f"fused kernel on a held-out frame of the trained net (1 x "
        f"{out['maps'][1]}x{out['maps'][2]} maps): tol={KERNEL_TOL} "
        + json.dumps(out))
    assert out["mismatches"] == 0 and out["max_abs_err"] <= KERNEL_TOL, out
    assert out["accepted"] > 0, out
    return out


def train_phase(device, image_size=(368, 368), batch=8, steps=30,
                check_size=(96, 128), t2ap_steps=1500, t2ap_size=(184, 328),
                t2ap_eval=16):
    """The trainer on the card at BODY_25's full width: (a) gradients
    against the CPU; (b) `train_loop.train` at `TrainConfig`'s default size
    with float32 and with bfloat16 operands: step time, fed rate, FLOP
    rate against the datasheet peak, memory; the loss must fall and the
    parameters stay finite; (c) the checkpoint it wrote, loaded into a
    serving model, answers bit for bit as the trained net; (d)
    `accuracy.train_to_ap`, 1500 steps with the cosine schedule."""
    import torch
    from openpose_tpu_torch import accuracy, train_loop
    from openpose_tpu_torch.models import checkpoint, graph, zoo
    from openpose_tpu_torch.ops import paf_cuda
    from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel

    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    reset_launches()
    out = {"gradients": gradient_check(device, check_size)}
    ckpt_dir = OUT_DIR / "checkpoints"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        config = train_loop.TrainConfig(
            image_size=image_size, batch_size=batch, steps=steps,
            checkpoint_every=steps, checkpoint_dir=str(ckpt_dir / name))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        stats = {}
        state = train_loop.train(
            config, train_loop.synthetic_scene_iterator(
                config, prefetch_workers=2, device=device),
            verbose=False, stats_out=stats, device=device,
            compute_dtype=dtype)
        if device.type == "cuda":
            stats["peak_memory_gb"] = \
                torch.cuda.max_memory_allocated(device) / 1e9
        stats.update(train_loop.device_step_probe(
            config, device=device, compute_dtype=dtype))
        stats["breakdown"] = step_breakdown(device, config, dtype)
        first, last = stats["losses"][0], stats["losses"][steps - 1]
        finite = all(bool(torch.isfinite(p).all())
                     for p in state.net.parameters())
        out[name] = stats
        log(f"train (b) {name}: {steps} steps of batch {batch} at "
            f"{image_size}: {json.dumps(stats)}")
        assert finite, f"{name}: a parameter is not finite"
        # observed on the card: 1.09 -> 0.0064 in 30 steps, both types
        assert last < 0.1 * first, f"{name}: loss {first} -> {last}"

        # (c) the checkpoint against the net that wrote it
        path = ckpt_dir / name / f"{info.name}_step{steps}.npz"
        served = zoo.from_params(graph.load_spec(info.spec),
                                 checkpoint.load_npz(str(path)), info, device)
        images, _ = _training_batch(device, config, seed=5)
        x = images[:2].to(torch.float32) / 256.0 - 0.5
        with torch.inference_mode():
            want = state.net.serving_view()(x, dtype)
            got = served.forward(x, dtype)
        equal = bool(torch.equal(got, want))
        out[name]["checkpoint_bit_equal"] = equal
        out[name]["checkpoint_mb"] = path.stat().st_size / 1e6
        log(f"train (c) {name}: {path.name} ({out[name]['checkpoint_mb']:.1f} "
            f"MB) loaded into a serving model: outputs bit-equal to the "
            f"trained net's: {equal}; requires_grad of its output: "
            f"{got.requires_grad}")
        assert equal and not got.requires_grad and got.grad_fn is None
        # serving records no graph: a call takes the device memory it takes
        # with weights from a file, over the trainer's own storage too
        state.optimizer.zero_grad(set_to_none=True)
        peaks = {"loaded": _serving_peak_mb(served, images, dtype, device),
                 "serving_view": _serving_peak_mb(
                     zoo.Model(served.spec, state.net.serving_view(), info),
                     images, dtype, device),
                 "trainers_net": _serving_peak_mb(
                     zoo.Model(served.spec, state.net, info), images, dtype,
                     device)}
        out[name]["serving_peak_mb"] = peaks
        log(f"train (c) {name}: peak device memory of one PoseInference call "
            f"above what was held before it (MB): {json.dumps(peaks)}")
        assert max(peaks.values()) - min(peaks.values()) <= 1.0, peaks
        del state, served
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (d) train -> checkpoint -> serve -> AP, with the cosine schedule of
    # `--train-to-ap`: `cli_phase` counts the people this net finds, and a
    # 400-step net with a constant rate (AP 0.67-0.70) found a spurious
    # extra person on 3 and 4 of 16 frames in two of five runs on one H100
    t0 = time.perf_counter()
    metrics = accuracy.train_to_ap(
        steps=t2ap_steps, image_size=t2ap_size, batch=batch, n_eval=t2ap_eval,
        lr_schedule="cosine", checkpoint_dir=str(ckpt_dir / "t2ap"),
        verbose=False, device=device)
    metrics["seconds"] = time.perf_counter() - t0
    out["train_to_ap"] = metrics
    log(f"train (d): train_to_ap, {t2ap_steps} cosine steps at {t2ap_size}, "
        "f32: " + json.dumps(metrics))
    losses = metrics["losses"]
    assert all(v == v and v < float("inf") for v in losses.values()), losses
    # observed on the card at 400 steps: 0.99 -> 0.0084 at step 50 -> 0.0033
    assert losses[t2ap_steps - 1] < 0.05 * losses[0], losses
    assert metrics["n_gt"] > 0
    # the evaluation's frames went through the fused kernel, one each
    out["launches"] = read_launches("train path", paf_cuda.paf_scores_fused)
    # and at that shape the kernel is held to its plain version
    # the checkpoint stays for `cli_phase`, which serves it and removes it
    out["checkpoint"] = str(ckpt_dir / "t2ap"
                            / f"{info.name}_step{t2ap_steps}.npz")
    trained = zoo.load_pose_model(caffemodel=out["checkpoint"], device=device)
    out["kernel_on_trained_frame"] = trained_frame_kernel_check(
        device, trained, t2ap_size)
    return out


def train_to_ap_run(device, steps=1500, image_size=(184, 328), batch=8,
                    n_eval=16):
    """`--train-to-ap`: BODY_25 trained from scratch with the cosine
    schedule until the pipeline decodes it (the mark: AP50 >= 0.9 on the
    held-out scenes), then the trained net, loaded from its checkpoint:
    the fused kernel against its plain version on a held-out frame, batch-8
    `PoseInference` on held-out scenes, and one frame through `Wrapper`s
    that load the checkpoint themselves, without and with top-down
    refinement."""
    import numpy as np
    import torch
    from openpose_tpu_torch import accuracy
    from openpose_tpu_torch.models import zoo
    from openpose_tpu_torch.ops import paf_cuda
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
    from openpose_tpu_torch.wrapper import PoseConfig, Wrapper

    ckpt_dir = OUT_DIR / "train_to_ap"
    reset_launches()
    t0 = time.perf_counter()
    metrics = accuracy.train_to_ap(
        steps=steps, image_size=image_size, batch=batch, n_eval=n_eval,
        lr_schedule="cosine", checkpoint_dir=str(ckpt_dir), verbose=True,
        device=device)
    metrics["seconds"] = time.perf_counter() - t0
    log(f"train_to_ap, {steps} steps at {image_size}, cosine, f32: "
        + json.dumps(metrics))
    log(f"AP50 >= 0.9 reached: {metrics['AP50'] >= 0.9}")
    out = {"train_to_ap": metrics}

    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    path = str(ckpt_dir / f"{info.name}_step{steps}.npz")
    trained = zoo.load_pose_model(caffemodel=path, device=device)
    out["launches"] = read_launches("train_to_ap's evaluation",
                                    paf_cuda.paf_scores_fused)
    out["kernel_on_trained_frame"] = trained_frame_kernel_check(
        device, trained, image_size)
    scenes = accuracy.held_out_scenes(batch, image_size, (1, 3), seed=2)
    frames = torch.from_numpy(np.stack([img for _, img in scenes])).to(device)
    inference = PoseInference(trained, net_hw=image_size, device=device)

    def end_to_end():
        pk, sc = inference.fetch(*inference(frames))
        return pk, [inference.assemble(pk[b], sc[b]) for b in range(batch)]
    pk, people = end_to_end()
    ms_device = timed(lambda: inference(frames), 2, 10, device)
    ms_fetch = host_ms(lambda: inference.fetch(*inference(frames)), 10)
    sc = inference.fetch(*inference(frames))[1]
    ms_e2e = host_ms(end_to_end, 10)
    served = {
        "batch": batch, "net_hw": list(image_size), "compute_dtype": "bf16",
        "peaks_per_part_mean": float(pk[:, :, 0, 0].mean()),
        "people_per_frame": [len(kps) for kps, _ in people],
        "placed_per_frame": [len(p) for p, _ in scenes],
        "ms_device": ms_device, "ms_fetch": ms_fetch - ms_device,
        "ms_assembly": host_ms(lambda: [inference.assemble(pk[b], sc[b])
                                        for b in range(batch)], 10),
        "ms_end_to_end": ms_e2e, "fps_end_to_end": batch * 1e3 / ms_e2e}
    if device.type == "cuda":
        served["trace"] = device_busy(end_to_end, 5)
    out["served"] = served
    log(f"the trained net, batch-{batch} PoseInference on held-out scenes: "
        + json.dumps(served))

    # one frame through two Wrappers made by the constructor on the
    # checkpoint, without and with refinement: a person whose keypoints the
    # refined one moved was replaced by the merge branch
    placed, frame = accuracy.held_out_scenes(1, image_size, (3, 3), seed=3)[0]
    data, launches = {}, {}
    for refined in (False, True):
        wrapper = Wrapper(PoseConfig(
            caffemodel=path, net_resolution=(image_size[1], image_size[0]),
            compute_dtype="float32", top_down_refinement=refined),
            device=device)
        launches[refined] = launches_per_call(
            f"Wrapper.process on the trained net, refinement {refined}",
            lambda: data.update({refined: wrapper.process(frame)}))[
                "paf_scores_fused"]
    plain, fine = data[False].pose_keypoints, data[True].pose_keypoints
    assert plain.shape == fine.shape, (plain.shape, fine.shape)
    moved = np.abs(fine - plain).reshape(len(plain), -1).max(axis=1) \
        if len(plain) else np.zeros(0)
    out["refined_frame"] = {
        "placed": len(placed), "people": len(plain),
        "fused_launches_plain": launches[False],
        "fused_launches_refined": launches[True],
        "replaced": int((moved > 1e-3).sum()),
        "max_keypoint_shift_px": [float(m) for m in moved]}
    log(f"Wrapper.process with refinement on a trained net's frame: "
        + json.dumps(out["refined_frame"]))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "train_to_ap.json").write_text(json.dumps(out, indent=1))
    return out


@contextlib.contextmanager
def frames_from_memory(frames, names):
    """For the length of the block, `producers.create_producer` (which the
    CLI looks up when it runs) makes a producer that yields `frames` from
    memory under `names`, with the CLI's windowing, split and cameras: the
    card's machine has no OpenCV to read files."""
    from openpose_tpu_torch.io import producers

    class MemoryProducer(producers.Producer):
        def _raw_frames(self):
            yield from zip(frames, names)

    create = producers.create_producer
    producers.create_producer = \
        lambda **kwargs: MemoryProducer(kwargs["config"])
    try:
        yield
    finally:
        producers.create_producer = create


def run_cli(argv, device):
    """`cli.main(argv)` on `device`; (seconds, printed text).  Fails unless
    it returns 0."""
    import io
    from openpose_tpu_torch import cli
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv, device=device)
    seconds = time.perf_counter() - t0
    assert rc == 0, (argv, rc, out.getvalue())
    return seconds, out.getvalue()


def cli_figures(text):
    """The CLI's own frames/s line and the last report of each profiler
    key, from what it printed."""
    import re
    fps = re.findall(r"openpose_tpu_torch: (\d+) frames in [\d.]+s "
                     r"\(([\d.]+) fps\)", text)
    stages = {key: float(ms) for key, ms, _ in re.findall(
        r"\[profiler\] (\w+): ([\d.]+) ms avg over (\d+)", text)}
    return {"frames": int(fps[-1][0]), "fps": float(fps[-1][1]),
            "stage_ms": stages}


def write_model_folder(npz, folder):
    """A trainer's checkpoint as the caffemodel of BODY_25 under a model
    folder (the reference's layout), the one way `capi`'s config names
    weights."""
    import numpy as np
    from openpose_tpu_torch.models import caffe_proto, checkpoint, zoo
    from openpose_tpu_torch.params import PoseModel
    layers = {}
    for name, p in checkpoint.to_jax_params(checkpoint.load_npz(npz)).items():
        layers[name] = ([np.asarray(p["w"]).transpose(3, 2, 0, 1), p["b"]]
                        if "w" in p else [p["slope"]])
    path = pathlib.Path(folder) / zoo.CAFFEMODEL_PATHS[PoseModel.BODY_25]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(caffe_proto.serialize_caffemodel(layers))
    return str(folder)


def arc_rig(n_cams, radius=3.0, focal=800.0, center=(320.0, 240.0)):
    """[V, 3, 4] K[R|t] of cameras on an arc looking at the origin (the
    JAX suite's 3-D rig)."""
    import numpy as np
    k = np.array([[focal, 0, center[0]], [0, focal, center[1]], [0, 0, 1]])
    cams = []
    for i in range(n_cams):
        angle = (i - (n_cams - 1) / 2) * 0.35
        c = np.array([radius * np.sin(angle), 0.0, -radius * np.cos(angle)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        r = np.stack([x, np.cross(z, x), z])
        cams.append(k @ np.hstack([r, (-r @ c)[:, None]]))
    return np.stack(cams).astype(np.float32)


def rig_views(rng, cams, people, parts, noise=0.5):
    """Random 3-D people seen by `cams` with `noise` px of Gaussian noise:
    (views [V x [people, parts, 3]], truth [people, parts, 3])."""
    import numpy as np
    truth = rng.uniform(-0.5, 0.5, (people, parts, 3))
    homog = np.concatenate([truth, np.ones((people, parts, 1))], -1)
    views = []
    for cam in cams:
        proj = homog @ cam.T
        pix = proj[..., :2] / proj[..., 2:] + rng.normal(0, noise,
                                                        (people, parts, 2))
        score = rng.uniform(0.5, 1.0, (people, parts, 1))
        views.append(np.concatenate([pix, score], -1).astype(np.float32))
    return views, truth


def capi_shim_check(device, model_folder, frames, want):
    """The port's C shim through ctypes, when this interpreter has the
    headers and shared library to embed: built with g++ (a failed build
    fails the phase), then `op_create` / `op_process` over `frames`, held
    bit for bit to `want`.  None when the check is not made."""
    import ctypes
    import sysconfig
    import numpy as np
    from openpose_tpu_torch.utils import native_build
    header = pathlib.Path(sysconfig.get_paths()["include"]) / "Python.h"
    libpython = pathlib.Path(sysconfig.get_config_var("LIBDIR")) / \
        sysconfig.get_config_var("LDLIBRARY")
    ready = header.exists() and libpython.exists() \
        and bool(sysconfig.get_config_var("Py_ENABLE_SHARED"))
    log(f"cli (e) C shim: {header} exists {header.exists()}; {libpython} "
        f"(shared {bool(sysconfig.get_config_var('Py_ENABLE_SHARED'))}) "
        f"exists {libpython.exists()}: "
        f"{'building the shim' if ready else 'the shim is not built'}")
    if not ready:
        return None
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(native_build.build_capi()))
    build_s = time.perf_counter() - t0
    lib.op_create.restype = ctypes.c_void_p
    lib.op_create.argtypes = [ctypes.c_char_p]
    lib.op_process.restype = ctypes.c_int
    lib.op_process.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.op_last_error.restype = ctypes.c_char_p
    lib.op_destroy.argtypes = [ctypes.c_void_p]
    lib.op_free_floats.argtypes = [ctypes.POINTER(ctypes.c_float)]
    handle = lib.op_create(json.dumps({
        "model_folder": model_folder, "net_resolution": "-1x176",
        "number_people_max": 4, "device": str(device)}).encode())
    assert handle, lib.op_last_error().decode()
    equal, t0 = 0, time.perf_counter()
    try:
        for frame, datum in zip(frames, want):
            image = np.ascontiguousarray(frame)
            kp = ctypes.POINTER(ctypes.c_float)()
            people, parts = ctypes.c_int(), ctypes.c_int()
            rc = lib.op_process(
                handle, image.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                image.shape[0], image.shape[1], ctypes.byref(kp),
                ctypes.byref(people), ctypes.byref(parts))
            assert rc == 0, lib.op_last_error().decode()
            got = np.zeros((0, 25, 3), np.float32)
            if people.value:
                got = np.ctypeslib.as_array(
                    kp, shape=(people.value, parts.value, 3)).copy()
                lib.op_free_floats(kp)
            equal += int(np.array_equal(got, datum.pose_keypoints))
    finally:
        lib.op_destroy(handle)
    out = {"build_s": build_s,
           "ms_per_frame": (time.perf_counter() - t0) * 1e3 / len(frames),
           "frames_bit_equal": equal}
    log(f"cli (e) C shim over the frames of (a): {json.dumps(out)}")
    assert equal == len(frames), out
    return out


def cli_phase(device, checkpoint, n_frames=16, image_size=(184, 328),
              default_frames=8, default_hw=(720, 1280), rig_iters=10):
    """The user entry points on the card, over the net `train_phase`
    trained (`checkpoint`), frames reaching the CLI from memory:
    (a) the CLI's `Wrapper` path on `n_frames` held-out scenes of 1-3
    people: every JSON it writes equals `Wrapper.process`'s on the same
    frame, bit for bit, and people found == placed on all but two frames;
    (b) the CLI at its own defaults (random weights, -1x368, bf16) on
    720x1280 frames; (c) `--3d` over three views with cameras written by
    `threed/camera.py`, and `reconstruct_array` on a synthetic rig of 8
    people x 25 parts x 4 cameras on the card against the CPU and the truth;
    (d) `pyopenpose.WrapperPython` at render_pose 0 and (e) `capi` (and its
    C shim where it can be built) over (a)'s frames, bit-equal to (a)."""
    import tempfile
    import numpy as np
    import torch
    from openpose_tpu_torch import accuracy, capi, pyopenpose
    from openpose_tpu_torch.io import json_io
    from openpose_tpu_torch.ops import paf_cuda
    from openpose_tpu_torch.params import PoseModel
    from openpose_tpu_torch.threed import camera, triangulation
    from openpose_tpu_torch.wrapper import PoseConfig, Wrapper

    work = pathlib.Path(tempfile.mkdtemp(prefix="cli_phase_", dir=OUT_DIR))
    scenes = accuracy.held_out_scenes(n_frames, image_size, (1, 3), seed=5)
    frames = [img for _, img in scenes]
    names = [f"scene_{i:012d}" for i in range(n_frames)]
    out = {"frames": n_frames, "image_size": list(image_size)}
    try:
        # (a) the reference: Wrapper.process with the CLI's config (no
        # image directory: no dynamic width clip); it also warms cuDNN
        reference = Wrapper(PoseConfig(
            model=PoseModel.BODY_25, net_resolution=(-1, 176),
            net_resolution_dynamic=-1.0, caffemodel=checkpoint,
            number_people_max=4), device=device)
        want = [reference.process(f, i, n)
                for i, (f, n) in enumerate(zip(frames, names))]
        expect = work / "expect"
        expect.mkdir()
        for d in want:
            json_io.save_people_json(str(expect / f"{d.name}_keypoints.json"),
                                     pose_keypoints=d.pose_keypoints)
        argv = ["--caffemodel_path", checkpoint, "--net_resolution=-1x176",
                "--number_people_max", "4", "--write_json",
                str(work / "json"), "--write_keypoint", str(work / "kp"),
                "--write_keypoint_format", "json", "--write_coco_json",
                str(work / "coco.json"), "--render_pose", "0",
                "--profile_speed", "8"]
        reset_launches()
        with frames_from_memory(frames, names):
            seconds, text = run_cli(argv, device)
        fused = paf_cuda.paf_scores_fused.launches
        written = sorted((work / "json").iterdir())
        assert [p.name for p in written] == sorted(
            p.name for p in expect.iterdir()), written
        equal = sum(p.read_bytes() == (expect / p.name).read_bytes()
                    for p in written)
        people = [len(d.pose_keypoints) for d in want]
        placed = [len(p) for p, _ in scenes]
        matched = sum(a == b for a, b in zip(people, placed))
        coco = json.loads((work / "coco.json").read_text())
        out["a"] = dict(cli_figures(text), seconds_with_load=seconds,
                        json_bit_equal=equal, people=people, placed=placed,
                        frames_people_match=matched,
                        keypoint_files=len(list((work / "kp").iterdir())),
                        coco_detections=len(coco),
                        fused_launches_per_frame=fused / n_frames)
        log(f"cli (a) Wrapper path, {n_frames} held-out frames at "
            f"{image_size}, -1x176, bf16, the trained net: "
            + json.dumps(out["a"]))
        assert equal == n_frames, out["a"]
        assert matched >= n_frames - 2, out["a"]
        assert out["a"]["keypoint_files"] == n_frames
        assert len(coco) == sum(people)

        # (d) pyopenpose at render_pose 0 over the same frames
        op = pyopenpose.WrapperPython(device=device)
        op.configure({"caffemodel_path": checkpoint,
                      "net_resolution": "-1x176", "number_people_max": 4,
                      "render_pose": 0})
        op.start()

        def datums():
            made = []
            for i, (f, n) in enumerate(zip(frames, names)):
                d = pyopenpose.Datum()
                d.id, d.name, d.cvInputData = i, n, f
                made.append(d)
            return made
        direct = datums()
        t0 = time.perf_counter()
        for d in direct:
            op.emplaceAndPop([d])
        ms = (time.perf_counter() - t0) * 1e3 / n_frames
        queued = datums()
        for d in queued:
            op.waitAndEmplace([d])
        popped = []
        while True:
            got = []
            if not op.waitAndPop(got):
                break
            popped += got
        out["d"] = {
            "ms_per_frame": ms,
            "bit_equal": sum(np.array_equal(d.poseKeypoints, w.pose_keypoints)
                             for d, w in zip(direct, want)),
            "queue_order_kept": [d.name for d in popped] == names,
            "queue_bit_equal": sum(
                np.array_equal(d.poseKeypoints, w.pose_keypoints)
                for d, w in zip(popped, want)),
            "output_is_input": all(d.cvOutputData is d.cvInputData
                                   for d in direct)}
        log(f"cli (d) pyopenpose.WrapperPython, render_pose 0: "
            + json.dumps(out["d"]))
        assert out["d"]["bit_equal"] == out["d"]["queue_bit_equal"] \
            == n_frames and out["d"]["queue_order_kept"] \
            and out["d"]["output_is_input"], out["d"]

        # (e) capi over the same frames, the trained net under a model folder
        folder = write_model_folder(checkpoint, work / "models")
        handle = capi.create(json.dumps({
            "model_folder": folder, "net_resolution": "-1x176",
            "number_people_max": 4, "device": str(device)}))
        try:
            t0 = time.perf_counter()
            answers = [capi.process(handle, f.tobytes(), *f.shape[:2], i)
                       for i, f in enumerate(frames)]
            ms = (time.perf_counter() - t0) * 1e3 / n_frames
        finally:
            capi.destroy(handle)
        equal = sum(np.array_equal(
            np.frombuffer(kp, np.float32).reshape(people_n, parts or 25, 3),
            w.pose_keypoints) for (kp, people_n, parts), w in zip(answers,
                                                                  want))
        out["e"] = {"ms_per_frame": ms, "bit_equal": equal,
                    "shim": capi_shim_check(device, folder, frames, want)}
        log(f"cli (e) capi.create / process: {json.dumps(out['e'])}")
        assert equal == n_frames, out["e"]

        # (c) --3d over three views of one rig: cameras 0.1 m apart along
        # x at the people's depth of 4 m, so view v is view 0 moved by
        # -focal * 0.1 * v / 4 px
        focal, depth, baseline = 300.0, 4.0, 0.1
        intrinsics = np.array([[focal, 0, image_size[1] / 2],
                               [0, focal, image_size[0] / 2], [0, 0, 1]])
        cam_dir = work / "cams"
        cam_dir.mkdir()
        for v in range(3):
            extrinsics = np.hstack([np.eye(3), [[-baseline * v], [0], [0]]])
            camera.write_camera_xml(
                str(cam_dir / f"cam{v}.xml"), camera.CameraParameters(
                    f"cam{v}", extrinsics, intrinsics, np.zeros(8)))
        stacked = []
        for people, _ in scenes[:4]:
            views = []
            for v in range(3):
                moved = people.copy()
                moved[..., 0] -= focal * baseline * v / depth
                views.append(synthetic_frame(moved, image_size))
            stacked.append(np.concatenate(views, axis=1))
        fused_before = paf_cuda.paf_scores_fused.launches
        with frames_from_memory(stacked, names[:4]):
            seconds, text = run_cli(
                ["--caffemodel_path", checkpoint, "--net_resolution=-1x176",
                 "--3d", "--num_views", "3", "--camera_parameter_path",
                 str(cam_dir), "--write_json", str(work / "json3d"),
                 "--render_pose", "0"], device)
        shapes, depths = [], []
        for path in sorted((work / "json3d").iterdir()):
            for person in json.loads(path.read_text())["people"]:
                kp3 = np.asarray(person["pose_keypoints_3d"]).reshape(-1, 4)
                shapes.append(kp3.shape)
                depths += kp3[kp3[:, 3] > 0, 2].tolist()
        out["c"] = dict(cli_figures(text), people_3d=len(shapes),
                        fused_launches_per_frame=(
                            paf_cuda.paf_scores_fused.launches
                            - fused_before) / 4,
                        points_kept=len(depths),
                        median_depth_m=float(np.median(depths))
                        if depths else None)
        log(f"cli (c) --3d --num_views 3 over 4 frames of 3 x {image_size}: "
            + json.dumps(out["c"]))
        assert len(list((work / "json3d").iterdir())) == 4
        assert shapes and all(s == (25, 4) for s in shapes), shapes
        assert np.isfinite(depths).all()

        # (c) reconstruct_array on ROADMAP's 3-D row: 8 people, 25 parts,
        # 4 cameras, 0.5 px noise; the card against the CPU and the truth
        rng = np.random.RandomState(61)
        cams = arc_rig(4)
        views, truth = rig_views(rng, cams, 8, 25)
        sizes = [(640, 480)] * 4
        call = lambda dev: triangulation.reconstruct_array(
            views, cams, sizes, device=dev)
        on_card, on_cpu = call(device), call("cpu")
        ok = on_card[..., 3] > 0
        rig = {
            "ok_equal": bool(np.array_equal(ok, on_cpu[..., 3] > 0)),
            "ok_share": float(ok.mean()),
            "max_abs_diff_to_cpu": float(np.abs(on_card - on_cpu).max()),
            "median_err_to_truth": float(np.median(np.linalg.norm(
                on_card[..., :3][ok] - truth[ok], axis=-1))),
            "card_ms": host_ms(lambda: call(device), rig_iters),
            "cpu_ms": host_ms(lambda: call("cpu"), rig_iters)}
        trace = device_busy(lambda: call(device), 3) \
            if device.type == "cuda" else None
        if trace is not None:
            rig["device_launches_per_call"] = \
                trace["device_launches_per_call"]
            rig["device_ms_per_call"] = trace["device_ms_per_call"]
            rig["busy_share"] = trace["busy_share"]
        out["c"]["rig"] = rig
        log("cli (c) reconstruct_array, 8 people x 25 parts x 4 cameras, "
            "0.5 px noise: " + json.dumps(rig))
        assert rig["ok_equal"] and rig["max_abs_diff_to_cpu"] <= 1e-3 \
            and rig["median_err_to_truth"] < 0.02, rig

        # (b) the CLI at its own defaults: random weights, -1x368, bf16
        rng = np.random.RandomState(71)
        big = list(scene_frames(rng, default_frames, default_hw))
        argv = ["--write_json", str(work / "json_default")]
        with frames_from_memory(big, names[:default_frames]):
            run_cli(argv + ["--max_frames", "2"], device)       # warm-up
            fused_before = paf_cuda.paf_scores_fused.launches
            seconds, text = run_cli(argv, device)
            fused_one = paf_cuda.paf_scores_fused.launches - fused_before
            trace = device_busy(lambda: run_cli(argv, device), 1) \
                if device.type == "cuda" else None
        files = list((work / "json_default").iterdir())
        out["b"] = dict(cli_figures(text), seconds_with_load=seconds,
                        fused_launches_per_frame=fused_one / default_frames,
                        people=[len(json.loads(p.read_text())["people"])
                                for p in sorted(files)])
        if trace is not None:
            out["b"]["trace_whole_call"] = trace
        log(f"cli (b) the CLI at its defaults, {default_frames} frames of "
            f"{default_hw}, random weights: " + json.dumps(out["b"]))
        assert len(files) == default_frames
        out["launches"] = read_launches("cli path",
                                        paf_cuda.paf_scores_fused)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def ba_arrays(problem, device, iterations, mesh=None):
    """`bundle_adjust` on `accuracy3d.bundle_problem`'s inputs."""
    from openpose_tpu_torch.threed.bundle_adjustment import bundle_adjust
    return bundle_adjust(problem["pts0"], problem["obs"], problem["vis"],
                         problem["kk"], problem["ext0"], iterations=iterations,
                         mesh=mesh, device=device)


def max_abs_diff(got, want):
    import numpy as np
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def threed_phase(device, n_people=8, iterations=15, card_iters=3, cpu_iters=1,
                 sweep_people=8):
    """The rest of 3-D, on ROADMAP's 3-D row (8 people x 25 parts x 4
    cameras at 1280x720, 1 px noise, cameras off by 0.5 deg and 20 mm,
    15 LM iterations: `accuracy3d`'s defaults):
    (a) `accuracy3d.bundle_eval` on the card and on the CPU from one seed,
        and `bundle_adjust` on one set of inputs on both: points and
        extrinsics equal within 1e-3 (the JAX suite's sharded-vs-single
        limit), camera rotation error under 0.2x and point RMSE under 0.7x
        of their start (`tests/test_accuracy3d.py`); ms per call, launches
        per call and per LM iteration, the card-busy share;
    (b) the sharded path: a one-rank NCCL group (a FileStore under build/,
        no network), `make_mesh(model=1)`, `bundle_adjust(mesh=...)` equal
        to `bundle_adjust()` within 1e-6 (bit-equal expected);
    (c) `accuracy3d.noise_sweep` on the card against the CPU: the same
        `valid_fraction`, `rmse_mm` within 1e-2 mm, and the JAX suite's
        gates (0.5 mm at 0 px, 10 mm at 1 px, reprojection under the
        reference gate);
    (d) the VisualSFM writers: `.sift` files of the rig's projected points
        and their `FeatureMatches.txt`, written and read back."""
    import importlib.util
    import numpy as np
    import torch
    import torch.distributed as dist
    from openpose_tpu_torch import accuracy3d
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    from openpose_tpu_torch.threed import visualsfm

    out = {}
    reset_launches()
    # (a) bundle adjustment at full size, the card against the CPU
    evals = {name: accuracy3d.bundle_eval(n_people=n_people,
                                          iterations=iterations, device=dev)
             for name, dev in (("card", device), ("cpu", "cpu"))}
    problem = accuracy3d.bundle_problem(n_people=n_people, device="cpu")
    card = ba_arrays(problem, device, iterations)
    cpu = ba_arrays(problem, "cpu", iterations)
    a = {"bundle_eval": evals, "points": int(problem["pts0"].shape[0]),
         "max_abs_diff_to_cpu": max_abs_diff(card, cpu),
         "bundle_eval_card_ms": host_ms(lambda: accuracy3d.bundle_eval(
             n_people=n_people, iterations=iterations, device=device),
             card_iters),
         "bundle_eval_cpu_ms": host_ms(lambda: accuracy3d.bundle_eval(
             n_people=n_people, iterations=iterations, device="cpu"),
             cpu_iters),
         "card_ms": host_ms(lambda: ba_arrays(problem, device, iterations),
                            card_iters),
         "cpu_ms": host_ms(lambda: ba_arrays(problem, "cpu", iterations),
                           cpu_iters)}
    a["kernel_launches_per_call"] = launches_per_call(
        "bundle adjustment", lambda: ba_arrays(problem, device, iterations))
    if device.type == "cuda":
        traces = {n: device_busy(lambda: ba_arrays(problem, device, n), 2)
                  for n in (1, iterations)}
        a["trace"] = traces[iterations]
        a["trace_one_iteration"] = traces[1]
        if all(traces.values()):
            a["device_launches_per_iteration"] = (
                traces[iterations]["device_launches_per_call"]
                - traces[1]["device_launches_per_call"]) / (iterations - 1)
    out["a"] = a
    log("threed (a) bundle adjustment, "
        f"{n_people} people x 25 parts x 4 cameras, {iterations} iterations: "
        + json.dumps(a))
    assert a["max_abs_diff_to_cpu"] <= 1e-3, a
    for r in evals.values():
        assert r["cam_rot_err_deg_out"] < 0.2 * r["cam_rot_err_deg_in"], r
        assert r["rmse_mm_after_ba"] < 0.7 * r["rmse_mm_before_ba"], r

    # (b) the sharded path on a one-rank NCCL group
    if device.type == "cuda":
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        store_path = OUT_DIR / "nccl_store"
        store_path.unlink(missing_ok=True)
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(store_path), 1), rank=0,
            world_size=1)
        try:
            mesh = mesh_lib.make_mesh(model=1)
            sharded = ba_arrays(problem, device, iterations, mesh=mesh)
            b = {"mesh": [list(mesh.shape), list(mesh.mesh_dim_names),
                          mesh.device_type],
                 "max_abs_diff_to_unsharded": max_abs_diff(sharded, card),
                 "bit_equal": all(np.array_equal(s, c)
                                  for s, c in zip(sharded, card)),
                 "sharded_ms": host_ms(lambda: ba_arrays(
                     problem, device, iterations, mesh=mesh), card_iters)}
        finally:
            dist.destroy_process_group()
            store_path.unlink(missing_ok=True)
        out["b"] = b
        log("threed (b) bundle_adjust(mesh=make_mesh(model=1)) on a "
            "one-rank NCCL group: " + json.dumps(b))
        assert b["max_abs_diff_to_unsharded"] <= 1e-6, b

    # (c) the noise sweep, the card against the CPU
    sweeps = {name: accuracy3d.noise_sweep(n_people=sweep_people, device=dev)
              for name, dev in (("card", device), ("cpu", "cpu"))}
    out["c"] = sweeps
    log("threed (c) noise_sweep, card: " + json.dumps(sweeps["card"]))
    log("threed (c) noise_sweep, cpu: " + json.dumps(sweeps["cpu"]))
    for got, want in zip(sweeps["card"], sweeps["cpu"]):
        assert got["valid_fraction"] == want["valid_fraction"], (got, want)
        assert abs(got["rmse_mm"] - want["rmse_mm"]) <= 1e-2, (got, want)
        assert got["reprojection_px"] < got["reference_gate_px"], got
        if got["pixel_noise"] == 0.0:
            assert got["rmse_mm"] < 0.5, got
        if got["pixel_noise"] == 1.0:
            assert got["rmse_mm"] < 10.0, got

    # (d) the VisualSFM writers on the rig's projected points
    kk, ext = accuracy3d.make_rig(4)
    people = accuracy3d.make_people_3d(np.random.RandomState(5), n_people)
    pix = accuracy3d.project(people.reshape(-1, 3), kk, ext)   # [P, V, 2]
    inside = ((pix > 0) & (pix < np.array([1280, 720]))).all(-1)
    folder = OUT_DIR / "visualsfm"
    folder.mkdir(parents=True, exist_ok=True)
    read_back = []
    for cam in range(pix.shape[1]):
        path = str(folder / f"{visualsfm.camera_file_stem(cam)}.sift")
        visualsfm.write_visualsfm_sift(path, pix[:, cam])
        read_back.append(bool(np.array_equal(
            visualsfm.read_visualsfm_sift(path),
            pix[:, cam].astype(np.float32))))
    matches = [np.flatnonzero(inside[:, cam]).tolist()
               for cam in range(pix.shape[1])]
    visualsfm.write_feature_matches(str(folder / "FeatureMatches.txt"),
                                    matches)
    lines = (folder / "FeatureMatches.txt").read_text().splitlines()
    pair_counts = [int(line.split()[-1]) for line in lines[::4]]
    want_counts = [int((inside[:, i] & inside[:, j]).sum())
                   for i in range(4) for j in range(i + 1, 4)]
    out["d"] = {"sift_read_back": read_back, "pair_matches": pair_counts}
    log("threed (d) VisualSFM: .sift read back equal per camera "
        f"{read_back}, matched points per camera pair {pair_counts}")
    assert all(read_back) and pair_counts == want_counts, out["d"]
    if importlib.util.find_spec("cv2") is None:
        log("threed (d) calibration modes 1, 2 and 4 need OpenCV, which "
            "this machine lacks: not run here")
    out["launches"] = read_launches("3-D path")
    return out


def synthetic_frame(people, image_size, seed=7):
    """One scene of `people` drawn by the numpy renderer, its background
    from a fixed seed (so that views of one rig differ only by the
    people's shift)."""
    import numpy as np
    from openpose_tpu_torch import synthetic
    return synthetic.render_scene_image(people, image_size,
                                        np.random.RandomState(seed))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from openpose_tpu_torch.kernels import build
    from openpose_tpu_torch.models import zoo

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(smi)   # the nvidia-smi query's own line: name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False   # heatmap path in full f32
    torch.backends.cudnn.benchmark = True

    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s from {[str(s.relative_to(ROOT)) for s in build.SOURCES]}")
    for line in build.LIBRARY.compiler_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")

    report = {"device": kind, "nvidia_smi": smi, "build_seconds": build_s}
    model = zoo.load_pose_model(seed=0, device=device)   # BODY_25
    if sys.argv[1:] == ["--capped-trace"]:
        capped_trace(device, model)
        return 0
    if sys.argv[1:] == ["--train-to-ap"]:
        train_to_ap_run(device)
        return 0
    report["kernel"] = kernel_phase(device, model.info)
    report["sampler"] = sampler_phase(device)
    report["main_path"] = main_path_phase(device, model)
    report["people_capped"] = people_capped_phase(device, model)
    report["whole_body"] = whole_body_phase(device, model)
    report["injection"] = injection_phase(device, model)
    report["wrapper"] = wrapper_phase(device)
    report["runner"] = runner_phase(device, model)
    report["accuracy"] = accuracy_phase(device, model)
    report["train"] = train_phase(device)
    try:
        report["cli"] = cli_phase(device, report["train"]["checkpoint"])
    finally:
        shutil.rmtree(pathlib.Path(report["train"]["checkpoint"]).parent,
                      ignore_errors=True)
    report["threed"] = threed_phase(device)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    kernel, sampler = report["kernel"], report["sampler"]
    source = "openpose_tpu_torch/kernels/paf_score.cu"
    # library_ms is null for both: no one PyTorch call computes either
    # function (`F.grid_sample(mode="bicubic")` uses the cubic coefficient
    # -0.75 and its own border handling; both kernels use Catmull-Rom,
    # -0.5, with taps clamped to the map)
    log(json.dumps({"kernels": [{
        "name": "paf_score_kernel", "route": "cuda", "source": source,
        "replaces": "openpose_tpu/ops/paf_pallas.py:286",
        "launches": sum(report[phase]["launches"]["paf_scores_fused"]
                        for phase in ("main_path", "whole_body", "wrapper",
                                      "runner", "accuracy", "train", "cli")),
        "max_abs_err": max(kernel["max_abs_err"], report["main_path"][
            "breakdown"]["paf_main_path_max_abs_err"], report["accuracy"][
            "kernel_on_loop_batch"]["max_abs_err"], report["train"][
            "kernel_on_trained_frame"]["max_abs_err"]),
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound"]["bound_ms"],
        "bound_by": kernel["bound"]["bound_by"], "library_ms": None}, {
        "name": "sample_bicubic_kernel", "route": "cuda", "source": source,
        "replaces": "openpose_tpu/ops/paf_pallas.py:335",
        "launches": report["people_capped"]["launches"][
            "sample_bicubic_scales"],
        "max_abs_err": max(sampler["max_abs_err"], report["people_capped"][
            "sampler_on_path"]["max_abs_err"]),
        "ms": sampler["ms"], "plain_ms": sampler["plain_ms"],
        "bound_ms": sampler["bound"]["bound_ms"],
        "bound_by": sampler["bound"]["bound_by"], "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
