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
   through batch-8 `PoseInference` (the cells of `perfbench/` time these
   paths); the PAF kernel's launch count in
   this phase must be > 0; a per-stage breakdown (with the sampled PAF
   backend timed against the fused one at K = 127) and a CPU-vs-GPU check
   of the CNN follow; then the graph phase: `PoseInference`'s CUDA graphs
   (batch 1 and 8 at 368x656 with 127 peaks, net_bypass, 2 scales of raw
   frames) bit-equal to the eager calls, their counters and launches, an
   output held across the next call, and the host's and the card's ms a
   call, eager against replayed;
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
14. mesh: the entry points over a one-rank NCCL mesh, each held to the
   call without a mesh: batch-8 `PoseInference` bit-equal with one fused
   launch a call and no collective; `WholeBodyInference` at batch 4 equal;
   `train_loop.train` at 368x368, float32, 10 steps, its losses within
   1e-6 relative; `dryrun_multichip(1)`; times of both sides;
15. threed (in the mesh phase's process group): the rest of 3-D at
   ROADMAP's 3-D row (8 people x 25 parts x 4
   cameras, 1280x720): `accuracy3d.bundle_eval` and `bundle_adjust` on
   the card against the CPU (equal within 1e-3, the JAX suite's recovery
   gates), their time, launches per LM iteration and card-busy share; the
   sharded `bundle_adjust` over a one-rank NCCL mesh equal to the
   unsharded one; `accuracy3d.noise_sweep` card against CPU; the VisualSFM
   `.sift` and match files written and read back (the calibration modes
   need OpenCV, which the card's machine lacks);
16. tools (after the cli phase, on the net the train phase trained): the
   user scripts and the tutorials of `openpose_tpu_torch/scripts/` and
   `openpose_tpu_torch/examples/`, frames and cameras in memory:
   `synthetic_eval` (AP floor 0.95, one fused launch a batch),
   `threed_eval` (the 3-D gates), tutorial 09 with the fused kernel held
   to its plain version on its call, tutorials 01-05, 07 and 08 held to
   `Wrapper.process` and to each other, `train_to_ap --steps 50` (the JAX
   script's keys), and top-down refinement on small people: the people it
   replaces and the gate that stops each other candidate.  Tutorial 06
   reads COCO images with OpenCV and is not run.
17. timing (after the threed phase): the port's measuring layer,
   `utils/benchmark.py` and the timing scripts: `scripts/speed_test` at
   its defaults (each stage's ms, one fused launch in its PAF stage, held
   to the plain version), `scripts/profile_net` at batch 8 (each cut's ms
   a frame, TFLOP/s and share of the bf16 peak; the sum of the cuts
   against the whole forward), `chain_ms` against `timed` and
   `device_busy` on the main path's batch-8 call,
   `scripts/profile_train_step` beside the train phase's figure, and
   `scripts/analyze_scaling` on a one-rank NCCL world (no collective in
   inference).

The kernel phase also holds the fused kernel to its plain version at the
refinement's shape (8 crops of 368x368, thresholds 0.02 and 0.01), runs
the flagship entry point `openpose_tpu_torch/entry.py::entry()` at its
defaults (one fused launch, held to the plain version), holds the fused
kernel to its plain version on a crowd of 32 people a frame and on noise
that fills all 127 peaks of every part (batch 8, 46x82 maps), and ends
with the epilogue phase: the convolutions' epilogue kernel bit-equal
to its plain version on every convolution output of BODY_25 and COCO_18
at 368x656 and FACE_70 and HAND_21 at 368x368, batch 1 and 8, and on edge
values; every convolution of a bf16 serving forward fused; its time beside
its byte bound and the plain sequence's; and the NMS phase: the NMS
kernels bit-equal to the plain version on BODY_25's and COCO_18's merged
maps at 368x656, batch 1 and 8 (1-4 rendered people a frame, a crowd of
32, noise that fills 127 peaks a part), on refinement's 8 crops of
368x368 and on edge values (maps of 1-5 pixels a side, NaN, infinities,
both zeros, the threshold, plateaus); each shape's time replayed in a CUDA
graph beside its byte bound and the plain version's.

`python3 chip_smoke.py --capped-trace` runs the people-capped call alone,
timed and traced (to set two trees side by side on one card).
`python3 chip_smoke.py --graphs` runs the graph phase alone (about 40 s
with the build).
`python3 chip_smoke.py --epilogue` runs the epilogue phase alone.
`python3 chip_smoke.py --nms` runs the NMS phase alone.
`python3 chip_smoke.py --mesh-scaling` runs 1, 2 and 4 ranks, one per
card, up to the cards there are: serving frames/s and train img/s of each
world against one rank.
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
counts and line lengths) over the card's float32 rate (the H100 SXM5's
datasheet rates, `utils/benchmark.py`).  The line before the
last is the kernel summary, the last line {"ok": true, "device": {...}}.  Details go to build/chip_smoke/chip_smoke.json.
The default run took 858 s on one H100 80GB HBM3 at 700 W, the build and
every phase included, with a bench phase since removed (684 s before
the graph and epilogue phases were added, the bench phase 34.9 s of it;
635.8 s before the timing phase was added; the train phase's 1500
steps 156.6 s, the mesh phase 38.3 s, the tools phase 18.3 s).  `--train-to-ap` takes 175 s; `--mesh-scaling` took 234 s
on four of them.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import pathlib
import shutil
import subprocess
import sys
import time
import types

# H100_SXM: the H100 SXM5's datasheet rates, the yardstick of the CNN's
# FLOP utilisation (bf16 on tensor cores, float32 without TF32) and of the
# kernels' bounds (float32 outside the tensor cores, and HBM3)
from openpose_tpu_torch.utils.benchmark import (
    H100_SXM, device_busy, host_ms, roofline_ms, timed)

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"
# Kernel vs plain version: the two run the same IEEE-rounded float32
# operations in the same order (the kernel is built with -fmad=false), so
# they are expected to agree bit for bit; 1e-5 leaves room for a last-bit
# difference in a math routine that does not cross a threshold.
KERNEL_TOL = 1e-5
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
    from openpose_tpu_torch.parallel import graphs
    for wrapper in graphs.COUNTED:
        wrapper.launches = 0


def read_launches(path, *must_launch):
    """Every wrapper's launch count since `reset_launches`; each wrapper in
    must_launch must have launched on this path."""
    from openpose_tpu_torch.parallel import graphs
    counts = {w.__name__: w.launches for w in graphs.COUNTED}
    log(f"{path} kernel launches: {counts}")
    for wrapper in must_launch:
        assert counts[wrapper.__name__] > 0, \
            f"the {path} did not launch {wrapper.__name__}"
    return counts


def launches_per_call(path, call):
    """Every wrapper's launch count over one call of a path."""
    from openpose_tpu_torch.parallel import graphs
    before = [w.launches for w in graphs.COUNTED]
    call()
    counts = {w.__name__: w.launches - n
              for w, n in zip(graphs.COUNTED, before)}
    log(f"{path}: kernel launches per call {counts}")
    return counts


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
    ms, by = roofline_ms(n_bytes, n_ops, H100_SXM)
    return {"bound_ms": ms, "bound_by": by, "lines": lines,
            "samples": samples, "bytes": n_bytes, "operations": n_ops}


def fused_against_plain(args, device, iters=20):
    """The fused kernel against its plain version on one call's arguments
    (`paf_cuda.paf_scores_fused`'s): the largest difference, the scores
    that differ, the accepted lines, both times and the bound."""
    import torch
    from openpose_tpu_torch.ops import paf, paf_cuda
    sources, peaks, pairs, map_idx = args[0], args[3], args[4], args[5]
    with torch.inference_mode():
        got = paf_cuda.paf_scores_fused(*args)
        want = paf.paf_scores_multiscale_reference(*args)
        out = {
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
    return out


def sampler_bound(lows, my):
    """The sampler's bound: coordinates in, values out (16 + 8 bytes per
    sample) and the planes once, against its operations."""
    samples = my.numel()
    n_bytes = 24 * samples + 4 * sum(t.numel() for t in lows)
    n_ops = samples * OPS_PER_SAMPLE_SCALE * len(lows)
    ms, by = roofline_ms(n_bytes, n_ops, H100_SXM)
    return {"bound_ms": ms, "bound_by": by, "samples": samples,
            "bytes": n_bytes, "operations": n_ops}


def kernel_phase(device, info, full_shape=(8, 46, 82, 127),
                 entry_hw=(368, 656)):
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
    at_entry = entry_check(device, entry_hw)
    on_post = post_input_cases(device, info, (hs * 8, ws * 8), n)
    max_err = max(max_err, at_entry["kernel"]["max_abs_err"],
                  at_entry["fn_max_abs_err"],
                  *(c["max_abs_err"] for c in on_post.values()))
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound": full_bound, "full_shape_mismatches": mismatches,
            "four_scales_ms": ms4, "four_scales_plain_ms": plain_ms4,
            "four_scales_bound": bound4, "refinement": refinement,
            "entry": at_entry, "post_inputs": on_post,
            "epilogue": epilogue_phase(device), "nms": nms_phase(device)}


def entry_check(device, net_hw):
    """`entry.py::entry()` (its defaults: 368x656, bf16): `fn(*example_args)`
    after one warm call gives [1, 25, 128, 3] peaks and [1, 26, 127, 127]
    scores with one fused launch, the peaks bit-equal to the stages run by
    hand and the scores to the plain version on the same tensors."""
    import torch
    from openpose_tpu_torch import entry
    from openpose_tpu_torch.ops import nms, paf, resize
    from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
    fn, (net, image) = entry.entry(device=device, net_hw=net_hw)
    fn(net, image)              # warm: cuDNN's algorithm search
    result = []
    out = {"launches_per_call": launches_per_call(
        "entry() fn", lambda: result.append(fn(net, image)))}
    peaks, scores = result[0]
    out["shapes"] = [list(peaks.shape), list(scores.shape)]
    assert out["shapes"] == [[1, 25, 128, 3], [1, 26, 127, 127]], out
    assert bool(torch.isfinite(peaks).all() & torch.isfinite(scores).all())
    if device.type == "cuda":
        assert out["launches_per_call"] == {
            "paf_scores_fused": 1, "sample_bicubic_scales": 0,
            "bias_act": len(net.epilogues), "nms": 1}, out
    pairs, map_idx = (torch.from_numpy(t).to(device) for t in
                      paf.pair_tables(POSE_MODEL_INFO[PoseModel.BODY_25]))
    with torch.inference_mode():
        src = net(resize.normalize_vgg(image), torch.bfloat16)
        by_hand = nms.nms(resize.resize_bicubic(src[..., :25], net_hw),
                          0.05, 127)
        args = ([src], [1.0], net_hw, peaks, pairs, map_idx, 0.05, 0.95,
                0.05)
        out["fn_max_abs_err"] = float(
            (scores - paf.paf_scores_multiscale_reference(*args)).abs()
            .max())
    assert torch.equal(by_hand, peaks), "entry() fn's stages differ"
    # after the counts are read: these launches only compare
    out["kernel"] = fused_against_plain(args, device)
    log("entry(): " + json.dumps(out))
    assert out["kernel"]["mismatches"] == 0 \
        and out["fn_max_abs_err"] <= KERNEL_TOL, out
    return out


def post_input_cases(device, info, net_hw, batch):
    """The fused kernel against its plain version past the rendered
    8-person scenes the cells feed: a crowd of 32 `random_people` a frame,
    and uniform noise in [-1, 1), whose every part fills the 127-peak
    budget at 368x656; each merged and NMS'd at 0.05 as the decode does."""
    import numpy as np
    import torch
    from openpose_tpu_torch import synthetic, train
    from openpose_tpu_torch.ops import nms, paf, resize
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf.pair_tables(info))
    crowd = np.stack([synthetic.random_people(
        np.random.RandomState(100 + b), 32, net_hw,
        min_spacing=30.0)[:, :info.num_parts] for b in range(batch)])
    noise = np.random.RandomState(3).uniform(
        -1, 1, (batch, net_hw[0] // 8, net_hw[1] // 8,
                info.heatmap_channels)).astype(np.float32)
    sources = {
        "crowd_32": train.make_targets(
            torch.from_numpy(crowd).to(device), pairs, map_idx, net_hw,
            info.num_parts, info.heatmap_channels),
        "noise": torch.from_numpy(noise).to(device)}
    out = {}
    for name, src in sources.items():
        with torch.inference_mode():
            peaks = nms.nms(resize.resize_bicubic(src[..., :info.num_parts],
                                                  net_hw), 0.05, 127)
        args = ([src], [1.0], net_hw, peaks, pairs, map_idx, 0.05, 0.95,
                0.05)
        out[name] = k = fused_against_plain(args, device, iters=5)
        log(f"fused kernel on the {name} input {list(src.shape)}: "
            f"tol={KERNEL_TOL} " + json.dumps(k))
        assert k["mismatches"] == 0 and k["max_abs_err"] <= KERNEL_TOL, k
    if tuple(net_hw) == (368, 656):
        assert out["noise"]["peaks_per_part_mean"] == 127.0, out["noise"]
    return out


def _bits(t):
    """A bfloat16 tensor's bits, in logical order (NaNs compare too)."""
    import torch
    return t.contiguous().view(torch.int16)


def _edge_epilogue_inputs(rng, device, channels):
    """A [2, C, 5, 7] bfloat16 conv output in channels-last memory, its
    float32 bias and slope, with negatives, zeros of both signs, the
    largest finite values, infinities, NaN and tiny values among them."""
    import numpy as np
    import torch
    special = np.array([0.0, -0.0, 1e-40, -1e-40, 3.3e38, -3.3e38, np.inf,
                        -np.inf, np.nan, 1e30, -1e30, 1.0, -1.0],
                       np.float32)
    x = rng.standard_normal(2 * channels * 35).astype(np.float32) * 3
    x[:special.size] = special
    bias = rng.standard_normal(channels).astype(np.float32)
    bias[:3] = (-0.0, 0.0, 1e38)
    slope = rng.uniform(-0.5, 1.5, channels).astype(np.float32)
    return (torch.from_numpy(x.reshape(2, channels, 5, 7)).to(
        device, torch.bfloat16).contiguous(memory_format=torch.channels_last),
        torch.from_numpy(bias).to(device), torch.from_numpy(slope).to(device))


def _epilogue_net(name, device, seed, trainable=False):
    """A bundled net with seeded weights and random biases and slopes, so
    that every bias and slope carries signal."""
    import torch
    from openpose_tpu_torch.models import graph
    spec = graph.load_spec(name)
    gen = torch.Generator().manual_seed(seed)
    params = graph.init_params(spec, gen)
    for sub in params.values():
        for key in ("b", "slope"):
            if key in sub:
                sub[key] = torch.rand(sub[key].shape, generator=gen) - 0.3
    return graph.PoseNet(spec, params, trainable=trainable).to(device)


def _graph_ms(fn, iters, device):
    """Mean device ms of fn over iters calls captured in one CUDA graph and
    replayed (`timed` over the replays)."""
    import torch
    fn()                                  # builds and loads the library
    torch.cuda.synchronize(device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    return timed(g.replay, 2, 5, device) / iters


def _max_abs_err(got, want):
    """The largest |got - want| over the values whose bits differ (0.0
    where none do; inf where a NaN or an infinity differs)."""
    import torch
    diff = _bits(got) != _bits(want)
    if not bool(diff.any()):
        return 0.0
    err = (got.float() - want.float()).abs()[diff]
    return float(err.nan_to_num(nan=float("inf")).max())


# The convolutions' epilogue kernel is held to its plain version on every
# convolution output of these nets at these sizes, batch 1 and 8, and timed
# at the main path's shapes: conv1_2 (the trunk's largest) and a BODY_25
# CPM stage's 96-channel PReLU convolution, batch 8 and 1.
EPILOGUE_NETS = (("body_25", (368, 656)), ("coco_18", (368, 656)),
                 ("face_70", (368, 368)), ("hand_21", (368, 368)))
EPILOGUE_TIMED = (("conv1_2", "relu", (8, 64, 368, 656)),
                  ("Mconv1_stage0_L2_0", "prelu", (8, 96, 46, 82)),
                  ("conv1_2", "relu", (1, 64, 368, 656)),
                  ("Mconv1_stage0_L2_0", "prelu", (1, 96, 46, 82)))
EPILOGUE_CHANNELS = (19, 20, 22, 26, 28, 38, 52, 71, 96, 128, 512)
# a timed row cycles through copies of its tensor that together hold this
# many times the card's L2, so that each call reads and writes device
# memory, as its byte bound assumes
EPILOGUE_COLD_L2S = 4


def epilogue_phase(device, nets=EPILOGUE_NETS, batches=(1, 8),
                   timed_shapes=EPILOGUE_TIMED, serve_shape=(8, 368, 656),
                   train_shape=(2, 368, 368), iters=50):
    """The convolutions' epilogue kernel (`ops/conv_epilogue.py`,
    `kernels/conv_epilogue.cu`) against its plain version on the card,
    bit for bit: (a) on every convolution output of each net's bf16
    forward (the plain version first, then the kernel over the same
    output); (b) on edge values (both zeros, the largest values,
    infinities, NaN) for each activation at the output convolutions' and
    the stages' channel counts; (c) a serving forward of BODY_25 and
    COCO_18 at serve_shape (N, H, W): every convolution counts
    `cnn.epilogue.fused`, one launch each, and the net's output equals the
    forward with the plain epilogue; (d) the kernel's time beside its byte
    bound, the plain sequence's time and device operations, at the timed
    shapes, launched from the host and replayed in a CUDA graph, each call
    on a copy of the tensor that is no longer in the L2; (e) a trainer's
    BODY_25 in bf16 at train_shape under autograd: the kernel's forward
    and every gradient against the plain epilogue's (cuDNN set
    deterministic for both), one launch a convolution."""
    import numpy as np
    import torch
    from openpose_tpu_torch.models import graph
    from openpose_tpu_torch.ops import conv_epilogue
    from openpose_tpu_torch.utils.profiler import TRACE

    kernel = conv_epilogue.bias_act
    checked = {}             # (net, N, C, H, W, activation): mismatches
    errs = [0.0]

    def held(x, bias, kind, slope=None):
        want = conv_epilogue.plain(x, bias, kind, slope)
        got = kernel(x, bias, kind, slope)
        assert got.data_ptr() == x.data_ptr(), "the kernel wrote elsewhere"
        key = (net_name, *x.shape, kind)
        checked[key] = checked.get(key, 0) + int(
            (_bits(got) != _bits(want)).sum())
        errs.append(_max_abs_err(got, want))
        return got

    rng = np.random.RandomState(11)
    out = {}
    with torch.inference_mode():
        # the nets call `held` in the wrapper's place; the wrapper itself
        # and its launch count stay as they are
        graph.conv_epilogue = types.SimpleNamespace(
            **{**vars(conv_epilogue), "bias_act": held})
        try:
            for (net_name, hw), batch in itertools.product(nets, batches):
                net = _epilogue_net(net_name, device, seed=3)
                image = torch.from_numpy(rng.uniform(
                    -0.5, 0.5, (batch, *hw, 3)).astype(np.float32)).to(device)
                net(image, torch.bfloat16)
                del net
        finally:
            graph.conv_epilogue = conv_epilogue
        bad = {k: v for k, v in checked.items() if v}
        log(f"epilogue (a): {len(checked)} convolution output shapes of "
            f"{[n for n, _ in nets]} at batch {list(batches)}, "
            f"mismatched values {bad or 0}, max |diff| {max(errs)}")
        out["path_shapes"] = len(checked)
        out["path_mismatches"] = sum(bad.values())
        out["path_max_abs_err"] = max(errs)

        edge_bad = {}
        for kind, c in itertools.product(conv_epilogue.KINDS,
                                         EPILOGUE_CHANNELS):
            x, bias, slope = _edge_epilogue_inputs(rng, device, c)
            want = conv_epilogue.plain(x, bias, kind, slope)
            got = kernel(x.clone(memory_format=torch.channels_last), bias,
                         kind, slope)
            diff = _bits(got) != _bits(want)
            if bool(diff.any()):
                i = diff.nonzero()[:4].tolist()
                edge_bad[f"{kind} C={c}"] = [
                    (float(x[tuple(j)]), float(bias[j[1]]),
                     int(_bits(got)[tuple(j)]), int(_bits(want)[tuple(j)]))
                    for j in i]
        log(f"epilogue (b): edge values, {len(conv_epilogue.KINDS)} "
            f"activations x channels {list(EPILOGUE_CHANNELS)}: "
            f"mismatches (x, bias, kernel bits, plain bits) {edge_bad or 0}")
        out["edge_mismatches"] = edge_bad

        engaged = {}
        for net_name in ("body_25", "coco_18"):
            net = _epilogue_net(net_name, device, seed=4)
            image = torch.from_numpy(rng.uniform(
                -0.5, 0.5, (*serve_shape, 3)).astype(np.float32)).to(device)
            before = kernel.launches
            TRACE.drain()
            TRACE.enable()
            try:
                fused = net(image, torch.bfloat16)
                counters = TRACE.drain()["counters"]
            finally:
                TRACE.disable()
            launches = kernel.launches - before
            fuses = conv_epilogue.fuses
            conv_epilogue.fuses = lambda x: False
            try:
                plain = net(image, torch.bfloat16)
            finally:
                conv_epilogue.fuses = fuses
            n_convs = len(net.epilogues)
            engaged[net_name] = {
                "counters": counters, "launches": launches,
                "convolutions": n_convs,
                "output_equal": bool(torch.equal(fused, plain))}
            del net
        log(f"epilogue (c): bf16 serving forwards at {serve_shape}: "
            f"{engaged}")
        out["engaged"] = engaged

        rows = []
        l2_bytes = torch.cuda.get_device_properties(device).L2_cache_size
        for name, kind, shape in timed_shapes:
            n = int(np.prod(shape))
            copies = -(-EPILOGUE_COLD_L2S * l2_bytes // (2 * n))
            xs = [torch.randn(shape, device=device).to(torch.bfloat16)
                  .contiguous(memory_format=torch.channels_last)
                  for _ in range(copies)]
            bias = torch.rand(shape[1], device=device) - 0.3
            slope = torch.rand(shape[1], device=device)
            calls = itertools.count()

            def on_kernel():
                return kernel(xs[next(calls) % copies], bias, kind, slope)

            def on_plain():
                return conv_epilogue.plain(xs[next(calls) % copies], bias,
                                           kind, slope)
            # every copy once in each timed loop and each captured graph
            reps = max(iters, copies)
            bound_ms, bound_by = roofline_ms(4 * n, 3 * n, H100_SXM)
            ms = timed(on_kernel, 5, reps, device)
            kernel_ops = device_busy(on_kernel, 10)
            plain_ops = device_busy(on_plain, 10)
            assert kernel_ops and kernel_ops["device_launches_per_call"] > 0, \
                f"the profiler saw no kernel of {name}'s epilogue"
            rows.append({
                "layer": name, "activation": kind, "shape": list(shape),
                "copies": copies, "ms": ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                "tb_per_s": 4 * n / ms / 1e9,
                "plain_ms": timed(on_plain, 3, reps, device),
                # as the main path runs them, replayed in a CUDA graph: the
                # device's pace without the host's launches in between
                "graph_ms": _graph_ms(on_kernel, reps, device),
                "plain_graph_ms": _graph_ms(on_plain, reps, device),
                "kernel_device_ops": kernel_ops["device_launches_per_call"],
                "plain_device_ops": plain_ops["device_launches_per_call"]})
            rows[-1]["graph_share_of_bound"] = bound_ms / rows[-1]["graph_ms"]
            log(f"epilogue (d): {json.dumps(rows[-1])}")
            del xs
        out["timed"] = rows

    trained = _epilogue_training(device, train_shape, rng)
    out["train"] = trained
    log(f"epilogue (e): a trainer's BODY_25 at {train_shape}, bf16, "
        f"forward and backward: {json.dumps(trained)}")
    assert not bad, f"the epilogue kernel differs on the path: {bad}"
    assert not edge_bad, f"the epilogue kernel differs on edges: {edge_bad}"
    for net_name, e in engaged.items():
        assert e["counters"] == {"cnn.epilogue.fused": e["convolutions"]}, e
        assert e["launches"] == e["convolutions"], e
        assert e["output_equal"], f"{net_name}: fused output differs"
    n_convs = trained["convolutions"]
    assert trained["mismatched"] == [], trained
    assert trained["launches"] == n_convs, trained
    assert trained["counters"] == {
        "plain": {graph.EPILOGUE_PLAIN: n_convs},
        "kernel": {graph.EPILOGUE_FUSED: n_convs}}, trained
    return out


def _epilogue_training(device, shape, rng):
    """A trainable BODY_25 in bf16 at shape (N, H, W), forward and the
    backward of a sum of squares, once with the plain epilogue and once
    with the kernel (`_BiasAct`), on the same weights and image: the
    output and each gradient that differ, the largest difference, the
    counters and the kernel's launches of each run."""
    import numpy as np
    import torch
    from openpose_tpu_torch.ops import conv_epilogue
    from openpose_tpu_torch.utils.profiler import TRACE

    kernel = conv_epilogue.bias_act
    image = torch.from_numpy(rng.uniform(
        -0.5, 0.5, (*shape, 3)).astype(np.float32)).to(device)
    runs = {}
    fuses = conv_epilogue.fuses
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        for name in ("plain", "kernel"):
            net = _epilogue_net("body_25", device, seed=6, trainable=True)
            if name == "plain":
                conv_epilogue.fuses = lambda x: False
            before = kernel.launches
            TRACE.drain()
            TRACE.enable()
            try:
                y = net(image, torch.bfloat16)
                (y.float() ** 2).sum().backward()
                counters = TRACE.drain()["counters"]
            finally:
                TRACE.disable()
                conv_epilogue.fuses = fuses
            runs[name] = {"output": y.detach(), "counters": counters,
                          "launches": kernel.launches - before,
                          "grads": {k: p.grad for k, p in
                                    net.weights.items()}}
            n_convs = len(net.epilogues)
            del net
    got, want = runs["kernel"], runs["plain"]
    pairs = [("output", got["output"], want["output"])] + [
        (k, got["grads"][k], want["grads"][k]) for k in want["grads"]]
    return {"convolutions": n_convs, "tensors": len(pairs),
            "mismatched": [k for k, a, b in pairs if not torch.equal(a, b)],
            "max_abs_err": max(float((a - b).abs().max())
                               for _, a, b in pairs),
            "counters": {"plain": want["counters"],
                         "kernel": got["counters"]},
            "launches": got["launches"], "plain_launches": want["launches"]}


# NMS (`ops/nms.py`, `kernels/nms.cu`) is held to its plain version and
# timed on the merged part maps of BODY_25 (25 parts) and COCO_18 (18) at
# 368x656, batch 1 and 8, for each input, and on top-down refinement's
# crops (`pose/refine.py`: up to 8 people at 368x368, threshold 0.02, no
# offset); then on edge values at small shapes.
NMS_MODELS = ("BODY_25", "COCO_18")
NMS_SCENES = ("people_1_4", "crowd_32", "noise")
NMS_CROP = ("BODY_25", "crop_1", 8, (368, 368), 0.02, (0.0, 0.0))
# COCO_18's parts as BODY_25's (perfbench's `keypoints_from_body25`)
COCO18_FROM_BODY25 = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16,
                      17, 18)
# a timed shape cycles through copies of its maps that together hold this
# many times the card's L2, so that each call reads device memory, as its
# byte bound assumes
NMS_COLD_L2S = 4


def _nms_maps(device, model, scene, batch, net_hw, rng):
    """[batch, H, W, parts] float32 merged maps on the device, resized from
    net outputs at 1/8 of net_hw as the decode merges them: rendered people
    (1-4 a frame, a crowd of 32, or one tall person a crop) or uniform
    noise in [-1, 1)."""
    import numpy as np
    import torch
    from openpose_tpu_torch import synthetic
    from openpose_tpu_torch.ops import paf, resize
    from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
    info = POSE_MODEL_INFO[PoseModel[model]]
    low = (net_hw[0] // 8, net_hw[1] // 8)
    if scene == "noise":
        src = rng.uniform(-1, 1, (batch, *low, info.num_parts))
    else:
        most = {"people_1_4": 4, "crowd_32": 32, "crop_1": 1}[scene]
        people = np.zeros((batch, most, 25, 3), np.float32)
        for b in range(batch):
            count = rng.randint(1, 5) if scene == "people_1_4" else most
            people[b, :count] = synthetic.random_people(
                rng, count, net_hw, min_spacing=30.0 if most == 32 else 90.0,
                height_range=(250.0, 330.0) if scene == "crop_1"
                else (180.0, 300.0))
        if model == "COCO_18":
            people = people[:, :, list(COCO18_FROM_BODY25)]
        pairs, map_idx = paf.pair_tables(info)
        src = synthetic.make_targets(people, pairs, map_idx, net_hw,
                                     info.num_parts, info.heatmap_channels)
        src = src[..., :info.num_parts]
    src = torch.from_numpy(np.asarray(src, np.float32)).to(device)
    with torch.inference_mode():
        return resize.resize_bicubic(src, net_hw)


def _same_bits(got, want):
    """Whether two float32 tensors hold the same bits, any NaN matching any
    NaN (a NaN's payload is the hardware's)."""
    import torch
    return got.shape == want.shape and bool(
        ((got.view(torch.int32) == want.view(torch.int32))
         | (got.isnan() & want.isnan())).all())


def _nms_edge_cases(rng):
    """(name, [N, H, W, C] float32 maps, threshold, max_peaks, offset):
    maps of 1-5 pixels a side, the (y=0, x=1) candidate, plateaus on each
    ring and inside, the cap, and NaN, infinities, both zeros, the
    threshold itself and huge values scattered over noise."""
    import numpy as np
    cases = []
    for h, w in itertools.product(range(1, 6), repeat=2):
        cases.append((f"tiny {h}x{w}", rng.uniform(
            -0.2, 1.0, (2, h, w, 3)).astype(np.float32), 0.05, 4,
            (0.5, 0.5)))
    corner = np.zeros((1, 12, 12, 2), np.float32)
    corner[0, 0, 1, 0] = 0.5
    corner[0, 1, 0, 1] = 0.5
    cases.append(("y=0 x=1 candidate", corner, 0.05, 10, (0.5, 0.5)))
    flat = np.zeros((1, 16, 16, 2), np.float32)
    flat[0, 5:8, 5:8] = 0.7
    flat[0, 1, 1:4] = 0.4
    flat[0, 0, :, 1] = 0.6
    flat[0, 14, 3:5, 0] = 0.3
    cases.append(("plateaus", flat, 0.05, 8, (0.5, 0.5)))
    grid = np.zeros((1, 30, 30, 1), np.float32)
    grid[0, 2:28:3, 2:28:3] = 1.0
    cases.append(("cap keeps row-major order", grid, 0.05, 5, (0.5, 0.5)))
    # rows of more than 32 mask words, the last one partial; more channels
    # than one block of the first pass takes
    cases.append(("wide rows", rng.uniform(-1, 1, (2, 6, 1100, 3)).astype(
        np.float32), 0.05, 127, (0.5, 0.5)))
    cases.append(("70 channels", rng.uniform(-1, 1, (2, 11, 70, 70)).astype(
        np.float32), 0.05, 30, (0.5, 0.5)))
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.05, 1e30,
                        -1e30, 3.4e38], np.float32)
    for thr, k, offset in ((0.05, 127, (0.5, 0.5)), (0.0, 7, (0.0, 0.0)),
                           (0.05, 0, (0.5, 0.5))):
        e = rng.uniform(-1, 1, (2, 20, 24, 5)).astype(np.float32)
        at = rng.randint(0, e.size, 80)
        e.flat[at] = special[rng.randint(0, special.size, at.size)]
        e[1, 3:6, 3:6, 2] = np.float32(thr)         # a plateau at the threshold
        cases.append((f"edge values thr={thr} K={k}", e, thr, k, offset))
    return cases


def nms_phase(device, models=NMS_MODELS, scenes=NMS_SCENES, batches=(1, 8),
              net_hw=(368, 656), crop=NMS_CROP, iters=20, max_peaks=127):
    """The NMS kernels (`ops/nms.py::nms`, `kernels/nms.cu`) against the
    plain version (`nms.plain`) on the card, bit for bit: (a) each model's
    merged maps at net_hw, each batch, each scene, and refinement's crops,
    each timed replayed in a CUDA graph beside the plain version, on copies
    no longer in the L2, with its share of the byte bound (the maps read
    once, the peaks written once) and each version's device operations a
    call; (b) the edge cases of `_nms_edge_cases`; (c) a call counts
    `nms.fused` once in the tracer and launches once."""
    import numpy as np
    import torch
    from openpose_tpu_torch.ops import nms
    from openpose_tpu_torch.utils.profiler import TRACE

    rng = np.random.RandomState(22)
    l2_bytes = torch.cuda.get_device_properties(device).L2_cache_size \
        if device.type == "cuda" else 1 << 20
    shapes = [(m, s, b, net_hw, 0.05, (0.5, 0.5)) for m, b, s in
              itertools.product(models, batches, scenes)]
    if crop is not None:
        shapes.append(crop)
    rows = []
    for model, scene, batch, hw, thr, offset in shapes:
        maps = _nms_maps(device, model, scene, batch, hw, rng)
        with torch.inference_mode():
            want = nms.plain(maps, thr, max_peaks, offset)
            got = nms.nms(maps, thr, max_peaks, offset)
        n_bytes = maps.numel() * 4 + want.numel() * 4
        copies = -(-NMS_COLD_L2S * l2_bytes // (maps.numel() * 4))
        xs = [maps.clone() for _ in range(copies)]
        calls = itertools.count()

        def on_kernel():
            return nms.nms(xs[next(calls) % copies], thr, max_peaks, offset)

        def on_plain():
            return nms.plain(xs[next(calls) % copies], thr, max_peaks,
                             offset)
        reps = max(iters, copies)
        bound_ms, bound_by = roofline_ms(n_bytes, 0, H100_SXM)
        with torch.inference_mode():
            row = {"model": model, "scene": scene, "shape": list(maps.shape),
                   "threshold": thr, "offset": list(offset),
                   "peaks_per_part_mean": float(want[:, :, 0, 0].mean()),
                   "bit_equal": _same_bits(got, want), "copies": copies,
                   "graph_ms": _graph_ms(on_kernel, reps, device),
                   "plain_graph_ms": _graph_ms(on_plain, reps, device),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            kernel_ops = device_busy(on_kernel, 3)
            plain_ops = device_busy(on_plain, 3)
        row["share_of_bound"] = bound_ms / row["graph_ms"]
        row["kernel_device_ops"] = (kernel_ops or {}).get(
            "device_launches_per_call")
        row["kernel_top"] = (kernel_ops or {}).get("top_kernels_ms_per_call")
        row["plain_device_ops"] = (plain_ops or {}).get(
            "device_launches_per_call")
        log(f"nms (a): {json.dumps(row)}")
        rows.append(row)
        del xs, maps

    edges = {}
    for name, heat, thr, k, offset in _nms_edge_cases(rng):
        maps = torch.from_numpy(heat).to(device)
        with torch.inference_mode():
            edges[name] = _same_bits(nms.nms(maps, thr, k, offset),
                                     nms.plain(maps, thr, k, offset))
    # maps that start 4 bytes past a 16-byte boundary (a view)
    heat = torch.from_numpy(rng.uniform(-1, 1, 1 + 2 * 9 * 13 * 5).astype(
        np.float32)).to(device)[1:].view(2, 9, 13, 5)
    with torch.inference_mode():
        edges["unaligned view"] = _same_bits(nms.nms(heat, 0.05, 20),
                                             nms.plain(heat, 0.05, 20))
    log(f"nms (b): edge cases bit-equal {edges}")

    maps = _nms_maps(device, models[0], scenes[0], 1, net_hw, rng)
    before = nms.nms.launches
    TRACE.drain()
    TRACE.enable()
    try:
        with torch.inference_mode():
            nms.nms(maps, 0.05, max_peaks)
        counters = TRACE.drain()["counters"]
    finally:
        TRACE.disable()
    engaged = {"counters": counters, "launches": nms.nms.launches - before}
    log(f"nms (c): one call {engaged}")

    unequal = [r for r in rows if not r["bit_equal"]]
    assert not unequal, f"the NMS kernels differ from the plain version: " \
        f"{unequal}"
    assert all(edges.values()), f"the NMS kernels differ on edges: {edges}"
    assert engaged == {"counters": {nms.FUSED: 1}, "launches": 1}, engaged
    for r in rows:
        if r["scene"] == "noise" and r["shape"][1:3] == [368, 656]:
            assert r["peaks_per_part_mean"] == max_peaks, r
    return {"timed": rows, "edges": edges, "engaged": engaged}


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
    """PoseExtractor (f32 and bf16) and batched PoseInference on BODY_25;
    the cells of `perfbench/` time the serving paths."""
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
        pk, sc = inference.fetch(*inference(images))
        people = [len(inference.assemble(pk[b], sc[b])[0])
                  for b in range(batch)]
        res[f"inference_{name}"] = {"batch": batch,
                                    "people_per_frame": people}
        log(f"inference {name} batch {batch} at {net_h}x{net_w}: "
            f"people per frame={people}")

    from openpose_tpu_torch.ops import conv_epilogue
    res["launches"] = read_launches("main path", paf_cuda.paf_scores_fused,
                                    conv_epilogue.bias_act)
    res["breakdown"] = stage_breakdown(model, batch_frames, device, iters)
    res["cnn_cpu_vs_gpu"] = cnn_cpu_check(model, device)
    return res


def graph_phase(device, model, net_hw=(368, 656), batches=(1, 8),
                iters=20):
    """`PoseInference`'s CUDA graphs (`parallel/graphs.py`) at the
    benchmark cells' shapes (batch 1 and 8, 368x656, 127 peaks), for
    BODY_25 and COCO_18: every replayed call bit-equal to the eager bodies
    on the CNN outputs, peaks and scores; the counters (one eager call and
    one capture a body, then replays; every convolution's epilogue kernel
    counted in the eager call and the capture); the CNN's graphs, a trunk and a
    stages graph a scale, replayed inside their spans `pose.net.trunk` and
    `pose.net.stages` in `pose.net`; one fused launch a call, replayed or
    not; an output held across the next call unchanged; the host's ms a
    call (the dispatch, no sync) and the card's (CUDA events), eager
    against replay; the NMS kernels counted and launched once a decode
    call, as the fused scorer.  Then the same equality with net_bypass (rendered
    people), at 2 scales of raw 720x1280 frames and, with a second card,
    on cuda:1 while another card is the current device."""
    import numpy as np
    import torch
    from openpose_tpu_torch import synthetic
    from openpose_tpu_torch.models import graph, zoo
    from openpose_tpu_torch.ops import nms, paf
    from openpose_tpu_torch.parallel import graphs
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.params import PoseModel
    from openpose_tpu_torch.utils.profiler import TRACE

    rng = np.random.RandomState(3)
    out = {}

    def check(name, inference, inputs, other, before=lambda: None):
        """Three calls (eager, capture, replay) on `inputs` and a replay on
        `other`, frames the capture never saw, each against the eager
        bodies on its frames; returns the largest |diff| of any output
        (CNN sources, peaks, scores).  `before` runs before each call."""
        @torch.inference_mode()
        def eager(x=inputs):
            src = inference._net([x], graphs.eager_stage) \
                if not inference.net_bypass else [x]
            return (*src, *inference._decode(src, graphs.eager_stage))

        def call(x=inputs):
            before()
            src = inference.net_outputs(x)
            return (*src, *inference.decode(src))
        want, want_other = eager(), eager(other)
        assert not torch.equal(want[0], want_other[0]), \
            f"{name}: the two inputs give one CNN output"
        TRACE.enable()
        try:
            got = [(call(), want) for _ in range(3)]
            got.append((call(other), want_other))
            drained = TRACE.drain()
        finally:
            TRACE.disable()
        counters, spans = drained["counters"], drained["spans"]
        n_bodies = 1 if inference.net_bypass else 2
        # the decode's NMS kernels, counted in the eager call and the
        # capture, as the epilogue below
        want_counters = {"pose.graph.eager": n_bodies,
                         "pose.graph.captures": n_bodies,
                         "pose.graph.replays": 3 * n_bodies, nms.FUSED: 2}
        n_scales = len(inference.plan.scale_input_to_net)
        if not inference.net_bypass:
            # every convolution's epilogue kernel, once a scale in the
            # eager call and once in the capture; the replays count none
            want_counters[graph.EPILOGUE_FUSED] = \
                2 * n_scales * len(inference.net.epilogues)
        assert counters == want_counters, counters
        if not inference.net_bypass:
            # the eager call's and three replays' trunk and stages, once a
            # scale, each a graph of its own in the replays (a collector's
            # pause may open inside them too)
            parts = [s[0] for s in spans if s[3] is not None
                     and spans[s[3]][0] == "pose.net"
                     and not s[0].startswith("gc.")]
            assert parts == [graph.TRUNK, graph.STAGES] * n_scales * 4, \
                parts
            cnn_graphs = [[stage for stage, _ in g.stages]
                          for key, g in inference._graphs._entries.items()
                          if key[0] == "_net"]
            assert cnn_graphs == [[graph.TRUNK, graph.STAGES] * n_scales], \
                cnn_graphs
        diff = max(float((g - w).abs().max()) for outs, wanted in got
                   for g, w in zip(outs, wanted, strict=True))
        held = call()
        kept = [t.clone() for t in held]
        call(other)
        _sync(inference.device)
        assert all(torch.equal(h, k) for h, k in zip(held, kept)), \
            f"{name}: a held output changed under the next call"
        counts = want[-2][0, :, 0, 0].int().tolist()
        log(f"graphs, {name}: replay against eager max |diff| {diff}; "
            f"counters {counters}; peaks a part {counts}")
        assert diff == 0.0, f"{name}: replay differs from eager by {diff}"
        return diff, eager, call

    coco = zoo.load_pose_model(PoseModel.COCO_18, seed=0, device=device)
    nets = (("BODY_25", model), ("COCO_18", coco))
    for (net_name, net_model), batch in itertools.product(nets, batches):
        inference = PoseInference(net_model, net_hw=net_hw, device=device)
        frames = torch.from_numpy(scene_frames(rng, batch, net_hw)).to(device)
        other = torch.from_numpy(scene_frames(rng, batch, net_hw)).to(device)
        diff, eager, call = check(f"{net_name} batch {batch}", inference,
                                  frames, other)
        per_call = launches_per_call(f"graphs, {net_name} batch {batch}",
                                     call)
        # a replay adds what its capture launched: the fused scorer and the
        # NMS kernels once, the epilogue once a convolution and scale
        n_convs = len(inference.plan.scale_input_to_net) * len(
            inference.net.epilogues)
        assert per_call == {"paf_scores_fused": 1, "sample_bicubic_scales": 0,
                            "bias_act": n_convs, "nms": 1}, per_call
        res = {"max_abs_diff": diff, "launches_per_call": per_call}
        for name, fn in (("eager", eager), ("replay", call)):
            fn()
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            host = (time.perf_counter() - t0) * 1e3 / iters
            _sync(device)
            res[name] = {"host_ms_per_call": host,
                         "event_ms_per_call": timed(fn, 2, iters, device)}
        log(f"graphs, {net_name} batch {batch}: eager {res['eager']}, "
            f"replay {res['replay']} (host: the dispatch; event: the "
            "card's pace)")
        out[f"{net_name.lower()}_batch_{batch}"] = res

    info = model.info
    pairs, map_idx = paf.pair_tables(info)
    maps = [torch.from_numpy(synthetic.make_targets(
        synthetic.random_people(rng, 3, net_hw)[None], pairs, map_idx,
        net_hw, info.num_parts, info.heatmap_channels)).to(device)
        for _ in range(2)]
    bypass = PoseInference(model, net_hw=net_hw, device=device,
                           net_bypass=True)
    out["net_bypass"] = check("net_bypass", bypass, maps[0], maps[1])[0]
    raw_hw = (720, 1280)
    scaled = PoseInference(model, net_hw=net_hw, device=device,
                           scale_number=2, frame_hw=raw_hw)
    raw = [torch.from_numpy(scene_frames(rng, 2, raw_hw)).to(device)
           for _ in range(2)]
    out["two_scales_raw"] = check("2 scales, raw 720x1280", scaled, *raw)[0]
    if torch.cuda.device_count() > 1:
        # graphs of a card that is not the current device; the fused
        # kernel's launcher makes its card current, so each call first
        # makes the phase's card current again
        card, current = torch.device("cuda", 1), device.index or 0
        assert current != 1, "the check wants cuda:1 not current"
        inference = PoseInference(zoo.load_pose_model(seed=0, device=card),
                                  net_hw=net_hw, device=card)
        frames = [torch.from_numpy(scene_frames(rng, 1, net_hw)).to(card)
                  for _ in range(2)]
        out["not_current_card"] = check(
            f"batch 1 on cuda:1, cuda:{current} current", inference,
            *frames, before=lambda: torch.cuda.set_device(current))[0]
        torch.cuda.set_device(current)
        inference.decode(inference.net_outputs(frames[1]))
        assert torch.cuda.current_device() == current, \
            "a replay left another card current"
    return out


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
        for name, peak in (("cnn_bf16", H100_SXM.bf16_tflops),
                           ("cnn_f32", H100_SXM.f32_tflops)):
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
    dec = inference.decoder
    geo = paf._line_geometry(peaks, dec.pairs_dev, inference.net_hw)
    make_args = lambda: paf.sampler_args(
        sources, inference.plan.scale_input_to_net, inference.net_hw, geo,
        dec.map_idx_dev)
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
    dec, cp = inference.decoder, inference.decoder.connect
    with torch.inference_mode():
        sources = inference.net_outputs(images)
        peaks, scores = inference.decode(sources)
        args = (sources, inference.plan.scale_input_to_net, net_hw, peaks,
                dec.pairs_dev, dec.map_idx_dev, cp.inter_threshold,
                cp.inter_min_above_threshold, cp.nms_threshold)
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
        routing["fused_bound"] = fused_bound(sources, peaks, dec.pairs_dev,
                                             dec.map_idx_dev)
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
    dec, cp = wb.body.decoder, wb.body.decoder.connect
    with torch.inference_mode():
        sources = wb.body.net_outputs(frames)
        peaks, _ = wb.body.decode(sources)
        args = (sources, wb.body.plan.scale_input_to_net, net_hw, peaks,
                dec.pairs_dev, dec.map_idx_dev, cp.inter_threshold,
                cp.inter_min_above_threshold, cp.nms_threshold)
        body_paf = {
            "ms": timed(lambda: paf_cuda.paf_scores_fused(*args), 3, 20,
                        device),
            "bound": fused_bound(sources, peaks, dec.pairs_dev,
                                 dec.map_idx_dev),
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
    from openpose_tpu_torch.ops import paf_cuda
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
    dec, cp = inference.decoder, inference.decoder.connect
    render = lambda: train.make_targets(
        kp_dev, dec.pairs_dev, dec.map_idx_dev, net_hw, info.num_parts,
        info.heatmap_channels)
    net_out = render()
    with torch.inference_mode():
        peaks, _ = inference.decode([net_out])
    kernel = fused_against_plain(
        ([net_out], [1.0], net_hw, peaks, dec.pairs_dev, dec.map_idx_dev,
         cp.inter_threshold, cp.inter_min_above_threshold,
         cp.nms_threshold), device)
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
                    loss = torch.mean(
                        (net._run(x_dev, dtype, None) - t_dev) ** 2)
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
    gc.collect()        # no earlier garbage is freed inside the window
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    gc.disable()
    try:
        peaks, scores = inference(images)
        torch.cuda.synchronize(device)
    finally:
        gc.enable()
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
    from openpose_tpu_torch.ops import paf
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
    out = dict(maps=list(sources[0].shape), placed=len(placed),
               **fused_against_plain(
                   (sources, plan.scale_input_to_net, (h, w), peaks, pairs,
                    map_idx, cp.inter_threshold,
                    cp.inter_min_above_threshold, cp.nms_threshold),
                   device, iters))
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
    from openpose_tpu_torch.ops import conv_epilogue, paf_cuda
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
    # the evaluation's frames went through the fused kernel, one each, and
    # the bf16 trainer's convolutions through the epilogue kernel
    out["launches"] = read_launches("train path", paf_cuda.paf_scores_fused,
                                    conv_epilogue.bias_act)
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


def tutorial(name):
    """A tutorial of the port by its file name (they start with digits)."""
    import importlib
    return importlib.import_module(f"openpose_tpu_torch.examples.{name}")


def quiet(fn, *args, **kwargs):
    """fn(*args, **kwargs) with what it prints kept; (result, text)."""
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


@contextlib.contextmanager
def merge_gates(gates):
    """For the length of the block, each call of `refine._merge_refined`
    appends to `gates` which of its gates decided it (the same tests in the
    same order, read before the merge writes): "replaced", "fewer than 75%
    of the parts", "distance and IoU disagree" or "distance over 0.1 x
    |rect corner|"."""
    import numpy as np
    from openpose_tpu_torch.pose import refine
    merge = refine._merge_refined

    def gate(kp_all, person, cand_kp, nms_thr):
        orig = kp_all[person]
        n_orig = int((orig[:, 2] > nms_thr).sum())
        rect = refine._keypoints_rectangle(orig, nms_thr)
        kept = [c for c in range(cand_kp.shape[0])
                if (cand_kp[c][:, 2] > nms_thr).sum() >= 0.75 * n_orig]
        if not kept:
            return "fewer than 75% of the parts"
        dist = [refine._distance_average(orig, cand_kp[c], nms_thr)
                for c in kept]
        iou = [refine._rect_iou(rect, refine._keypoints_rectangle(
            cand_kp[c], nms_thr)) for c in kept]
        if int(np.argmin(dist)) != int(np.argmax(iou)):
            return "distance and IoU disagree"
        ratio = 0.1 * float(np.hypot(rect[0], rect[1])) if rect else 0.0
        return "replaced" if min(dist) < ratio \
            else "distance over 0.1 x |rect corner|"

    def recording(kp_all, scores_all, person, cand_kp, cand_sc, nms_thr):
        reason = gate(kp_all, person, cand_kp, nms_thr)
        replaced = merge(kp_all, scores_all, person, cand_kp, cand_sc,
                         nms_thr)
        assert replaced == (reason == "replaced"), (replaced, reason)
        gates.append(reason)
        return replaced

    refine._merge_refined = recording
    try:
        yield
    finally:
        refine._merge_refined = merge


def tools_phase(device, checkpoint, model, eval_images=16,
                image_size=(184, 328), n_frames=8, t2ap_steps=50):
    """The user scripts and the tutorials of `openpose_tpu_torch` on the
    card, frames and cameras in memory (the card's machine has no OpenCV,
    so nothing is rendered or read from files):
    (a) `scripts/synthetic_eval.main` on `eval_images` scenes at its
        defaults (368x656, f32): AP at the accuracy phase's floor (0.95),
        one fused launch a batch;
    (b) `scripts/threed_eval.main` at its defaults (8 people x 4 cameras):
        the threed phase's gates on the sweep and on bundle adjustment;
    (c) tutorial 09 on its injected 2-person net output (`model`'s post
        chain): both people at the means the same tutorial prints on the
        CPU, one fused launch, and the fused kernel held to its plain
        version on that call's own arguments;
    (d) tutorials 01, 02, 03, 07, 08 on one frame of the trained net's
        people (`checkpoint`, -1x176, f32): 02's body, 03's keypoints and
        the people of `Wrapper.process` agree with 01's, 07 and 08 on 02's
        face and hand rectangles give 02's faces and hands; 04 over
        `n_frames` frames in memory through `AsyncPipeline`, equal to
        `Wrapper.process` frame by frame; 05 over three views of a rig
        with its camera matrices in memory (06 reads COCO images with
        OpenCV and does not run here);
    (e) `scripts/train_to_ap.main --steps t2ap_steps` at 184x328, a
        plumbing check of the script: its JSON has every key of the JAX
        script's TRAIN2AP.json;
    (f) top-down refinement on people the net sees small (heights 50-80
        px in the 184x328 frame, where the 320x176 crop sees them at the
        trained size): how many people it replaces, and which gate of
        `refine._merge_refined` stops each candidate that it does not."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from openpose_tpu_torch import accuracy, synthetic
    from openpose_tpu_torch.io import producers
    from openpose_tpu_torch.ops import paf_cuda
    from openpose_tpu_torch.pose import scaler
    from openpose_tpu_torch.pose.extractor import PoseExtractor
    from openpose_tpu_torch.scripts import (synthetic_eval, threed_eval,
                                            train_to_ap)
    from openpose_tpu_torch.wrapper import (FaceConfig, HandConfig,
                                            PoseConfig, Wrapper)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="tools_phase_", dir=OUT_DIR))
    out = {}
    log("tools: tutorial 06 (COCO training) is not run on the card: "
        "coco_data_iterator decodes images with OpenCV, which this machine "
        "lacks")
    reset_launches()
    try:
        # (a) the closed accuracy loop through its script
        t0 = time.perf_counter()
        rc, _ = quiet(synthetic_eval.main, [
            "--images", str(eval_images), "--out",
            str(work / "synthetic_eval.json")])
        a = json.loads((work / "synthetic_eval.json").read_text())
        a.update(rc=rc, seconds=time.perf_counter() - t0,
                 fused_launches=paf_cuda.paf_scores_fused.launches,
                 batches=-(-eval_images // 8))
        out["a"] = a
        log(f"tools (a) scripts/synthetic_eval, {eval_images} images at "
            f"368x656, f32: {json.dumps(a)} (AP floor 0.95)")
        assert rc == 0 and a["AP"] >= 0.95, a
        assert a["fused_launches"] == a["batches"], a

        # (b) the 3-D table through its script
        t0 = time.perf_counter()
        rc, _ = quiet(threed_eval.main, ["--out", str(work / "bench3d.json")])
        b = json.loads((work / "bench3d.json").read_text())
        b.update(rc=rc, seconds=time.perf_counter() - t0)
        out["b"] = b
        log(f"tools (b) scripts/threed_eval at its defaults: {json.dumps(b)}")
        assert rc == 0, b
        for row in b["triangulation_sweep"]:
            assert row["reprojection_px"] < row["reference_gate_px"], row
            if row["pixel_noise"] == 0.0:
                assert row["rmse_mm"] < 0.5, row
            elif row["pixel_noise"] == 1.0:
                assert row["rmse_mm"] < 10.0, row
        ba = b["bundle_adjustment"]
        assert ba["cam_rot_err_deg_out"] < 0.2 * ba["cam_rot_err_deg_in"], ba
        assert ba["rmse_mm_after_ba"] < 0.7 * ba["rmse_mm_before_ba"], ba

        # (c) tutorial 09 on the card and on the CPU
        t09 = tutorial("09_keypoints_from_heatmaps")
        before = paf_cuda.paf_scores_fused.launches
        (pred09, means), printed = quiet(t09.keypoints_from_heatmaps,
                                         device=device, model=model)
        launches09 = paf_cuda.paf_scores_fused.launches - before
        (_, cpu_means), cpu_printed = quiet(t09.keypoints_from_heatmaps,
                                            device="cpu")
        c = {"people": int(pred09.keypoints.shape[0]), "means": means,
             "cpu_means": cpu_means, "prints_as_on_cpu": printed
             == cpu_printed, "fused_launches": launches09}
        log(f"tools (c) tutorial 09: {json.dumps(c)}")
        assert c["people"] == 2 and launches09 == 1, c
        assert all(abs(g - w) < 0.05 for g, w in zip(means, cpu_means)), c
        assert all(abs(g - x) < 10.0 for g, x in zip(means, t09.INJECTED_X))

        # (d) the tutorials on a frame of the trained net's people
        people = accuracy.held_out_scenes(1, image_size, (1, 3), seed=9)[0][0]
        frame = synthetic_frame(people, image_size)
        pose = PoseConfig(net_resolution=(-1, 176), caffemodel=checkpoint,
                          compute_dtype="float32")
        reference = Wrapper(pose, device=device)
        want = reference.process(frame)

        def close(got, expect):
            got, expect = np.asarray(got), np.asarray(expect)
            return got.shape == expect.shape and bool(np.allclose(
                got, expect, atol=1e-3))
        (_, d1), _ = quiet(tutorial("01_body_from_image").body_from_image,
                           frame, pose, device=device)
        (_, d2), _ = quiet(
            tutorial("02_whole_body_from_image").whole_body_from_image,
            frame, pose, FaceConfig(enable=True), HandConfig(enable=True),
            device=device)
        pred3, _ = quiet(tutorial("03_heatmaps_from_image")
                         .heatmaps_from_image, frame, pose, device=device)
        faces, _ = quiet(tutorial("07_face_from_rectangles")
                         .face_from_rectangles, frame, d2.face_rectangles,
                         device=device)
        (left, right), _ = quiet(
            tutorial("08_hand_from_rectangles").hand_from_rectangles, frame,
            d2.hand_rectangles, device=device)
        d = {"placed": len(people), "people": len(d1.pose_keypoints),
             "01_as_process": close(d1.pose_keypoints, want.pose_keypoints),
             "02_body_as_01": close(d2.pose_keypoints, d1.pose_keypoints),
             "02_shapes": [list(np.shape(k)) for k in (
                 d2.face_keypoints, d2.hand_left_keypoints,
                 d2.hand_right_keypoints)],
             "03_heatmaps": list(pred3.heatmaps.shape),
             "03_keypoints_as_01": close(pred3.keypoints, d1.pose_keypoints),
             "03_heatmaps_finite": bool(np.isfinite(pred3.heatmaps).all()),
             "07_as_02": close(faces, d2.face_keypoints),
             "08_as_02": close(left, d2.hand_left_keypoints)
             and close(right, d2.hand_right_keypoints)}

        scenes = accuracy.held_out_scenes(n_frames, image_size, (1, 3),
                                          seed=11)
        images = [img for _, img in scenes]
        before = paf_cuda.paf_scores_fused.launches
        (stats, results), _ = quiet(
            tutorial("04_video_async").video_async,
            ([producers.Frame(image=img, frame_id=i)]
             for i, img in enumerate(images)), pose, device=device)
        d["04_fused_launches_per_frame"] = (
            paf_cuda.paf_scores_fused.launches - before) / n_frames
        d["04_fps"] = stats.fps
        d["04_as_process"] = sum(
            close(got, reference.process(img, i).pose_keypoints)
            for i, (got, img) in enumerate(zip(results, images)))

        focal, depth, baseline = 300.0, 4.0, 0.1
        intrinsics = np.array([[focal, 0, image_size[1] / 2],
                               [0, focal, image_size[0] / 2], [0, 0, 1]])
        cams = np.stack([intrinsics @ np.hstack(
            [np.eye(3), [[-baseline * v], [0], [0]]]) for v in range(3)])
        views = []
        for v in range(3):
            moved = people.copy()
            moved[..., 0] -= focal * baseline * v / depth
            views.append(synthetic_frame(moved, image_size))
        (_, kp3d), _ = quiet(tutorial("05_multiview_3d").multiview_3d,
                             views, cams, pose, device=device)
        seen = kp3d[..., 3] > 0
        d["05_shape"] = list(kp3d.shape)
        d["05_median_depth"] = float(np.median(kp3d[..., 2][seen])) \
            if seen.any() else None
        out["d"] = d
        log(f"tools (d) tutorials 01-05, 07, 08 on the trained net's people "
            f"at {image_size}, -1x176, f32: {json.dumps(d)}")
        assert d["people"] >= 1 and d["01_as_process"], d
        assert d["02_body_as_01"] and d["03_keypoints_as_01"], d
        assert d["02_shapes"] == [[d["people"], 70, 3], [d["people"], 21, 3],
                                  [d["people"], 21, 3]], d
        assert d["03_heatmaps"][:2] == [22, 40] and d["03_heatmaps_finite"]
        assert d["07_as_02"] and d["08_as_02"], d
        assert stats.frames == n_frames and d["04_as_process"] == n_frames, d
        assert d["04_fused_launches_per_frame"] == 1, d
        assert kp3d.ndim == 3 and kp3d.shape[1:] == (25, 4) and seen.any(), d
        assert np.isfinite(kp3d).all(), d

        # (e) train_to_ap's script as plumbing
        t0 = time.perf_counter()
        rc, _ = quiet(train_to_ap.main, [
            "--steps", str(t2ap_steps), "--image_size",
            f"{image_size[0]}x{image_size[1]}", "--out",
            str(work / "train2ap.json")])
        e = json.loads((work / "train2ap.json").read_text())
        keys = set(json.loads((ROOT / "TRAIN2AP.json").read_text()))
        out["e"] = {"rc": rc, "seconds": time.perf_counter() - t0,
                    "missing_keys": sorted(keys - set(e)),
                    **{k: e[k] for k in ("AP", "AP50", "steps", "img_s",
                                         "device_step_ms")}}
        log(f"tools (e) scripts/train_to_ap --steps {t2ap_steps} at "
            f"{image_size}: {json.dumps(out['e'])}")
        assert rc == 0 and not out["e"]["missing_keys"], out["e"]

        # (f) refinement where the crop sees more than the frame
        rng = np.random.RandomState(13)
        small = []
        for _ in range(n_frames):
            placed = synthetic.random_people(
                rng, 2, image_size, height_range=(50.0, 80.0),
                min_spacing=60.0)
            small.append((placed, synthetic.render_scene_image(
                placed, image_size, rng=rng)))
        refined = Wrapper(dataclasses.replace(pose, top_down_refinement=True),
                          device=device)
        gates = []
        replaced, found = 0, 0
        before = paf_cuda.paf_scores_fused.launches
        with merge_gates(gates):
            for placed, img in small:
                plain = reference.process(img).pose_keypoints
                after = refined.process(img).pose_keypoints
                found += len(plain)
                replaced += sum(not np.array_equal(p, q)
                                for p, q in zip(plain, after))
        f = {"frames": n_frames, "placed": 2 * n_frames, "found": found,
             "candidates_merged": len(gates), "replaced": replaced,
             "gates": {g: gates.count(g) for g in sorted(set(gates))},
             "fused_launches_per_frame": (
                 paf_cuda.paf_scores_fused.launches - before) / n_frames}
        out["f"] = f
        log(f"tools (f) refinement on people 50-80 px tall at {image_size}, "
            f"the trained net: {json.dumps(f)}")
        assert gates.count("replaced") == replaced, f
        out["launches"] = read_launches("tools path",
                                        paf_cuda.paf_scores_fused)

        # (c) the fused kernel on the tutorial's own call, after the counts
        # are read: these launches only compare
        h, w = t09.FRAME_HW
        extractor = PoseExtractor(model, compute_dtype=torch.float32,
                                  device=device)
        plan = scaler.extract_scales((w, h), (w, h))
        cp = extractor.connect
        sources = [torch.tensor(t09.two_person_net_output(model.info, device),
                                device=device)[None]]
        with torch.inference_mode():
            peaks, _ = extractor.decode(sources, plan, 0.5)
        assert np.array_equal(peaks[0].cpu().numpy(), pred09.peaks)
        kernel = fused_against_plain(
            (sources, plan.scale_input_to_net, (h, w), peaks,
             extractor.decoder.pairs_dev, extractor.decoder.map_idx_dev,
             cp.inter_threshold, cp.inter_min_above_threshold,
             cp.nms_threshold), device)
        out["kernel_on_tutorial_09"] = kernel
        log(f"fused kernel on tutorial 09's call (1 x {h // 8}x{w // 8} "
            f"maps): tol={KERNEL_TOL} " + json.dumps(kernel))
        assert kernel["mismatches"] == 0 \
            and kernel["max_abs_err"] <= KERNEL_TOL, kernel
        assert kernel["accepted"] > 0, kernel
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


@contextlib.contextmanager
def one_rank_group(device):
    """A process group of this one process (NCCL on a card, gloo on the
    CPU) through a file under build/, no address: the one already up when
    there is one, else one that ends with the block."""
    import torch.distributed as dist
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    if dist.is_initialized():
        yield
        return
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    store = OUT_DIR / "group_store"
    store.unlink(missing_ok=True)
    try:
        with mesh_lib.process_group(str(store), 1, 0, device):
            yield
    finally:
        store.unlink(missing_ok=True)


def unsharded_train(config, device, dtype):
    """`train_loop.train`'s loop on one device without a mesh, whatever
    group is up (the run the mesh phase's trainer is held to): the losses
    of every step and ms per step from step 1 on, fed by the same seeded
    scene iterator, the last step's checkpoint write included as in
    `train`'s figure."""
    import torch
    from openpose_tpu_torch import train_loop
    from openpose_tpu_torch.models import checkpoint
    trainer = train_loop.Trainer(config, device, dtype)
    data = train_loop.synthetic_scene_iterator(config, device=device)
    losses = []
    for step in range(config.steps):
        images, keypoints = next(data)
        losses.append(trainer.step(images, torch.as_tensor(
            keypoints, dtype=torch.float32).to(device)))
        if step == 0:
            _sync(device)
            t0 = time.perf_counter()
    checkpoint.save(str(OUT_DIR / "mesh_ckpt" / "unsharded.npz"),
                    trainer.full_params())
    _sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3 / (config.steps - 1)
    return [float(v) for v in losses], step_ms


def mesh_phase(device, model, batch=8, net_hw=(368, 656), iters=6,
               wb_batch=4, wb_frame_hw=(720, 1280), people_cap=8,
               wb_net=368, train_size=(368, 368), train_batch=8,
               train_steps=10):
    """The port's entry points over a one-rank mesh (a NCCL group of this
    process on the card; gloo on the CPU), each held to the call without a
    mesh on the same inputs:
    (a) batch-8 `PoseInference` at 368x656, bf16, 127 peaks: peaks and
        scores bit-equal, one fused launch a call, no collective (the
        torch.distributed calls made, and the NCCL kernels and the process
        group's spans in a torch.profiler trace); ms per batch of both,
        on the device and end to end, taken in turn;
    (b) `WholeBodyInference` at batch 4, 720x1280, people cap 8: every
        frame's results equal; ms per batch of both;
    (c) `train_loop.train` at 368x368, batch 8, float32, 10 steps, against
        the same loop without a mesh: the losses within 1e-6 relative (the
        one-rank all-reduce is a copy); ms per step of both, fed by the
        scene iterator, and of the step alone on one batch on the card, in
        turns; one meshed step's collectives (one all-reduce);
    (d) `parallel.dryrun.dryrun_multichip(1)`.
    A ``model`` dimension of 2 needs two ranks, and NCCL takes no two
    ranks on one card: the CPU tests hold that path."""
    import numpy as np
    import torch
    from openpose_tpu_torch import train_loop
    from openpose_tpu_torch.models import zoo
    from openpose_tpu_torch.ops import paf_cuda
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    from openpose_tpu_torch.parallel.dryrun import (
        count_collectives, dryrun_multichip)
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.runtime.whole_body import WholeBodyInference

    out = {}
    reset_launches()
    t_phase = time.perf_counter()
    config = train_loop.TrainConfig(image_size=train_size,
                                    batch_size=train_batch, steps=train_steps,
                                    checkpoint_every=train_steps,
                                    checkpoint_dir=str(OUT_DIR / "mesh_ckpt"))
    with one_rank_group(device):
        mesh = mesh_lib.make_mesh(device_type=device.type)
        out["mesh"] = [list(mesh.shape), list(mesh.mesh_dim_names),
                       mesh.device_type]

        # (a) serving
        rng = np.random.RandomState(11)
        frames = scene_frames(rng, batch, net_hw)
        plain = PoseInference(model, net_hw=net_hw, device=device)
        meshed = PoseInference(model, net_hw=net_hw, mesh=mesh)
        assert meshed.device == device, (meshed.device, device)
        images = torch.from_numpy(frames[meshed.local_rows(batch)]).to(device)
        want, got = plain(images), meshed(images)
        bit_equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        per_call = launches_per_call("mesh (a) serving",
                                     lambda: meshed(images))
        _, collectives = count_collectives(
            lambda: meshed.fetch(*meshed(images)))

        def end_to_end(inference):
            pk, sc = inference.fetch(*inference(images))
            return [inference.assemble(pk[b], sc[b]) for b in range(batch)]
        ms = {"plain_device": [], "meshed_device": [], "plain_end_to_end": [],
              "meshed_end_to_end": []}
        for _ in range(2):          # in turn: host-bound figures drift
            for name, inference in (("plain", plain), ("meshed", meshed)):
                ms[name + "_device"].append(timed(
                    lambda: inference(images), 2, iters, device))
                ms[name + "_end_to_end"].append(host_ms(
                    lambda: end_to_end(inference), iters))
        a = {"batch": batch, "net_hw": list(net_hw), "bit_equal": bit_equal,
             "launches_per_call": per_call, "collectives": collectives,
             "ms": ms}
        out["a"] = a
        log("mesh (a) PoseInference on a one-rank mesh against no mesh: "
            + json.dumps(a))
        assert bit_equal, "meshed serving differs from unsharded"
        assert per_call["paf_scores_fused"] == 1, per_call
        assert collectives == {"dist_calls": {}, "traced": 0,
                               "nccl_kernels": 0}, collectives

        # (b) whole body
        face = zoo.load_face_model(device=device)
        hand = zoo.load_hand_model(device=device)
        rng = np.random.RandomState(2)
        fh = wb_frame_hw[0]
        wb_frames = np.stack([synthetic_scene(
            rng, wb_frame_hw, min(4, people_cap), (0.6 * fh, 0.9 * fh))
            for _ in range(wb_batch)])
        kw = dict(frame_hw=wb_frame_hw, people_cap=people_cap,
                  face_net_size=wb_net, hand_net_size=wb_net)
        wb_plain = WholeBodyInference(model, face, hand, device=device, **kw)
        wb_meshed = WholeBodyInference(model, face, hand, mesh=mesh, **kw)
        wb_images = torch.from_numpy(
            wb_frames[wb_meshed.local_rows(wb_batch)]).to(device)
        want, got = wb_plain(wb_images), wb_meshed(wb_images)
        fields = ("pose_keypoints", "pose_scores", "face_keypoints",
                  "hand_left_keypoints", "hand_right_keypoints")
        equal = len(got) == len(want) and all(
            np.array_equal(getattr(g, f), getattr(w, f))
            for g, w in zip(got, want) for f in fields)
        b = {"batch": wb_batch, "frame_hw": list(wb_frame_hw),
             "people_per_frame": [len(r.pose_keypoints) for r in got],
             "equal": equal, "ms": {}}
        for name, wb in (("plain", wb_plain), ("meshed", wb_meshed),
                         ("plain_again", wb_plain),
                         ("meshed_again", wb_meshed)):
            b["ms"][name] = host_ms(lambda: wb(wb_images), 2)
        out["b"] = b
        log("mesh (b) WholeBodyInference on a one-rank mesh against no "
            "mesh: " + json.dumps(b))
        assert equal, "meshed whole body differs from unsharded"

        # (c) training, float32, with cuDNN's deterministic algorithms
        # chosen by its heuristics in both runs (its benchmark may pick
        # another algorithm for each, and its fastest weight gradients sum
        # with atomics: 3e-5 of the loss apart after 9 steps otherwise)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            plain_losses, plain_step_ms = unsharded_train(config, device,
                                                          torch.float32)
            stats = {}
            train_loop.train(config, train_loop.synthetic_scene_iterator(
                config, device=device), verbose=False, stats_out=stats,
                device=device, compute_dtype=torch.float32)
        rel = max(abs(stats["losses"][step] - plain_losses[step])
                  / abs(plain_losses[step]) for step in stats["losses"])
        trainer = train_loop.Trainer(config, device, torch.float32, mesh)
        step_images, step_kp = _training_batch(device, config)
        _, step_collectives = count_collectives(
            lambda: float(trainer.step(step_images, step_kp)))
        # the step alone, its inputs on the card, in turns
        plain_trainer = train_loop.Trainer(config, device, torch.float32)
        step_device_ms = {"plain": [], "meshed": []}
        for name in ("plain", "meshed", "meshed", "plain"):
            stepper = plain_trainer if name == "plain" else trainer
            step_device_ms[name].append(timed(
                lambda: stepper.step(step_images, step_kp), 1, 4, device))
        del trainer, plain_trainer
        c = {"steps": train_steps, "image_size": list(train_size),
             "batch": train_batch, "meshed_losses": stats["losses"],
             "plain_losses": {step: plain_losses[step]
                              for step in stats["losses"]},
             "max_rel_loss_diff": rel,
             "meshed_step_ms": stats["step_ms"],
             "plain_step_ms": plain_step_ms,
             "meshed_img_s": stats["img_s"],
             "step_device_ms": step_device_ms,
             "step_collectives": step_collectives}
        out["c"] = c
        log("mesh (c) train_loop.train on a one-rank mesh against no mesh, "
            "float32: " + json.dumps(c))
        shutil.rmtree(OUT_DIR / "mesh_ckpt", ignore_errors=True)
        assert rel <= 1e-6, c
        assert step_collectives["dist_calls"] == {"all_reduce": 1}, c

        # (d) every multi-device path at tiny shapes
        t0 = time.perf_counter()
        d = dryrun_multichip(1, device)
        d["seconds"] = time.perf_counter() - t0
        out["d"] = d
        log("mesh (d) dryrun_multichip(1): " + json.dumps(d))
    log("mesh: a model dimension of 2 needs two ranks and NCCL takes no two "
        "ranks on one card; tests/test_torch_sharded.py holds it on the CPU")
    out["launches"] = read_launches("mesh path", paf_cuda.paf_scores_fused)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def synthetic_scene(rng, frame_hw, n_people, height_range):
    """One rendered scene of n_people (the numpy renderer)."""
    from openpose_tpu_torch import synthetic
    return synthetic.render_scene_image(
        synthetic.random_people(rng, n_people, frame_hw,
                                height_range=height_range), frame_hw, rng)


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
    (b) the sharded path: a one-rank NCCL group (`one_rank_group`: the mesh
        phase's in the default run), `make_mesh(model=1)`,
        `bundle_adjust(mesh=...)` equal to `bundle_adjust()` within 1e-6
        (bit-equal expected);
    (c) `accuracy3d.noise_sweep` on the card against the CPU: the same
        `valid_fraction`, `rmse_mm` within 1e-2 mm, and the JAX suite's
        gates (0.5 mm at 0 px, 10 mm at 1 px, reprojection under the
        reference gate);
    (d) the VisualSFM writers: `.sift` files of the rig's projected points
        and their `FeatureMatches.txt`, written and read back."""
    import importlib.util
    import numpy as np
    import torch
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

    # (b) the sharded path on a one-rank NCCL group (the mesh phase's, when
    # it is up)
    if device.type == "cuda":
        with one_rank_group(device):
            mesh = mesh_lib.make_mesh(model=1)
            sharded = ba_arrays(problem, device, iterations, mesh=mesh)
            b = {"mesh": [list(mesh.shape), list(mesh.mesh_dim_names),
                          mesh.device_type],
                 "max_abs_diff_to_unsharded": max_abs_diff(sharded, card),
                 "bit_equal": all(np.array_equal(s, c)
                                  for s, c in zip(sharded, card)),
                 "sharded_ms": host_ms(lambda: ba_arrays(
                     problem, device, iterations, mesh=mesh), card_iters)}
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


def unsharded_dryrun_loss(device, rows):
    """The loss of `dryrun_multichip`'s train step without a mesh: BODY_25
    at 64x64 from seed 0, `rows` images of zeros with people at (20,
    20)."""
    import torch
    from openpose_tpu_torch import train
    from openpose_tpu_torch.models import graph
    from openpose_tpu_torch.ops import paf
    from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    state = train.init_train_state(graph.load_spec(info.spec),
                                   torch.Generator().manual_seed(0), 1e-4,
                                   device)
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf.pair_tables(info))
    keypoints = torch.zeros((rows, 4, info.num_parts, 3), device=device)
    keypoints[..., :2] = 20.0
    keypoints[..., 2] = 1.0
    targets = train.make_targets(keypoints, pairs, map_idx, (64, 64),
                                 info.num_parts, info.heatmap_channels)
    _, loss = train.make_train_step(torch.float32)(
        state, torch.zeros((rows, 64, 64, 3), device=device), targets)
    return float(loss)


def _scaling_rank(rank, world, init_file, device_type, batch, net_hw,
                  iters, train_size, train_steps):
    """One rank of `mesh_scaling`: batch frames of its own through
    `PoseInference`, end to end and on the device, `train_loop.train` and
    its step alone over the world's data mesh, and `dryrun_multichip` over
    the world (a ``model`` dimension of 2 where it is even); rank 0 writes
    the world's figures."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from openpose_tpu_torch import train_loop
    from openpose_tpu_torch.models import zoo
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    from openpose_tpu_torch.parallel.dryrun import dryrun_multichip
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.scripts.scaling_bench import rank_device
    device = rank_device(rank, world, device_type)
    with mesh_lib.process_group(init_file, world, rank, device):
        mesh = mesh_lib.make_mesh(device_type=device.type)
        model = zoo.load_pose_model(seed=0, device=device)
        inference = PoseInference(model, net_hw=net_hw, mesh=mesh)
        frames = scene_frames(np.random.RandomState(rank), batch, net_hw)
        images = torch.from_numpy(frames).to(device)

        def serve():
            pk, sc = inference.fetch(*inference(images))
            return [inference.assemble(pk[b], sc[b]) for b in range(batch)]
        serve()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            serve()
        dist.barrier()
        serve_s = time.perf_counter() - t0
        device_ms = timed(lambda: inference(images), 2, iters, device)
        config = train_loop.TrainConfig(
            image_size=train_size, batch_size=batch * world,
            steps=train_steps, checkpoint_every=train_steps,
            checkpoint_dir=str(OUT_DIR / "scaling_ckpt"))
        stats = {}
        train_loop.train(config, train_loop.synthetic_scene_iterator(
            config, prefetch_workers=2, device=device), verbose=False,
            stats_out=stats, device=device, compute_dtype=torch.float32)
        stats.update(train_loop.device_step_probe(config, device=device))
        dryrun = dryrun_multichip(world, device) if world > 1 else None
        if rank == 0:
            if dryrun is not None:
                want = unsharded_dryrun_loss(device, dryrun["mesh"][0])
                dryrun["unsharded_loss"] = want
                dryrun["rel_loss_diff"] = abs(dryrun["loss"] - want) / want
            (OUT_DIR / f"scaling_{world}.json").write_text(json.dumps({
                "ranks": world, "serving_fps": world * batch * iters
                / serve_s, "serving_device_ms_per_rank": device_ms,
                "serving_device_fps": world * batch * 1e3 / device_ms,
                "train_img_s": stats["img_s"],
                "train_step_ms": stats["step_ms"],
                "train_device_step_ms": stats["device_step_ms"],
                "train_device_img_s": stats["device_img_s"],
                "dryrun": dryrun}))


def mesh_scaling(max_ranks=4, batch=8, net_hw=(368, 656), iters=10,
                 train_size=(368, 368), train_steps=10):
    """One rank per card, 1, 2 and 4 ranks up to the cards there are
    (`--mesh-scaling`; gloo ranks on the CPU where there is no card, to
    rehearse): batch-8 bf16 serving frames/s end to end and on the device,
    float32 train img/s at 368x368 and batch 8 a rank, fed and alone, of
    each world against one rank; and `dryrun_multichip` over each world
    of 2 ranks or more, its train step's loss against the same step
    without a mesh."""
    import torch
    from openpose_tpu_torch.scripts.scaling_bench import run_world
    cards = torch.cuda.device_count()
    device_type = "cuda" if cards else "cpu"
    worlds = [n for n in (1, 2, 4) if n <= max_ranks
              and (n <= cards or not cards)]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    rates = []
    for world in worlds:
        init = OUT_DIR / f"scaling_store_{world}"
        init.unlink(missing_ok=True)
        run_world(_scaling_rank, world, (world, str(init), device_type,
                                         batch, net_hw, iters, train_size,
                                         train_steps))
        rates.append(json.loads(
            (OUT_DIR / f"scaling_{world}.json").read_text()))
        log("mesh scaling: " + json.dumps(rates[-1]))
        dryrun = rates[-1]["dryrun"]
        assert dryrun is None or dryrun["rel_loss_diff"] <= 1e-5, dryrun
    shutil.rmtree(OUT_DIR / "scaling_ckpt", ignore_errors=True)
    for r in rates:
        for key in ("serving_fps", "serving_device_fps", "train_img_s",
                    "train_device_img_s"):
            r[key + "_speedup"] = r[key] / rates[0][key]
    log("mesh scaling against one rank: " + json.dumps(rates))
    return rates


def timing_phase(device, model, train_step_ms=None, rehearse=False):
    """The port's measuring layer (`utils/benchmark.py` and the timing
    scripts) on the card (`rehearse`: at small shapes, to try the phase on
    the CPU):
    (a) `scripts/speed_test` at its defaults (BODY_25, batch 1, 368x656,
        bf16 net): each stage's ms; the PAF stage's call must launch the
        fused kernel once, its scores held to the kernel's plain version
        on that call's tensors (KERNEL_TOL);
    (b) `scripts/profile_net` at batch 8, 368x656, bf16: ms a frame, GFLOP,
        TFLOP/s and share of the bf16 datasheet peak of each cut; the sum
        of the cuts against the whole forward's `timed` on the same
        images (and each of the two by the other method), and the last
        cut's net against `PoseNet.forward`;
    (c) `chain_ms` against `timed` and `device_busy` on the main path's
        batch-8 `PoseInference` call;
    (d) `scripts/profile_train_step` at 368x368, batch 8, float32, beside
        the train phase's own `device_step_probe` figure;
    (e) `scripts/analyze_scaling` on a one-rank world (NCCL on the card):
        no collective in inference."""
    import importlib
    import numpy as np
    import torch
    from openpose_tpu_torch.ops import paf, paf_cuda, resize
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.utils.benchmark import chain_ms, fold
    scripts = {name: importlib.import_module(
        f"openpose_tpu_torch.scripts.{name}") for name in (
        "speed_test", "profile_net", "profile_train_step", "analyze_scaling")}
    net_resolution, batch, train_size, chain = (
        ("96x64", 2, "32x32", (1, 2, 1)) if rehearse
        else ("656x368", 8, "368x368", (2, 22, 3)))
    t_phase = time.perf_counter()
    out = {}
    reset_launches()
    cpu = ["--cpu"] if device.type == "cpu" else []

    # (a) the main path stage by stage
    res = scripts["speed_test"].main(
        cpu + ["--net_resolution", net_resolution], device=device)
    o = res["outputs"]
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf.pair_tables(model.info))
    plain = paf.paf_scores_multiscale_reference(
        [o["net"]], [1.0], tuple(o["image"].shape[1:3]), o["peaks"], pairs,
        map_idx, 0.05, 0.95, 0.05)
    paf_stage = "paf scores (multiscale)"
    a = {"ms": res["ms"], "launches": res["launches"],
         "shapes": {k: list(v.shape) for k, v in o.items()},
         "peaks_per_part_mean": float(o["peaks"][:, :, 0, 0].mean()),
         "paf_max_abs_err": float((o["scores"] - plain).abs().max()),
         "paf_bit_equal": bool(torch.equal(o["scores"], plain)),
         "seconds": time.perf_counter() - t_phase}
    out["speed_test"] = a
    log("timing (a) speed_test: " + json.dumps(a))
    assert all(bool(torch.isfinite(v).all()) for v in o.values()), a
    assert a["paf_max_abs_err"] <= KERNEL_TOL, a
    if device.type == "cuda":
        assert a["launches"][paf_stage]["paf_scores_fused"] == 1, a

    # (b) the CNN cut by cut against the whole forward
    rows = scripts["profile_net"].main(
        cpu + ["--batch", str(batch), "--net_resolution", net_resolution],
        device=device, chain=chain)
    w, h = (int(v) for v in net_resolution.split("x"))
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 255, (batch, h, w, 3)).astype(np.float32)).to(device)
    last_net = scripts["profile_net"].prefix_net(model, rows[-1]["cut"])
    with torch.inference_mode():
        x = resize.normalize_vgg(images)
        whole = model.forward(x, torch.bfloat16)
        last = last_net(x, torch.bfloat16)
        forward_ms = timed(lambda: model.forward(x, torch.bfloat16), 2, 10,
                           device)
        last_cut_ms = timed(lambda: last_net(x, torch.bfloat16), 2, 10,
                            device)

    def whole_step(carry):
        with torch.inference_mode():
            return fold(carry, model.forward(
                resize.normalize_vgg(images + carry * 1e-12), torch.bfloat16))
    cuts_ms = sum(r["ms_per_frame"] for r in rows)
    b = {"rows": rows, "sum_of_cuts_ms_per_frame": cuts_ms,
         "whole_forward_timed_ms_per_frame": forward_ms / batch,
         "sum_over_whole": cuts_ms / (forward_ms / batch),
         # the same two calls by the other method each, to tell the
         # methods' difference from the nets'
         "last_cut_timed_ms_per_frame": last_cut_ms / batch,
         "whole_forward_chain_ms_per_frame": chain_ms(
             whole_step, *chain, device=device) / batch,
         "last_cut_max_abs_diff": float((last - whole).abs().max()),
         "whole_range": float(whole.max() - whole.min()),
         "seconds": time.perf_counter() - t_phase}
    out["profile_net"] = b
    log("timing (b) profile_net: sum of the cuts "
        f"{cuts_ms:.3f} ms a frame against the whole forward's timed "
        f"{forward_ms / batch:.3f} ms a frame (x{b['sum_over_whole']:.3f}); "
        f"the last cut timed {b['last_cut_timed_ms_per_frame']:.3f}, the "
        f"whole forward chained {b['whole_forward_chain_ms_per_frame']:.3f}"
        f" ms a frame; last cut against PoseNet.forward: "
        f"{b['last_cut_max_abs_diff']}")
    assert len(rows) == len(scripts["profile_net"].cut_names(model.spec))
    assert all(np.isfinite(r["ms_per_frame"]) for r in rows), rows
    assert b["last_cut_max_abs_diff"] <= 1e-3 * b["whole_range"], b

    # (c) the chained method against CUDA events and the profiler on the
    # main path's batch-8 call
    inference = PoseInference(model, net_hw=(h, w), device=device)
    frames = torch.from_numpy(scene_frames(
        np.random.RandomState(0), batch, (h, w))).to(device).to(torch.float32)
    c = {"chain_ms": chain_ms(
             lambda carry: fold(carry, *inference(frames + carry * 1e-12)),
             *chain, device=device),
         "timed_ms": timed(lambda: inference(frames), 2, 10, device),
         "trace": device_busy(lambda: inference(frames), 3)
         if device.type == "cuda" else None}
    c["chain_over_timed"] = c["chain_ms"] / c["timed_ms"]
    c["seconds"] = time.perf_counter() - t_phase
    out["chain"] = c
    log("timing (c) main path batch 8: " + json.dumps(c))
    assert c["chain_ms"] > 0 and np.isfinite(c["chain_ms"]), c

    # (d) the train step alone, beside the train phase's figure
    d = scripts["profile_train_step"].main(
        cpu + ["--image_size", train_size, "--batch", str(batch)],
        device=device)
    d["train_phase_device_step_ms"] = train_step_ms
    d["seconds"] = time.perf_counter() - t_phase
    out["profile_train_step"] = d
    log("timing (d) profile_train_step: " + json.dumps(d))
    assert np.isfinite(d["device_step_ms"]) and d["device_step_ms"] > 0, d

    # (e) the collectives of a one-rank world
    e = scripts["analyze_scaling"].main(cpu + ["--ranks", "1"])
    out["analyze_scaling"] = e
    log("timing (e) analyze_scaling: " + json.dumps(e))
    assert e["inference"]["collectives"] == {}, e

    out["launches"] = read_launches("timing path", paf_cuda.paf_scores_fused)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"timing phase: {out['seconds']:.1f} s")
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
    if sys.argv[1:] == ["--mesh-scaling"]:
        mesh_scaling()
        return 0
    if sys.argv[1:] == ["--graphs"]:
        log(json.dumps({"graphs": graph_phase(device, model)}))
        return 0
    if sys.argv[1:] == ["--epilogue"]:
        log(json.dumps({"epilogue": epilogue_phase(device)}))
        return 0
    if sys.argv[1:] == ["--nms"]:
        log(json.dumps({"nms": nms_phase(device)}))
        return 0
    report["kernel"] = kernel_phase(device, model.info)
    report["sampler"] = sampler_phase(device)
    report["main_path"] = main_path_phase(device, model)
    report["graphs"] = graph_phase(device, model)
    report["people_capped"] = people_capped_phase(device, model)
    report["whole_body"] = whole_body_phase(device, model)
    report["injection"] = injection_phase(device, model)
    report["wrapper"] = wrapper_phase(device)
    report["runner"] = runner_phase(device, model)
    report["accuracy"] = accuracy_phase(device, model)
    report["train"] = train_phase(device)
    try:
        report["cli"] = cli_phase(device, report["train"]["checkpoint"])
        report["tools"] = tools_phase(device, report["train"]["checkpoint"],
                                      model)
    finally:
        shutil.rmtree(pathlib.Path(report["train"]["checkpoint"]).parent,
                      ignore_errors=True)
    with one_rank_group(device):       # one NCCL group for both phases
        report["mesh"] = mesh_phase(device, model)
        report["threed"] = threed_phase(device)
    report["timing"] = timing_phase(
        device, model, report["train"]["f32"]["device_step_ms"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    kernel, sampler = report["kernel"], report["sampler"]
    epilogue = kernel["epilogue"]
    nms_rows = kernel["nms"]["timed"]
    nms_row = next(r for r in nms_rows if r["model"] == "BODY_25"
                   and r["scene"] == "noise" and r["shape"][0] == 8)
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
                                      "runner", "accuracy", "train", "cli",
                                      "tools", "mesh", "timing")),
        "max_abs_err": max(kernel["max_abs_err"], report["main_path"][
            "breakdown"]["paf_main_path_max_abs_err"], report["accuracy"][
            "kernel_on_loop_batch"]["max_abs_err"], report["train"][
            "kernel_on_trained_frame"]["max_abs_err"], report["tools"][
            "kernel_on_tutorial_09"]["max_abs_err"], report["timing"][
            "speed_test"]["paf_max_abs_err"]),
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound"]["bound_ms"],
        "bound_by": kernel["bound"]["bound_by"], "library_ms": None}, {
        "name": "sample_bicubic_kernel", "route": "cuda", "source": source,
        "replaces": "openpose_tpu/ops/paf_pallas.py:335",
        "launches": sum(report[phase]["launches"]["sample_bicubic_scales"]
                        for phase in ("people_capped", "mesh")),
        "max_abs_err": max(sampler["max_abs_err"], report["people_capped"][
            "sampler_on_path"]["max_abs_err"]),
        "ms": sampler["ms"], "plain_ms": sampler["plain_ms"],
        "bound_ms": sampler["bound"]["bound_ms"],
        "bound_by": sampler["bound"]["bound_by"], "library_ms": None}, {
        # no TPU kernel: XLA fuses the bias and activation into the
        # convolution; timed at conv1_2's 8 x 64 x 368 x 656 output; the
        # epilogue phase holds it to its plain version on the nets'
        # convolution outputs and a trainer's forward and gradients
        "name": "conv_epilogue_kernel", "route": "cuda",
        "source": "openpose_tpu_torch/kernels/conv_epilogue.cu",
        "replaces": None,
        "launches": sum(report[phase]["launches"]["bias_act"]
                        for phase in ("main_path", "people_capped",
                                      "whole_body", "wrapper", "runner",
                                      "accuracy", "train", "cli", "tools",
                                      "mesh", "threed", "timing")),
        "max_abs_err": max(epilogue["path_max_abs_err"],
                           epilogue["train"]["max_abs_err"]),
        "ms": epilogue["timed"][0]["ms"],
        "plain_ms": epilogue["timed"][0]["plain_ms"],
        "bound_ms": epilogue["timed"][0]["bound_ms"],
        "bound_by": epilogue["timed"][0]["bound_by"], "library_ms": None}, {
        # no TPU kernel: the JAX package's NMS is plain jnp; a call runs
        # nms_count_kernel, nms_place_kernel and nms_refine_kernel; timed
        # replayed in a graph on BODY_25's noise maps at batch 8, 368x656
        "name": "nms_kernels", "route": "cuda",
        "source": "openpose_tpu_torch/kernels/nms.cu", "replaces": None,
        "launches": sum(report[phase]["launches"]["nms"]
                        for phase in ("main_path", "people_capped",
                                      "whole_body", "wrapper", "runner",
                                      "accuracy", "train", "cli", "tools",
                                      "mesh", "threed", "timing")),
        "max_abs_err": 0.0 if all(r["bit_equal"] for r in nms_rows)
        else None,
        "ms": nms_row["graph_ms"], "plain_ms": nms_row["plain_graph_ms"],
        "bound_ms": nms_row["bound_ms"], "bound_by": nms_row["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
