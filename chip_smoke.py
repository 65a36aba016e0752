#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`openpose_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, `nvcc` (CUDA_HOME or /usr/local/cuda) and the
repository; it imports nothing of JAX.  Phases, each of which ends the run
with a non-zero exit when it fails:

1. device: the card's name and power limit;
2. build: compiles `openpose_tpu_torch/kernels/*.cu` for sm_90a;
3. kernel: the PAF scoring kernel against its plain PyTorch version, both
   on the card, on small scenes and at the full BODY_25 shape (batch 8, 26
   pairs, K = 127, 46x82 low-res maps); both timed with CUDA events;
4. main path: BODY_25 (seeded random weights) through `PoseExtractor` on
   720x1280 frames at net resolution 368x656 in float32 and bfloat16, and
   through batch-8 `PoseInference`, timed; the PAF kernel's launch count in
   this phase must be > 0; a per-stage breakdown and a CPU-vs-GPU check of
   the CNN follow;
5. injection: a synthetic BODY_25 net output with known people goes
   through `PoseExtractor.forward(net_output=...)` and must assemble exactly
   those people, written out as people JSON.

The line before the last is the kernel summary, the last line
{"ok": true, "device": {...}}.  Details go to build/chip_smoke/chip_smoke.json.
"""

from __future__ import annotations

import json
import pathlib
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
    got, want, _ = both([src, src2], [1.0, 0.73], hw, peaks, pairs3, map3,
                        (0.05, 0.5, 0.05))
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    log(f"kernel case two_scales: max_abs_err={err} tol={KERNEL_TOL}")
    assert err <= KERNEL_TOL, "two_scales"

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
    log(f"kernel time body25_full: kernel_ms={ms} plain_ms={plain_ms}")

    # 4-scale 1312x736: the two largest scales exceed the kernel's shared
    # memory budget and are read through the cache instead
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
    log(f"kernel case four_scales {tuple(got.shape)}: max_abs_err={err} "
        f"tol={KERNEL_TOL}; kernel_ms={ms4} plain_ms={plain_ms4}")
    assert err <= KERNEL_TOL, "four_scales"
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "full_shape_mismatches": mismatches,
            "four_scales_ms": ms4, "four_scales_plain_ms": plain_ms4}


def scene_frames(rng, count, frame_hw, n_people=3):
    import numpy as np
    from openpose_tpu_torch import synthetic
    height = (0.45 * frame_hw[0], 0.85 * frame_hw[0])
    return np.stack([synthetic.render_scene_image(
        synthetic.random_people(rng, n_people, frame_hw, height_range=height),
        frame_hw, rng) for _ in range(count)])


def main_path_phase(device, model, frame_hw=(720, 1280), net_h=368, batch=8,
                    iters=10):
    """PoseExtractor (f32 and bf16) and batched PoseInference on BODY_25."""
    import numpy as np
    import torch
    from openpose_tpu_torch.ops import paf_cuda
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.pose.extractor import PoseExtractor

    rng = np.random.RandomState(0)
    frames = scene_frames(rng, 3, frame_hw)
    res = {}
    paf_cuda.paf_scores_fused.launches = 0
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
    launches = paf_cuda.paf_scores_fused.launches
    log(f"main path PAF kernel launches: {launches}")
    assert launches > 0, "the main path did not launch the PAF kernel"
    res["launches"] = launches
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
        out["peaks_per_part_mean"] = float(peaks[:, :, 0, 0].mean())
    log("stage breakdown at batch 8 (ms): " + json.dumps(out))
    assert out["paf_main_path_max_abs_err"] <= KERNEL_TOL
    return out


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
    report["kernel"] = kernel_phase(device, model.info)
    report["main_path"] = main_path_phase(device, model)
    report["injection"] = injection_phase(device, model)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    kernel = report["kernel"]
    log(json.dumps({"kernels": [{
        "name": "paf_score_kernel", "route": "cuda",
        "source": "openpose_tpu_torch/kernels/paf_score.cu",
        "replaces": "openpose_tpu/ops/paf_pallas.py:286",
        "launches": report["main_path"]["launches"],
        "max_abs_err": max(kernel["max_abs_err"], report["main_path"][
            "breakdown"]["paf_main_path_max_abs_err"]),
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
