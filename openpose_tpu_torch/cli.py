"""Command-line demo: the reference `openpose.bin` flag surface
(include/openpose/flags.hpp, examples/openpose/openpose.cpp) on the port.

Counterpart of `openpose_tpu/cli.py`: the same flags and defaults and the
same host code, over the port's `Wrapper`, `PoseInference`,
`WholeBodyInference` and `VideoRunner` on one CUDA device (the card unless
`main` is given another `device`; `--num_gpu_start k` picks `cuda:k`).
On the batched path `--num_gpu N` above 1 starts N processes, one per card
from `--num_gpu_start` (or N gloo ranks on the CPU when `main` is given
`device="cpu"`), each on its own rows of every batch.

Example:
    python -m openpose_tpu_torch.cli --image_dir /path/imgs --write_json out/ \
        --model_pose BODY_25 --net_resolution -1x368
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="openpose_tpu_torch",
        description="OpenPose on PyTorch and CUDA: multi-person 2D/3D "
                    "keypoints")
    # Input (flags.hpp producer section)
    p.add_argument("--image_dir", default="")
    p.add_argument("--video", default="")
    p.add_argument("--camera", type=int, default=-1)
    p.add_argument("--camera_resolution", default="-1x-1",
                   help="webcam capture resolution")
    p.add_argument("--ip_camera", default="")
    p.add_argument("--flir_camera", action="store_true",
                   help="unsupported (Spinnaker SDK); errors with guidance")
    p.add_argument("--flir_camera_index", type=int, default=-1,
                   help="unsupported (Spinnaker SDK, flags.hpp:46)")
    p.add_argument("--num_gpu", type=int, default=-1,
                   help="number of GPUs (flags.hpp num_gpu): on the batched "
                        "path N > 1 starts N processes, one per GPU from "
                        "--num_gpu_start, each on its own rows of every "
                        "batch; other paths, and -1, use one GPU")
    p.add_argument("--num_gpu_start", type=int, default=0,
                   help="first device index (flags.hpp num_gpu_start)")
    p.add_argument("--frame_first", type=int, default=0)
    p.add_argument("--frame_step", type=int, default=1)
    p.add_argument("--frame_last", type=int, default=-1)
    p.add_argument("--frames_repeat", action="store_true",
                   help="loop the input source when it ends")
    p.add_argument("--process_real_time", action="store_true",
                   help="pace processing at the source frame rate")
    p.add_argument("--frame_flip", action="store_true")
    p.add_argument("--frame_rotate", type=int, default=0)
    p.add_argument("--num_views", type=int, default=1,
                   help="split horizontally-stacked multi-camera frames")
    p.add_argument("--camera_parameter_path", default="")
    p.add_argument("--frame_undistort", action="store_true")
    # Pose
    p.add_argument("--body", type=int, default=1)
    p.add_argument("--model_pose", default="BODY_25",
                   help="BODY_25/COCO_18/MPI_15/MPI_15_4; the reference's "
                        "experimental names (BODY_19*, BODY_25B/D/E, "
                        "BODY_23, BODY_135, CAR_*) are recognized but "
                        "error with guidance (no published weights)")
    p.add_argument("--net_resolution", default="-1x368")
    p.add_argument("--net_resolution_dynamic", type=float, default=1.0,
                   help="image inputs only: clip the -1 auto width to this "
                        "ratio x 656 (flags.hpp net_resolution_dynamic)")
    p.add_argument("--scale_number", type=int, default=1)
    p.add_argument("--scale_gap", type=float, default=0.25)
    p.add_argument("--upsampling_ratio", type=float, default=0.0,
                   help="heatmap upsample ratio vs net output; <=0 = net "
                        "default (8x to net input resolution)")
    p.add_argument("--number_people_max", type=int, default=-1)
    p.add_argument("--maximize_positives", action="store_true")
    p.add_argument("--model_folder", default="",
                   help="reference-layout models/ dir with .caffemodel files")
    p.add_argument("--prototxt_path", default="",
                   help="custom Caffe deploy prototxt for the pose topology")
    p.add_argument("--caffemodel_path", default="",
                   help="original .caffemodel to convert and use")
    p.add_argument("--fp32", action="store_true",
                   help="float32 compute (default bfloat16)")
    p.add_argument("--disable_multi_thread", action="store_true",
                   help="parity flag: the CLI demo already runs the pipeline "
                        "synchronously on one thread")
    # Face / hand
    p.add_argument("--face", action="store_true")
    p.add_argument("--face_detector", type=int, default=0,
                   help="0=body geometry, 1=OpenCV Haar cascade, "
                        "2=user-provided rectangles (flags.hpp:143)")
    p.add_argument("--face_caffemodel_path", default="")
    p.add_argument("--face_net_resolution", default="368x368")
    p.add_argument("--face_render_threshold", type=float, default=0.4)
    p.add_argument("--face_render", type=int, default=-1,
                   help="-1=follow --render_pose, 0=no face rendering")
    p.add_argument("--face_alpha_pose", type=float, default=0.6)
    p.add_argument("--face_alpha_heatmap", type=float, default=0.7)
    p.add_argument("--hand", action="store_true")
    p.add_argument("--hand_detector", type=int, default=0,
                   help="0=body geometry, 2=user-provided rectangles, "
                        "3=body geometry + inter-frame tracking")
    p.add_argument("--hand_caffemodel_path", default="")
    p.add_argument("--hand_net_resolution", default="368x368")
    p.add_argument("--hand_render_threshold", type=float, default=0.2)
    p.add_argument("--hand_render", type=int, default=-1,
                   help="-1=follow --render_pose, 0=no hand rendering")
    p.add_argument("--hand_alpha_pose", type=float, default=0.6)
    p.add_argument("--hand_alpha_heatmap", type=float, default=0.7)
    p.add_argument("--hand_scale_number", type=int, default=1)
    p.add_argument("--hand_scale_range", type=float, default=0.4)
    # Tracking
    p.add_argument("--tracking", type=int, default=-1)
    p.add_argument("--identification", action="store_true")
    p.add_argument("--smooth_keyframes", type=int, default=0,
                   help="pose-graph smoothing over a sliding window of this "
                        "many keyframes (>= 3): denoises trajectories and "
                        "inpaints missing detections; adds window//2 frames "
                        "of output latency (0 = off)")
    p.add_argument("--smooth_lambda", type=float, default=4.0,
                   help="acceleration-penalty weight of --smooth_keyframes")
    p.add_argument("--top_down_refinement", action="store_true",
                   help="re-run the net on each detected person's ROI and "
                        "replace keypoints when the refined candidate "
                        "matches (the reference's experimental compile-time "
                        "TOP_DOWN_REFINEMENT, poseExtractorCaffe.cpp:340)")
    # 3D
    p.add_argument("--threed", "--3d", dest="threed", action="store_true")
    p.add_argument("--threed_min_views", "--3d_min_views",
                   dest="threed_min_views", type=int, default=-1)
    p.add_argument("--threed_views", "--3d_views", dest="threed_views",
                   type=int, default=-1,
                   help="images per iteration for --image_dir/--video "
                        "multi-view input (flags.hpp 3d_views; alias of "
                        "--num_views)")
    # Output
    p.add_argument("--keypoint_scale", type=int, default=0,
                   help="0=input res, 1=net output res, 2=output res, "
                        "3=[0,1], 4=[-1,1] (flags.hpp keypoint_scale)")
    p.add_argument("--write_keypoint", default="",
                   help="directory for OpenCV-FileStorage keypoint files")
    p.add_argument("--write_keypoint_format", default="json",
                   choices=["json", "xml", "yml"])
    p.add_argument("--fps_max", type=float, default=-1.0,
                   help="cap processing rate (WFpsMax equivalent)")
    p.add_argument("--write_json", default="")
    p.add_argument("--write_images", default="")
    p.add_argument("--write_images_format", default="png",
                   help="png / jpg / bmp ... (write_images_format)")
    p.add_argument("--write_video", default="")
    p.add_argument("--write_video_fps", type=float, default=-1.0)
    p.add_argument("--write_video_with_audio", action="store_true",
                   help="remux the source audio track into --write_video")
    p.add_argument("--write_bvh", default="",
                   help="export the triangulated 3-D skeleton as a BVH "
                        "animation (rig derived from keypoints; the reference "
                        "instead requires the Adam model)")
    p.add_argument("--write_video_adam", default="",
                   help="unsupported: requires the Adam model (see "
                        "--write_bvh)")
    p.add_argument("--write_coco_json", default="")
    p.add_argument("--write_coco_json_variants", type=int, default=1,
                   help="bitmask: 1=body 2=foot 4=face 8=hand21 16=hand42; "
                        "<1 = all (flags.hpp write_coco_json_variants)")
    p.add_argument("--write_coco_json_variant", type=int, default=0,
                   help="unsupported: car-JSON-only in the reference too "
                        "(flags.hpp:262; car models are out of scope)")
    p.add_argument("--ik_threads", type=int, default=0,
                   help="unsupported: Adam IK ('not available yet' in the "
                        "reference either, flags.hpp:183)")
    p.add_argument("--part_candidates", action="store_true",
                   help="add all NMS part candidates to the people JSON")
    p.add_argument("--write_heatmaps", default="")
    p.add_argument("--write_heatmaps_format", default="float",
                   help="float (raw binary) or png tiles")
    p.add_argument("--heatmaps_add_parts", action="store_true")
    p.add_argument("--heatmaps_add_bkg", action="store_true")
    p.add_argument("--heatmaps_add_PAFs", action="store_true")
    p.add_argument("--heatmaps_scale", type=int, default=2,
                   help="0=[-1,1] floats, 1=[0,1] floats, 2=raw (flags.hpp)")
    p.add_argument("--udp_host", default="")
    p.add_argument("--udp_port", type=int, default=8051)
    p.add_argument("--render_pose", type=int, default=1)
    p.add_argument("--render_threshold", type=float, default=0.05)
    p.add_argument("--alpha_pose", type=float, default=0.6,
                   help="skeleton/original blending factor (flags.hpp)")
    p.add_argument("--alpha_heatmap", type=float, default=0.7,
                   help="heatmap/original blending factor (flags.hpp)")
    p.add_argument("--disable_blending", action="store_true",
                   help="render on black background instead of the frame")
    p.add_argument("--output_resolution", default="-1x-1",
                   help="final output frame size; -1x-1 = input size")
    p.add_argument("--part_to_show", type=int, default=0,
                   help="0=skeletons, 1..#parts=that part heatmap, "
                        "-1=all-part heatmap, -2=PAF field")
    p.add_argument("--show_info", action="store_true",
                   help="burn FPS/frame/people info into output frames")
    p.add_argument("--write_video_3d", default="",
                   help="render triangulated skeletons to a 3D video")
    p.add_argument("--display", type=int, default=0,
                   help="2 = OpenCV window; 3 = 2D window + live 3-D "
                        "viewer with mouse rotation (reference Gui3D); "
                        "0 = headless")
    p.add_argument("--fullscreen", action="store_true",
                   help="start the GUI window fullscreen")
    p.add_argument("--no_gui_verbose", action="store_true",
                   help="do not burn the FPS/frame info text into GUI frames")
    p.add_argument("--cli_verbose", type=float, default=-1)
    p.add_argument("--logging_level", type=int, default=3,
                   help="0 logs every op_log() message .. 4 only important, "
                        "255 none (flags.hpp:19)")
    p.add_argument("--profile_speed", type=int, default=-1,
                   help="print averaged per-stage ms every N frames "
                        "(reference Profiler, --profile_speed); on the "
                        "batched path the host time of each span and the "
                        "counters' totals: the device's time shows in "
                        "pose.fetch.wait and topdown.fetch")
    p.add_argument("--max_frames", type=int, default=-1,
                   help="stop after N frames (benchmark/debug)")
    p.add_argument("--batch", type=int, default=0,
                   help="frames per device batch for the high-throughput "
                        "path (0 = auto: 8 when eligible). The batched "
                        "pipeline (native decode pool -> one batched "
                        "device call -> threaded assembly) engages for "
                        "--image_dir/--video runs that only need keypoint "
                        "outputs; 1 forces the synchronous per-frame path")
    return p


def parse_resolution(text: str):
    w, h = text.lower().split("x")
    return (int(w), int(h))


def fast_path_eligible(args) -> bool:
    """True when the batched pipeline can serve this invocation.

    The high-throughput path (NativeFramePump -> PoseInference ->
    threaded assembly, openpose_tpu_torch/runtime/video_runner.py) covers
    keypoint extraction from files, including multi-scale and — for video
    input — the batched whole-body cascade (WholeBodyInference); anything
    needing per-frame host frames (rendering, GUI), non-default detectors,
    or real-time pacing falls back to the synchronous per-frame loop.
    """
    if args.batch == 1:
        return False
    if not (args.image_dir or args.video):
        return False
    if (args.write_images or args.write_video or args.display
            or args.part_to_show != 0 or args.show_info
            or args.write_heatmaps or args.write_video_3d or args.write_bvh):
        return False
    if (args.threed or args.tracking >= 0
            or getattr(args, "top_down_refinement", False)
            or args.identification or args.part_candidates
            or args.num_views > 1 or args.frames_repeat
            or args.process_real_time or args.fps_max > 0
            or args.frame_flip
            or args.frame_rotate or args.frame_undistort
            or args.keypoint_scale != 0 or args.udp_host
            or not args.body):
        return False
    # face/hand: the batched whole-body cascade needs raw frames, which
    # only the video pump provides; non-default detectors stay per-frame
    if (args.face or args.hand) and (
            not args.video or args.face_detector != 0
            or args.hand_detector != 0 or args.hand_scale_number > 1):
        return False
    if args.video and args.frame_first > 0:
        return False
    from openpose_tpu_torch.io.native_loader import available
    return available()


def _cli_device(args, device=None):
    """--num_gpu_start -> the device of a one-device run (flags.hpp:69-71).
    `device`, a caller's keyword, wins; else --num_gpu_start k picks cuda:k;
    else None (the card, `device.resolve`)."""
    if device is not None:
        return torch.device(device)
    if args.num_gpu_start == 0:
        return None
    count = torch.cuda.device_count()
    if args.num_gpu_start >= count:
        raise SystemExit(
            f"--num_gpu_start {args.num_gpu_start}: only {count} CUDA "
            "devices available")
    return torch.device("cuda", args.num_gpu_start)


def _rank_devices(args, device=None):
    """--num_gpu N > 1 -> the device of each rank (the counterpart of the
    original's `_cli_mesh`): cards --num_gpu_start .. +N-1, or N CPU ranks
    when the caller's `device` is the CPU."""
    n, start = args.num_gpu, args.num_gpu_start
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if start + n > count:
        raise SystemExit(f"--num_gpu {n} --num_gpu_start {start}: only "
                         f"{count} CUDA devices available")
    return [torch.device("cuda", start + r) for r in range(n)]


def run_ranks(args, devices) -> int:
    """The batched path over one rank per device: started by
    `torch.multiprocessing` (spawn), meeting through a file store in a
    temporary folder (no address), each running `run_fast_path` over a data
    mesh of all ranks.  Returns 0 when every rank ended well; when one
    fails, the others are stopped and the result is 1."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="openpose_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(args, devices, os.path.join(tmp, "init")),
            nprocs=len(devices), join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            print(f"openpose_tpu_torch: {e}", file=sys.stderr)
            return 1
    return 0


def _rank_main(rank, args, devices, init_file):
    """One rank of `run_ranks`: NCCL on its card, or gloo on the CPU, where
    the ranks share the host's cores."""
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    if devices[rank].type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    with mesh_lib.process_group(init_file, len(devices), rank,
                                devices[rank]) as device:
        run_fast_path(args, device,
                      mesh_lib.make_mesh(device_type=device.type))


def run_fast_path(args, device=None, mesh=None) -> int:
    """Batched disk -> JSON pipeline: the reference's worker graph
    (configureThreadManager, wrapperAuxiliary.hpp:991-1217) as batched
    device calls on one GPU fed by the C++ decode pool.

    mesh: a data mesh of `run_ranks`' ranks; this rank then processes its
    own rows of each global batch (the batch rounded up to tile the mesh)
    and writes its own frames' JSON and keypoint files, and rank 0 writes
    the COCO file of every frame, in frame order.  With --smooth_keyframes
    every rank hands its frames to rank 0 at the end, which smooths them
    all in frame order and writes every frame's files."""
    import pathlib as _pathlib

    import torch.distributed as dist

    from openpose_tpu_torch.io import json_io, producers, savers
    from openpose_tpu_torch.models import zoo
    from openpose_tpu_torch.params import PoseModel, default_connect_params
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.runtime.video_runner import VideoRunner

    batch = args.batch if args.batch > 1 else 8
    net_w, net_h = parse_resolution(args.net_resolution)
    if net_w <= 0:
        # default -1x368 -> the reference's 656x368 headline geometry;
        # otherwise scale the width by the same 16:9-ish ratio, x16 aligned
        net_w = int(round(net_h * 656.0 / 368.0 / 16.0)) * 16
    if mesh is not None:
        # the batch must tile the mesh's data dimension
        dp = mesh.size()
        batch = -(-batch // dp) * dp
    lead = mesh is None or dist.get_rank() == 0

    device = device_rule.resolve(device)
    model = zoo.load_pose_model(
        PoseModel(args.model_pose), device=device,
        caffemodel=args.caffemodel_path or None,
        model_folder=args.model_folder or None,
        prototxt=args.prototxt_path or None)
    cp = default_connect_params(PoseModel(args.model_pose),
                                args.maximize_positives)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    whole_body = args.face or args.hand
    if whole_body:
        # batched whole-body cascade on raw frames (runtime/whole_body.py)
        import cv2
        from openpose_tpu_torch.runtime.whole_body import WholeBodyInference
        cap = cv2.VideoCapture(args.video)
        fw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        fh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        cap.release()
        if fw <= 0 or fh <= 0:
            raise SystemExit(f"cannot open video: {args.video}")
        people_cap = args.number_people_max if args.number_people_max > 0 \
            else 8
        wb = WholeBodyInference(
            model,
            zoo.load_face_model(device=device,
                                model_folder=args.model_folder or None)
            if args.face else None,
            zoo.load_hand_model(device=device,
                                model_folder=args.model_folder or None)
            if args.hand else None,
            device=device, frame_hw=(fh, fw), net_hw=(net_h, net_w),
            people_cap=people_cap,
            scale_number=args.scale_number, scale_gap=args.scale_gap,
            face_net_size=parse_resolution(args.face_net_resolution)[1],
            hand_net_size=parse_resolution(args.hand_net_resolution)[1],
            compute_dtype=dtype, mesh=mesh,
            nms_threshold=cp.nms_threshold,
            inter_threshold=cp.inter_threshold,
            inter_min_above_threshold=cp.inter_min_above_threshold)
        runner = None
    else:
        inference = PoseInference(
            model, device=device, net_hw=(net_h, net_w),
            scale_number=args.scale_number, scale_gap=args.scale_gap,
            nms_threshold=cp.nms_threshold,
            inter_threshold=cp.inter_threshold,
            inter_min_above_threshold=cp.inter_min_above_threshold,
            compute_dtype=dtype, mesh=mesh,
            maximize_positives=args.maximize_positives)
        runner = VideoRunner(inference, batch_size=batch)

    json_dir = _pathlib.Path(args.write_json) if args.write_json else None
    if json_dir:
        json_dir.mkdir(parents=True, exist_ok=True)
    keypoint_saver = savers.KeypointSaver(
        args.write_keypoint, args.write_keypoint_format) \
        if args.write_keypoint else None
    coco_saver = json_io.CocoJsonSaver(args.write_coco_json_variants) \
        if args.write_coco_json else None
    # (frame, args, kwargs) of each COCO record, written in frame order at
    # the end (over a mesh, by rank 0 for every rank)
    coco_rows = []

    def coco_record(index, *record_args, **record_kwargs):
        coco_rows.append((index, record_args, record_kwargs))

    names = {}

    def emit_result(index, kp, sc):
        nmax = args.number_people_max
        if nmax > 0 and kp.shape[0] > nmax:
            order = np.argsort(-sc)[:nmax]          # KeepTopNPeople
            kp, sc = kp[order], sc[order]
        name = names.get(index, f"{index:012d}")
        if json_dir is not None:
            json_io.save_people_json(
                str(json_dir / f"{name}_keypoints.json"), pose_keypoints=kp)
        if keypoint_saver is not None:
            keypoint_saver.save([kp], name, "pose")
        if coco_saver is not None and kp.size:
            coco_record(index, kp, sc, json_io.image_id_from_name(name),
                        frame_number=index)
        if args.cli_verbose > 0 \
                and (index + 1) % max(int(args.cli_verbose), 1) == 0:
            print(f"Processed {index + 1} frames")

    smoother = None
    if args.smooth_keyframes > 0:
        from openpose_tpu_torch.tracking.pose_graph import KeyframeSmoother
        smoother = KeyframeSmoother(window=args.smooth_keyframes,
                                    smoothness=args.smooth_lambda,
                                    device=device)

    # over a mesh with the smoother: this rank's (frame, keypoints, scores),
    # smoothed by rank 0 after the run, since the window needs every frame
    raw_rows = []

    def on_result(res):
        if report is not None:
            report.frame()
        # results arrive in frame order (VideoRunner resolves in submission
        # order), which the sliding-window smoother relies on
        if smoother is None:
            emit_result(res.index, res.keypoints, res.scores)
        elif mesh is not None:
            raw_rows.append((res.index, res.keypoints, res.scores))
        else:
            for idx, kp, sc in smoother.push(res.index, res.keypoints,
                                             res.scores):
                emit_result(idx, kp, sc)

    # --profile_speed N: the inference layers' spans, averaged every N
    # frames (utils/profiler.py::TRACE)
    report = None
    if args.profile_speed > 0:
        from openpose_tpu_torch.utils.profiler import SpanReport
        report = SpanReport(args.profile_speed, "" if mesh is None
                            else f"[rank {dist.get_rank()}] ")
    t0 = time.time()
    try:
        if whole_body:
            names = _NameByIndex(_pathlib.Path(args.video).stem)

            def on_wb(idx, res):
                if report is not None:
                    report.frame()
                name = names.get(idx)
                if json_dir is not None:
                    json_io.save_people_json(
                        str(json_dir / f"{name}_keypoints.json"),
                        pose_keypoints=res.pose_keypoints,
                        face_keypoints=res.face_keypoints,
                        hand_left_keypoints=res.hand_left_keypoints,
                        hand_right_keypoints=res.hand_right_keypoints)
                if keypoint_saver is not None:
                    keypoint_saver.save([res.pose_keypoints], name, "pose")
                if coco_saver is not None and res.pose_keypoints.size:
                    coco_record(
                        idx, res.pose_keypoints, res.pose_scores,
                        json_io.image_id_from_name(name),
                        face_keypoints=res.face_keypoints,
                        hand_left_keypoints=res.hand_left_keypoints,
                        hand_right_keypoints=res.hand_right_keypoints,
                        frame_number=idx)
                if args.cli_verbose > 0 \
                        and (idx + 1) % max(int(args.cli_verbose), 1) == 0:
                    print(f"Processed {idx + 1} frames")

            results = VideoRunner.run_video_whole_body(
                wb, args.video, frame_step=args.frame_step, on_result=on_wb,
                max_frames=args.max_frames, batch_size=batch)
        elif args.image_dir:
            paths = sorted(
                p for p in _pathlib.Path(args.image_dir).iterdir()
                if p.suffix.lower() in producers.IMAGE_EXTENSIONS)
            last = args.frame_last if args.frame_last >= 0 \
                else len(paths) - 1
            paths = paths[args.frame_first:last + 1:args.frame_step]
            if args.max_frames >= 0:
                paths = paths[:args.max_frames]
            names.update({i: p.stem for i, p in enumerate(paths)})
            results = runner.run_files([str(p) for p in paths],
                                       on_result=on_result)
        else:
            stem = _pathlib.Path(args.video).stem
            names = _NameByIndex(stem)
            results = runner.run_video(
                args.video, frame_step=args.frame_step,
                max_frames=args.max_frames, on_result=on_result)
    finally:
        if report is not None:
            report.close()
    n = len(results)
    if mesh is not None:
        # every rank's frame count, COCO records and unsmoothed frames to
        # rank 0, which smooths the frames of all ranks in frame order
        parts = [None] * dist.get_world_size() if lead else None
        dist.gather_object((n, coco_rows, raw_rows), parts, dst=0)
        if lead:
            n = sum(count for count, _, _ in parts)
            coco_rows = [row for _, rows, _ in parts for row in rows]
            raw_rows = sorted((row for _, _, rows in parts for row in rows),
                              key=lambda row: row[0])
    if smoother is not None and lead:
        for row in raw_rows:
            for idx, kp, sc in smoother.push(*row):
                emit_result(idx, kp, sc)
        for idx, kp, sc in smoother.flush():
            emit_result(idx, kp, sc)
    dt = time.time() - t0
    if coco_saver is not None and lead:
        for _, record_args, record_kwargs in sorted(coco_rows,
                                                    key=lambda row: row[0]):
            coco_saver.record(*record_args, **record_kwargs)
        coco_saver.save(args.write_coco_json)
    if lead:
        ranks = "" if mesh is None else f", ranks={mesh.size()}"
        print(f"openpose_tpu_torch: {n} frames in {dt:.2f}s "
              f"({n / max(dt, 1e-9):.2f} fps) [batched pipeline, "
              f"batch={batch}{ranks}]")
    return 0


class _NameByIndex(dict):
    def __init__(self, stem):
        super().__init__()
        self._stem = stem

    def get(self, idx, default=None):
        return f"{self._stem}_{idx:012d}"


def main(argv=None, device=None) -> int:
    """Run the CLI on argv (sys.argv when None).  device: where the nets run
    (a keyword for callers and tests; the card when None)."""
    args = build_parser().parse_args(argv)
    from openpose_tpu_torch.io import json_io, producers, savers
    from openpose_tpu_torch.params import PoseModel
    from openpose_tpu_torch.wrapper import (FaceConfig, HandConfig,
                                            PoseConfig, Wrapper)

    if args.write_video_adam:
        raise SystemExit(
            "--write_video_adam needs the Adam body model, which is not "
            "redistributable (the reference also gates it behind "
            "USE_3D_ADAM_MODEL); 3-D output is available via --write_json, "
            "--write_bvh and --write_video_3d")
    if args.write_bvh and not args.threed:
        raise SystemExit("--write_bvh requires --3d (triangulated keypoints)")
    if args.write_coco_json_variant != 0:
        raise SystemExit(
            "--write_coco_json_variant is car-JSON-only in the reference "
            "(flags.hpp:262) and car models are out of scope; use "
            "--write_coco_json_variants for body/foot/face/hand streams")
    if args.ik_threads > 0:
        raise SystemExit(
            "--ik_threads (Adam inverse kinematics) is 'not available yet' "
            "in the reference and requires the non-redistributable Adam "
            "model; see --write_bvh for skeletal export")
    if args.threed_views > 1:           # flags.hpp 3d_views == num_views here
        args.num_views = args.threed_views
    if args.write_bvh and (args.num_views <= 1
                           or not args.camera_parameter_path):
        # triangulation needs >=2 calibrated views; a single camera would
        # silently write an all-zero animation
        raise SystemExit(
            "--write_bvh requires multi-view input with calibration "
            "(--num_views > 1 and --camera_parameter_path) so 3-D keypoints "
            "can be triangulated")
    from openpose_tpu_torch.utils.logging import (Priority,
                                                  set_priority_threshold)
    set_priority_threshold(
        Priority.NO_OUTPUT if args.logging_level >= 5
        else Priority(args.logging_level))

    if fast_path_eligible(args):
        if args.num_gpu > 1:
            return run_ranks(args, _rank_devices(args, device))
        return run_fast_path(args, _cli_device(args, device))
    device = _cli_device(args, device)

    producer = producers.create_producer(
        image_dir=args.image_dir or None, video=args.video or None,
        webcam=args.camera if args.camera >= 0 else None,
        ip_camera=args.ip_camera or None,
        flir_camera=args.flir_camera,
        camera_resolution=parse_resolution(args.camera_resolution),
        config=producers.ProducerConfig(
            frame_first=args.frame_first, frame_step=args.frame_step,
            frame_last=args.frame_last, frames_repeat=args.frames_repeat,
            frame_flip=args.frame_flip,
            frame_rotate=args.frame_rotate, num_views=args.num_views,
            camera_parameter_path=args.camera_parameter_path or None,
            undistort=args.frame_undistort))

    wrapper = Wrapper(
        pose=PoseConfig(
            enable=bool(args.body),
            model=PoseModel(args.model_pose),
            net_resolution=parse_resolution(args.net_resolution),
            # reference semantics: the dynamic clip applies to image inputs
            # only (flags.hpp net_resolution_dynamic)
            net_resolution_dynamic=(args.net_resolution_dynamic
                                    if args.image_dir else -1.0),
            scale_number=args.scale_number, scale_gap=args.scale_gap,
            maximize_positives=args.maximize_positives,
            caffemodel=args.caffemodel_path or None,
            model_folder=args.model_folder or None,
            prototxt=args.prototxt_path or None,
            compute_dtype="float32" if args.fp32 else "bfloat16",
            number_people_max=args.number_people_max,
            render_threshold=args.render_threshold,
            alpha_keypoint=args.alpha_pose,
            blend_original=not args.disable_blending,
            tracking=args.tracking,
            part_candidates=args.part_candidates,
            top_down_refinement=args.top_down_refinement),
        face=FaceConfig(enable=args.face,
                        caffemodel=args.face_caffemodel_path or None,
                        net_resolution=parse_resolution(
                            args.face_net_resolution)[1],
                        detector=args.face_detector,
                        render_threshold=args.face_render_threshold,
                        render=args.face_render,
                        alpha_keypoint=args.face_alpha_pose),
        hand=HandConfig(enable=args.hand,
                        caffemodel=args.hand_caffemodel_path or None,
                        net_resolution=parse_resolution(
                            args.hand_net_resolution)[1],
                        detector=args.hand_detector,
                        render_threshold=args.hand_render_threshold,
                        render=args.hand_render,
                        alpha_keypoint=args.hand_alpha_pose,
                        scale_number=args.hand_scale_number,
                        scale_range=args.hand_scale_range,
                        tracking=args.tracking > -1),
        device=device)

    id_extractor = None
    if args.identification:
        from openpose_tpu_torch.tracking.person_id import PersonIdExtractor
        id_extractor = PersonIdExtractor(device=wrapper.device)

    json_dir = pathlib.Path(args.write_json) if args.write_json else None
    if json_dir:
        json_dir.mkdir(parents=True, exist_ok=True)
    keypoint_saver = None
    if args.write_keypoint:
        keypoint_saver = savers.KeypointSaver(args.write_keypoint,
                                              args.write_keypoint_format)
    scale_mode = None
    if args.keypoint_scale != 0:
        from openpose_tpu_torch.pose.scaler import ScaleMode
        scale_mode = [ScaleMode.InputResolution,
                      ScaleMode.NetOutputResolution,
                      ScaleMode.OutputResolution, ScaleMode.ZeroToOne,
                      ScaleMode.PlusMinusOne][args.keypoint_scale]
    image_saver = savers.ImageSaver(args.write_images,
                                    args.write_images_format) \
        if args.write_images else None
    video_saver = None
    if args.write_video:
        fps = args.write_video_fps
        if fps <= 0:
            fps = getattr(producer, "fps", 30.0)
        video_saver = savers.VideoSaver(args.write_video, fps)
    coco_saver = json_io.CocoJsonSaver(args.write_coco_json_variants) \
        if args.write_coco_json else None
    video3d_saver = savers.VideoSaver(args.write_video_3d, 15.0) \
        if args.write_video_3d else None
    bvh_saver = None
    if args.write_bvh:
        from openpose_tpu_torch.io.bvh import BvhSaver
        bvh_saver = BvhSaver(args.write_bvh, PoseModel(args.model_pose),
                             fps=getattr(producer, "fps", 30.0) or 30.0)
    heatmap_saver = savers.HeatMapSaver(args.write_heatmaps,
                                        args.write_heatmaps_format) \
        if args.write_heatmaps else None
    udp = savers.UdpSender(args.udp_host, args.udp_port) \
        if args.udp_host else None

    gui = None
    gui3d = None
    if args.display == 3:
        from openpose_tpu_torch.render.gui3d import Gui3D
        gui3d = Gui3D(PoseModel(args.model_pose))
    if args.display:
        from openpose_tpu_torch.render.gui import Gui
        gui = Gui()
        gui.state.part_to_show = args.part_to_show
        gui.state.fullscreen = args.fullscreen
        # reference GuiInfoAdder runs by default with the GUI unless
        # --no_gui_verbose
        if not args.no_gui_verbose:
            args.show_info = True
    output_resolution = parse_resolution(args.output_resolution)
    if args.process_real_time and args.fps_max <= 0:
        args.fps_max = getattr(producer, "fps", -1.0)

    profiler = None
    if args.profile_speed > 0:
        from openpose_tpu_torch.utils.profiler import Profiler
        profiler = Profiler(report_every=args.profile_speed)
        wrapper.profiler = profiler   # per-stage pose/face/hand keys

    smoother = None
    _pending = []
    if args.smooth_keyframes > 0:
        from openpose_tpu_torch.tracking.pose_graph import KeyframeSmoother
        smoother = KeyframeSmoother(window=args.smooth_keyframes,
                                    smoothness=args.smooth_lambda,
                                    device=wrapper.device)
    cameras = producer.cameras
    t_start = time.time()
    n_frames = 0

    def _emit_datum(datum, views):
        """Output tail for one frame (savers, render, GUI, UDP).
        Returns False when the GUI asked to stop."""
        name = datum.name or f"{datum.id:012d}"
        saved_kp = datum.pose_keypoints
        if scale_mode is not None and saved_kp is not None and saved_kp.size:
            from openpose_tpu_torch.pose import scaler as scaler_lib
            h_img, w_img = views[0].image.shape[:2]
            plan = scaler_lib.extract_scales(
                (w_img, h_img), wrapper.pose_cfg.net_resolution,
                wrapper.pose_cfg.scale_number, wrapper.pose_cfg.scale_gap,
                output_resolution=output_resolution)
            saved_kp = scaler_lib.keypoints_to_mode(
                saved_kp, scale_mode, (w_img, h_img),
                plan.net_input_sizes[0], plan.output_resolution)
        if keypoint_saver is not None and saved_kp is not None:
            keypoint_saver.save([saved_kp], name, "pose")
        if json_dir is not None:
            json_io.save_people_json(
                str(json_dir / f"{name}_keypoints.json"),
                pose_keypoints=saved_kp,
                candidates=datum.part_candidates,
                face_keypoints=datum.face_keypoints,
                hand_left_keypoints=datum.hand_left_keypoints,
                hand_right_keypoints=datum.hand_right_keypoints,
                pose_keypoints_3d=datum.pose_keypoints_3d,
                person_ids=datum.pose_ids)
        if coco_saver is not None and datum.pose_keypoints is not None \
                and datum.pose_keypoints.size:
            coco_saver.record(datum.pose_keypoints, datum.pose_scores,
                              json_io.image_id_from_name(name),
                              face_keypoints=datum.face_keypoints,
                              hand_left_keypoints=datum.hand_left_keypoints,
                              hand_right_keypoints=datum.hand_right_keypoints,
                              frame_number=datum.id)
        if heatmap_saver is not None and datum.heatmaps is not None:
            hm = datum.heatmaps          # primary pass output, no re-forward
            n_parts = wrapper.pose_extractor.info.num_parts
            any_select = (args.heatmaps_add_parts or args.heatmaps_add_bkg
                          or args.heatmaps_add_PAFs)
            if any_select:       # channel subsets (flags.hpp heatmaps_add_*)
                chans = []
                if args.heatmaps_add_parts:
                    chans.append(hm[..., :n_parts])
                if args.heatmaps_add_bkg:
                    chans.append(hm[..., n_parts:n_parts + 1])
                if args.heatmaps_add_PAFs:
                    chans.append(hm[..., n_parts + 1:])
                hm = np.concatenate(chans, axis=-1)
            if args.upsampling_ratio > 0:
                # heatmaps come back at net-input resolution (8x the net
                # output); a positive ratio rescales them to
                # ratio x net-output size (flags.hpp upsampling_ratio)
                import cv2
                f = args.upsampling_ratio / 8.0
                hm = cv2.resize(hm, None, fx=f, fy=f,
                                interpolation=cv2.INTER_CUBIC)
                if hm.ndim == 2:
                    hm = hm[..., None]
            if args.heatmaps_scale == 0:
                hm = np.clip(hm, -1.0, 1.0)
            elif args.heatmaps_scale == 1:
                hm = np.clip((hm + 1.0) / 2.0, 0.0, 1.0)
            heatmap_saver.save(hm, name)
        if bvh_saver is not None:
            bvh_saver.add_frame(datum.pose_keypoints_3d)
        if video3d_saver is not None and datum.pose_keypoints_3d is not None:
            from openpose_tpu_torch.render.gui3d import render_skeleton_3d
            img3d = render_skeleton_3d(datum.pose_keypoints_3d,
                                       wrapper.pose_cfg.model)
            video3d_saver.write(img3d[..., ::-1])  # RGB -> BGR
        if gui3d is not None:
            gui3d.update(datum.pose_keypoints_3d)
        if image_saver or video_saver or args.display:
            if gui is not None:
                args.part_to_show = gui.state.part_to_show
            if args.part_to_show != 0 and datum.heatmaps is not None:
                from openpose_tpu_torch.render import heatmaps as hm_render
                if args.part_to_show == -2:
                    frame = hm_render.overlay_paf(
                        views[0].image.copy(), datum.heatmaps,
                        wrapper.pose_cfg.model, alpha=args.alpha_heatmap)
                else:
                    part = (args.part_to_show - 1
                            if args.part_to_show > 0 else -1)
                    frame = hm_render.overlay_heatmap(
                        views[0].image.copy(), datum.heatmaps, part,
                        alpha=args.alpha_heatmap)
            elif args.render_pose:
                if gui is not None:       # 'b' key toggles blending live
                    wrapper.pose_cfg.blend_original = (
                        gui.state.blend and not args.disable_blending)
                frame = wrapper.render(datum)
            else:
                frame = views[0].image
            if output_resolution[0] > 0 and output_resolution[1] > 0:
                import cv2
                frame = cv2.resize(frame, output_resolution,
                                   interpolation=cv2.INTER_CUBIC)
            if args.show_info:
                from openpose_tpu_torch.render.heatmaps import add_info_overlay
                n_people = (0 if datum.pose_keypoints is None
                            else datum.pose_keypoints.shape[0])
                fps_now = n_frames / max(time.time() - t_start, 1e-9)
                add_info_overlay(frame, fps=fps_now, frame_id=datum.id,
                                 n_people=n_people)
            if image_saver:
                image_saver.save(frame, name)
            if video_saver:
                video_saver.write(frame)
            if gui is not None:
                gui.update(frame)
                if not gui.state.running:
                    return False
        if udp is not None:
            udp.send(json_io.people_json(
                pose_keypoints=datum.pose_keypoints,
                person_ids=datum.pose_ids))
        return True

    for views in producer.frames():
        if args.max_frames >= 0 and n_frames >= args.max_frames:
            break
        if gui is not None and not gui.state.running:
            break
        if gui is not None and gui.state.seek_delta:
            # bidirectional seek (gui.cpp spVideoSeek atomics): seekable
            # producers jump; others can only skip forward
            delta = gui.state.seek_delta
            gui.state.seek_delta = 0
            if not producer.request_seek(delta) and delta > 0:
                gui.state.seek_delta = delta - 1
                continue
        # one CNN forward per frame: heatmap consumers reuse the primary
        # pass's merged output (datum.heatmaps) instead of re-running the net
        needs_heatmaps = bool(args.write_heatmaps) or args.part_to_show != 0 \
            or (gui is not None and gui.state.part_to_show != 0)
        if profiler is not None:
            profiler.timer_init("process")
        datums = [wrapper.process(f.image, f.frame_id, f.name,
                                  keep_heatmaps=needs_heatmaps)
                  for f in views]
        if profiler is not None:
            profiler.timer_end("process")
        datum = datums[0]
        if id_extractor is not None and datum.pose_keypoints is not None:
            datum.pose_ids = id_extractor.extract_ids(
                datum.pose_keypoints, views[0].image)
        # 3-D triangulation over views
        if args.threed and len(views) > 1 and cameras:
            from openpose_tpu_torch.threed.triangulation import (
                reconstruct_array)
            cams = np.stack([c.full_matrix for c in cameras[:len(views)]])
            sizes = [(f.image.shape[1], f.image.shape[0]) for f in views]
            kv = [d.pose_keypoints for d in datums]
            if all(k is not None and k.size for k in kv):
                kp3 = reconstruct_array(
                    kv, cams.astype(np.float32), sizes,
                    args.threed_min_views if args.threed_min_views > 0 else 0,
                    device=wrapper.device)
                # reconstruct_array keeps the least number of people over
                # the views; the JSON has a row for each person of view 0,
                # and the ones past that number get zeros (unseen)
                datum.pose_keypoints_3d = np.concatenate([kp3, np.zeros(
                    (len(kv[0]) - len(kp3), *kp3.shape[1:]), np.float32)])

        if smoother is None:
            if not _emit_datum(datum, views):
                break
        else:
            # pose-graph keyframe smoothing (--smooth_keyframes):
            # buffer frames and emit once the lookahead half-window
            # has arrived, with smoothed/inpainted keypoints
            _pending.append((datum, views))
            _kp = (datum.pose_keypoints if datum.pose_keypoints
                   is not None else np.zeros((0, 25, 3), np.float32))
            _stop = False
            for _si, _skp, _ssc in smoother.push(n_frames, _kp,
                                                 datum.pose_scores):
                d2, v2 = _pending.pop(0)
                if _skp.size:
                    d2.pose_keypoints = _skp
                    d2.pose_scores = _ssc
                if not _emit_datum(d2, v2):
                    _stop = True
                    break
            if _stop:
                break
        n_frames += 1
        if args.fps_max > 0:   # WFpsMax (include/openpose/thread/wFpsMax.hpp)
            budget = n_frames / args.fps_max - (time.time() - t_start)
            if budget > 0:
                time.sleep(budget)
        if args.cli_verbose > 0 and n_frames % max(int(args.cli_verbose), 1) == 0:
            print(f"Processed {n_frames} frames "
                  f"({n_frames / (time.time() - t_start):.2f} fps)")

    if smoother is not None:
        for _si, _skp, _ssc in smoother.flush():
            if not _pending:
                break
            d2, v2 = _pending.pop(0)
            if _skp.size:
                d2.pose_keypoints = _skp
                d2.pose_scores = _ssc
            if not _emit_datum(d2, v2):
                break

    if video_saver:
        video_saver.close()
        if args.video and args.write_video_with_audio:
            video_saver.mux_audio_from(args.video)
    if video3d_saver is not None:
        video3d_saver.close()
    if bvh_saver is not None:
        bvh_saver.save()
    if coco_saver is not None:
        coco_saver.save(args.write_coco_json)
    if udp is not None:
        udp.close()
    if gui is not None:
        gui.close()
    if gui3d is not None:
        gui3d.close()
    dt = time.time() - t_start
    if profiler is not None:
        print(profiler.report())
    print(f"openpose_tpu_torch: {n_frames} frames in {dt:.2f}s "
          f"({n_frames / max(dt, 1e-9):.2f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
