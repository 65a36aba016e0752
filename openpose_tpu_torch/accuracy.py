"""Closed-loop synthetic COCO accuracy harness.

Counterpart of `openpose_tpu/accuracy.py`.  Measures AP of the real user
path without trained weights: synthetic scenes with known keypoints are
rendered to net-output tensors on the device (`train.make_targets`),
injected into `PoseInference(net_bypass=True)` in place of the CNN (the
reference's Datum::poseNetOutput hook, datum.hpp:212-217), and the standard
device -> host tail runs unchanged: NMS and PAF scoring on the device,
greedy assembly on a host thread pool, `CocoJsonSaver`, and the
pycocotools-exact evaluator (`io/coco_eval.py`).  Any regression in peak
refinement, PAF scoring, assembly, COCO reordering or evaluation moves the
reported AP.

`train_to_ap` closes the other loop: train BODY_25 from scratch on rendered
stick figures (`train_loop.train`, over the process group when there is
one), serve the trained weights through `PoseExtractor.forward` on
held-out scenes, score the detections.

With a `mesh` every rank calls the loop alike: each draws the whole global
batch's scenes and noise, renders and decodes its own rows, and the
detections (or errors) are gathered over ``data``, so every rank returns
the unsharded call's metrics.

Noise and keypoint jitter come from a `torch.Generator` made from `seed`:
other draws than the JAX package's `jax.random` gives, so at `noise > 0` or
`kp_jitter > 0` the two packages are compared by the AP they reach, not
draw by draw.
"""

from __future__ import annotations

import concurrent.futures
import tempfile
from typing import Dict, List, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch import synthetic, train, train_loop
from openpose_tpu_torch.face.detector import detect_faces
from openpose_tpu_torch.hand.detector import detect_hands
from openpose_tpu_torch.io import coco_eval, json_io
from openpose_tpu_torch.models import zoo
from openpose_tpu_torch.ops import paf, resize, warp
from openpose_tpu_torch.parallel import mesh as mesh_lib
from openpose_tpu_torch.parallel.inference import (
    PoseInference, TopDownInference)
from openpose_tpu_torch.params import (
    FACE_NUMBER_PARTS, HAND_NUMBER_PARTS, POSE_MODEL_INFO, PoseModel)
from openpose_tpu_torch.pose.extractor import PoseExtractor

Device = Union[str, torch.device, None]


def _gather_rows(mesh, rows: list) -> list:
    """Every data rank's `rows` (lists of (order key, ...) tuples), merged
    and sorted by their keys: what one process would have made."""
    if mesh is None:
        return rows
    parts = [None] * mesh_lib.size(mesh, "data")
    dist.all_gather_object(parts, rows, group=mesh.get_group("data"))
    return sorted((row for part in parts for row in part),
                  key=lambda row: row[0])


def synthetic_coco_eval(n_images: int = 64,
                        net_hw: Tuple[int, int] = (368, 656),
                        people_range: Tuple[int, int] = (1, 4),
                        noise: float = 0.0,
                        kp_jitter: float = 0.0,
                        batch: int = 8,
                        seed: int = 0,
                        model=None,
                        assembly_workers: int = 4,
                        device: Device = None,
                        mesh=None) -> Dict[str, float]:
    """Run the closed loop on `device` (the card when None); returns {AP,
    AP50, AP75, AR, n_images, noise, kp_jitter, n_detections, n_gt}.
    With a `mesh`, on every rank of it (the batch rounded down to a
    multiple of its data shards, at least one each, as in the original).

    noise: stddev of SPATIALLY CORRELATED noise added to every net-output
    channel on the device (white noise drawn at 1/4 the map resolution and
    bicubic-upsampled: a CNN's prediction error is smooth, so white pixel
    noise would be an unrealistically adversarial model; heatmap peaks have
    amplitude 1.0).
    kp_jitter: stddev (input px) of Gaussian displacement applied to the
    RENDERED keypoints only: the ground truth keeps the true positions, so
    this sweeps AP against controlled localization error of the "CNN".
    """
    device = mesh_lib.rank_device(mesh, device)
    if model is None:
        model = zoo.load_pose_model(PoseModel.BODY_25, device=device)
    info = model.info
    net_h, net_w = net_hw
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf.pair_tables(info))
    inference = PoseInference(model, net_hw=net_hw, device=device,
                              net_bypass=True, compute_dtype=torch.float32,
                              mesh=mesh)
    dp = inference.data_parallelism
    if batch % dp:
        batch = dp * max(1, batch // dp)
    rows = inference.local_rows(batch)

    generator = torch.Generator().manual_seed(seed)

    def render(kp_batch: np.ndarray) -> torch.Tensor:
        """This rank's rows of the batch's net outputs; the jitter and noise
        are drawn for the whole batch, so each row gets the draws it gets
        in one process."""
        kp = torch.from_numpy(kp_batch)
        if kp_jitter:
            kp[..., :2] += kp_jitter * torch.randn(kp[..., :2].shape,
                                                   generator=generator)
        out = train.make_targets(kp[rows].to(device), pairs, map_idx, net_hw,
                                 info.num_parts, info.heatmap_channels)
        if noise:
            b, h8, w8, c = out.shape
            low = torch.randn((batch, max(1, h8 // 4), max(1, w8 // 4), c),
                              generator=generator)[rows].to(device)
            out = out + noise * resize.resize_bicubic(low, (h8, w8))
        return out

    rng = np.random.RandomState(seed)
    max_people = people_range[1]
    saver = json_io.CocoJsonSaver()
    gts: List[Dict] = []
    futures = []

    def assemble(idx, peaks_i, scores_i):
        kp, sc = inference.assemble(peaks_i, scores_i, 1.0)
        return idx, kp, sc

    with concurrent.futures.ThreadPoolExecutor(assembly_workers) as pool:
        for start in range(0, n_images, batch):
            ids = [start + i for i in range(batch)]
            kp_batch = np.zeros((batch, max_people, info.num_parts, 3),
                                np.float32)
            for bi, image_id in enumerate(ids):
                if image_id >= n_images:
                    continue                 # padded tail: zero people
                people = synthetic.random_people(
                    rng, rng.randint(people_range[0], people_range[1] + 1),
                    (net_h, net_w))
                kp_batch[bi, :people.shape[0]] = people
                gts.extend(synthetic.coco_ground_truth(people, image_id))
            peaks, scores = inference.fetch(*inference(render(kp_batch)))
            for bi, image_id in enumerate(ids[rows]):
                if image_id < n_images:
                    futures.append(pool.submit(assemble, image_id,
                                               peaks[bi], scores[bi]))
        found = [fut.result() for fut in futures]
    for image_id, kp, sc in _gather_rows(mesh, found):
        if kp.size:
            saver.record(kp, sc, image_id)

    detections = saver.entries[json_io.VARIANT_BODY]
    metrics = coco_eval.evaluate(detections, gts)
    metrics.update(n_images=n_images, noise=noise, kp_jitter=kp_jitter,
                   n_detections=len(detections), n_gt=len(gts))
    return metrics


def synthetic_topdown_eval(kind: str = "face",
                           n_frames: int = 16,
                           frame_hw: Tuple[int, int] = (368, 656),
                           people_range: Tuple[int, int] = (1, 3),
                           net_size: int = 368,
                           sigma: float = 7.0,
                           batch: int = 8,
                           seed: int = 0,
                           device: Device = None,
                           mesh=None) -> Dict[str, float]:
    """Closed-loop face/hand localization accuracy through the real
    top-down decode (crop geometry -> decode -> map-back).

    Body keypoints from random scenes produce face/hand rectangles exactly
    as the whole-body cascade does (detect_faces/detect_hands from pose
    keypoints, faceDetector.cpp:37-75), ground-truth part locations are
    drawn inside each rectangle, rendered as net-output Gaussians in CROP
    space (the grid convention of the training targets), injected into
    `TopDownInference` in place of the CNN, and mapped back to frame pixels
    by the standard path (warp.map_back; faceExtractorCaffe.cpp:230-310 /
    mirrored left hands handExtractorCaffe.cpp:44-75).  Any regression in
    rect_to_transform, the 8x upsample decode, mirror handling or map-back
    moves the reported error.

    Returns {kind, rmse_px, max_err_px, pck05, n_instances, n_parts}:
    rmse in FRAME pixels over every valid part, PCK@0.05 = fraction of
    parts within 5% of the rect side.  With a `mesh`, on every rank of it
    (the batch rounded as `synthetic_coco_eval` rounds it).
    """
    device = mesh_lib.rank_device(mesh, device)
    is_face = kind == "face"
    num_parts = FACE_NUMBER_PARTS if is_face else HAND_NUMBER_PARTS
    cap = people_range[1] * (1 if is_face else 2)
    model = (zoo.load_face_model(device=device) if is_face
             else zoo.load_hand_model(device=device))
    topdown = TopDownInference(model, net_size=net_size, people_cap=cap,
                               device=device, compute_dtype=torch.float32,
                               mesh=mesh)
    dp = mesh_lib.size(mesh, "data")
    if batch % dp:
        batch = dp * max(1, batch // dp)
    mine = mesh_lib.local_rows(mesh, batch)

    s8 = net_size // 8
    # map px m <-> crop coord (m + 0.5)*8 - 0.5 (train.make_targets grid;
    # the 8x half-pixel-center bicubic upsample then lands upsampled px j
    # exactly on crop coord j, so argmax recovers the rendered location)
    grid = (np.arange(s8, dtype=np.float32) + 0.5) * 8.0 - 0.5

    rng = np.random.RandomState(seed)
    # ((frame, slot), error, relative error) of this rank's rows
    found: List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]] = []
    n_instances = 0

    for start in range(0, n_frames, batch):
        maps = np.zeros((batch, cap, s8, s8, num_parts), np.float32)
        gt: List[List[Tuple[int, np.ndarray, Tuple, float]]] = []
        for bi in range(batch):
            rows = []
            if start + bi < n_frames:
                people = synthetic.random_people(
                    rng, rng.randint(people_range[0], people_range[1] + 1),
                    frame_hw)
                if is_face:
                    rects = [(r, False)
                             for r in detect_faces(people, PoseModel.BODY_25)]
                else:
                    rects = []
                    for left, right in detect_hands(people,
                                                    PoseModel.BODY_25):
                        rects.append((left, True))
                        rects.append((right, False))
                for slot, (rect, mirror) in enumerate(rects[:cap]):
                    if min(rect[2], rect[3]) <= 1 or rect[2] * rect[3] <= 10:
                        continue
                    tr = warp.rect_to_transform(rect, net_size, mirror)
                    # ground-truth parts inside the central 70% of the rect
                    x0, y0, rw, rh = rect
                    pts = np.stack([
                        x0 + rw * rng.uniform(0.15, 0.85, num_parts),
                        y0 + rh * rng.uniform(0.15, 0.85, num_parts)],
                        axis=-1).astype(np.float32)
                    crop_pts = warp.map_forward(pts, tr)
                    dx2 = (grid[None, :] - crop_pts[:, 0][:, None]) ** 2
                    dy2 = (grid[None, :] - crop_pts[:, 1][:, None]) ** 2
                    d2 = dy2[:, :, None] + dx2[:, None, :]  # [parts, y, x]
                    maps[bi, slot] = np.exp(
                        -d2 / (2.0 * sigma * sigma)).transpose(1, 2, 0)
                    rows.append((slot, pts, tr, max(rw, rh)))
                    n_instances += 1
            gt.append(rows)
        peaks = topdown(None, None, net_output=maps[mine]).cpu().numpy()
        for bi, frame_gt in enumerate(gt[mine]):
            for slot, pts, tr, side in frame_gt:
                xy = warp.map_back(peaks[bi, slot, :num_parts, :2], tr)
                err = np.linalg.norm(xy - pts, axis=-1)
                found.append(((start + mine.start + bi, slot), err,
                              err / max(side, 1.0)))

    found = _gather_rows(mesh, found)
    err = np.concatenate([f[1] for f in found]) if found else np.zeros(1)
    rel = np.concatenate([f[2] for f in found]) if found else np.ones(1)
    return {
        "kind": kind,
        "rmse_px": float(np.sqrt((err ** 2).mean())),
        "max_err_px": float(err.max()),
        "pck05": float((rel < 0.05).mean()),
        "n_instances": n_instances,
        "n_parts": int(err.size),
    }


def held_out_scenes(n_eval: int, image_size: Tuple[int, int],
                    people_range: Tuple[int, int], seed: int):
    """`train_to_ap`'s evaluation set: n_eval (people [n, 25, 3], image
    [H, W, 3] uint8) scenes in the trainer's domain (`train_loop.
    synthetic_scene_iterator`'s sizes and spacing, the numpy renderer),
    from a seed the trainer does not use."""
    h, w = image_size
    rng = np.random.RandomState(seed)
    hr = (max(80.0, h * 0.45), h * 0.9)
    scenes = []
    for _ in range(n_eval):
        people = synthetic.random_people(
            rng, rng.randint(people_range[0], people_range[1] + 1),
            (h, w), height_range=hr, min_spacing=60.0)
        scenes.append((people,
                       synthetic.render_scene_image(people, (h, w), rng=rng)))
    return scenes


def train_to_ap(steps: int = 1500,
                image_size: Tuple[int, int] = (184, 328),
                batch: int = 8,
                learning_rate: float = 1e-4,
                n_eval: int = 16,
                people_range: Tuple[int, int] = (1, 3),
                seed: int = 0,
                checkpoint_dir: str = "",
                lr_schedule: str = "constant",
                target_sigma: float = 7.0,
                verbose: bool = True,
                device: Device = None,
                compute_dtype: torch.dtype = torch.float32
                ) -> Dict[str, float]:
    """Train BODY_25 from scratch on rendered synthetic scenes, then measure
    COCO AP of the trained net through the FULL pipeline on held-out scenes.

    Turns "loss decreases" into "training produces a net the pipeline can
    decode": train (`train_loop.train`) -> held-out rendered images -> the
    CNN forward -> NMS -> PAF -> assembly -> CocoJsonSaver ->
    pycocotools-exact AP.  The synthetic drawing domain (color-coded joints
    and limbs) is learnable by the CPM/PAF architecture in O(10^3) steps.

    The returned metrics hold the trainer's statistics and the device step
    probe's.  The trained weights are served from where the trainer left
    them (a serving net over the same storage, nothing copied, no
    gradients); the checkpoint `BODY_25_step{steps}.npz` in
    `checkpoint_dir` holds them for later."""
    device = device_rule.resolve(device)
    config = train_loop.TrainConfig(
        model=PoseModel.BODY_25, image_size=image_size, batch_size=batch,
        learning_rate=learning_rate, steps=steps, checkpoint_every=steps,
        checkpoint_dir=checkpoint_dir or tempfile.mkdtemp(prefix="t2ap_"),
        lr_schedule=lr_schedule, target_sigma=target_sigma)
    data = train_loop.synthetic_scene_iterator(
        config, seed=seed, people_range=people_range, prefetch_workers=2,
        device=device)
    train_stats: Dict[str, float] = {}
    state = train_loop.train(config, data, verbose=verbose,
                             stats_out=train_stats, device=device,
                             compute_dtype=compute_dtype)

    trained = zoo.Model(spec=state.net.spec, net=state.net.serving_view(),
                        info=POSE_MODEL_INFO[PoseModel.BODY_25])
    extractor = PoseExtractor(trained, compute_dtype=torch.float32,
                              device=device)
    h, w = image_size
    saver = json_io.CocoJsonSaver()
    gts: List[Dict] = []
    for image_id, (people, img) in enumerate(held_out_scenes(
            n_eval, image_size, people_range, seed + 1)):
        gts.extend(synthetic.coco_ground_truth(people, image_id))
        pred = extractor.forward(img.astype(np.float32),
                                 net_resolution=(w, h))
        if pred.keypoints.size:
            saver.record(pred.keypoints, pred.scores, image_id)
    detections = saver.entries[json_io.VARIANT_BODY]
    metrics = coco_eval.evaluate(detections, gts)
    metrics.update(steps=steps, n_eval=n_eval, lr_schedule=lr_schedule,
                   target_sigma=target_sigma, n_detections=len(detections),
                   n_gt=len(gts), **train_stats)
    # the step with its inputs already on the device, beside the loop's
    # figure above, which the scene iterator feeds; a probe that fails
    # raises
    metrics.update(train_loop.device_step_probe(
        config, device=device, compute_dtype=compute_dtype))
    return metrics


def noise_sweep(levels=(0.0, 0.1, 0.2, 0.4), **kw) -> List[Dict[str, float]]:
    """AP at each (correlated) map-noise level."""
    model = kw.pop("model", None) or zoo.load_pose_model(
        PoseModel.BODY_25, device=kw.get("device"))
    return [synthetic_coco_eval(noise=lv, model=model, **kw)
            for lv in levels]


def jitter_sweep(levels=(0.0, 2.0, 4.0, 8.0), **kw) -> List[Dict[str, float]]:
    """AP at each keypoint-localization-error level (px)."""
    model = kw.pop("model", None) or zoo.load_pose_model(
        PoseModel.BODY_25, device=kw.get("device"))
    return [synthetic_coco_eval(kp_jitter=lv, model=model, **kw)
            for lv in levels]
