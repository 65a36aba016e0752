"""Every multi-device path of the port at tiny shapes, run by every rank.

Counterpart of `__graft_entry__.py::dryrun_multichip`: after
`torch.distributed.init_process_group` (or `mesh.process_group`) every rank
of the group calls `dryrun_multichip(world_size)`, which runs

1. one train step over a (data, model) mesh, the ``model`` dimension 2
   where the world size is even;
2. one `PoseInference` batch over a data mesh, with its collectives
   counted (there must be none);
3. one `bundle_adjust` with the points sharded over ``data``;
4. one 2-scale `WholeBodyInference` batch with face and hand crops, and one
   with injected net outputs whose people must assemble;

and returns what it found, so that a test or a smoke run can hold it.
`count_collectives` is the counter step 2 uses; `collective_census` names
what it traced as the original's scaling scripts do.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.parallel import mesh as mesh_lib

# torch.distributed's collective functions, as `count_collectives` counts
# them
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "all_to_all", "all_to_all_single",
               "barrier", "broadcast", "broadcast_object_list", "gather",
               "gather_object", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "scatter")


@contextlib.contextmanager
def _counted_dist_calls(counts: Dict[str, int]):
    originals = {name: getattr(dist, name) for name in COLLECTIVES}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return originals[name](*args, **kwargs)
        return call
    try:
        for name in COLLECTIVES:
            setattr(dist, name, counted(name))
        yield
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def _traced_collectives(fn: Callable):
    """(fn's result, calls of torch.distributed's collective functions by
    name, the process groups' `gloo:` and `nccl:` spans in a torch.profiler
    trace by the op name after the prefix, the NCCL kernels the card ran).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    calls: Dict[str, int] = {}
    with profile(activities=activities) as prof, _counted_dist_calls(calls):
        result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    spans: Dict[str, int] = {}
    kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels += "nccl" in e.name.lower()
        elif e.name.startswith(("gloo:", "nccl:")):
            op = e.name.split(":", 1)[1]
            spans[op] = spans.get(op, 0) + 1
    return result, calls, spans, kernels


def count_collectives(fn: Callable) -> Tuple[object, dict]:
    """Run fn() and count the collectives it made.  Returns (fn's result,
    {"dist_calls": calls of torch.distributed's collective functions by
    name, "traced": the collectives a torch.profiler trace shows the
    process groups running (their `gloo:` and `nccl:` spans, which
    DTensor's functional collectives make too), "nccl_kernels": the NCCL
    kernels the card ran}).  fn must end with its work done (a host
    copy, or a synchronize)."""
    result, calls, spans, kernels = _traced_collectives(fn)
    return result, {"dist_calls": calls, "traced": sum(spans.values()),
                    "nccl_kernels": kernels}


# the process groups' op names (lower case, without "_") -> the names of the
# original's census of its compiled programs
_CENSUS_NAMES = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                 ("reducescatter", "reduce-scatter"),
                 ("alltoall", "all-to-all"))


def collective_census(fn: Callable) -> Tuple[object, Dict[str, int]]:
    """Run fn() and count the collectives its process groups ran, by the
    original's names (`all-reduce`, `all-gather`, `reduce-scatter`,
    `all-to-all`; any other op by its own name with "-" for "_"): the
    traced spans of `count_collectives`, so DTensor's functional
    collectives are counted too.  {} where fn ran none.  fn must end with
    its work done."""
    result, _, spans, _ = _traced_collectives(fn)
    census: Dict[str, int] = {}
    for op, n in spans.items():
        key = op.lower().replace("_", "")
        name = next((name for part, name in _CENSUS_NAMES if part in key),
                    op.replace("_", "-"))
        census[name] = census.get(name, 0) + n
    return result, census


def _mpi_person(cx: float, cy: float) -> np.ndarray:
    """An upright MPI_15 skeleton centred at (cx, cy), the original's: a
    fixed person assembles on every frame, where small random ones may
    fail the subset-score filter."""
    pts = [(0, -18), (0, -8), (7, -8), (11, 0), (13, 8), (-7, -8), (-11, 0),
           (-13, 8), (4, 6), (5, 14), (5, 22), (-4, 6), (-5, 14), (-5, 22),
           (0, 0)]
    kp = np.zeros((15, 3), np.float32)
    for p, (dx, dy) in enumerate(pts):
        kp[p] = (cx + dx, cy + dy, 1.0)
    return kp


def dryrun_multichip(n_devices: int,
                     device: Union[str, torch.device, None] = None) -> dict:
    """Run every multi-device path once on the initialised process group
    of `n_devices` ranks (every rank calls this); `device` is the rank's
    (its current card when None, "cpu" for a gloo group).  Returns
    {mesh, loss, step, inference, bundle_mean_abs_dp, whole_body,
    injected}; raises where a path fails."""
    from openpose_tpu_torch import train
    from openpose_tpu_torch.models import graph, zoo
    from openpose_tpu_torch.ops import paf as paf_ops
    from openpose_tpu_torch.ops import warp
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
    from openpose_tpu_torch.runtime.whole_body import WholeBodyInference
    from openpose_tpu_torch.threed import bundle_adjustment as ba

    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on a group of "
                         f"{dist.get_world_size()} ranks")
    device = device_rule.resolve(device)
    out: dict = {}

    # 1. one train step over (data, model): BODY_25 at 64x64, one row a
    # data rank
    model_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = mesh_lib.make_mesh(model=model_axis, device_type=device.type)
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    spec = graph.load_spec(info.spec)
    state = train.init_train_state(spec, torch.Generator().manual_seed(0),
                                   1e-4, device, mesh=mesh)
    h = w = 64
    rows = mesh_lib.local_rows(mesh, mesh_lib.size(mesh, "data"))
    n_local = rows.stop - rows.start
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf_ops.pair_tables(info))
    keypoints = torch.zeros((n_local, 4, info.num_parts, 3), device=device)
    keypoints[..., :2] = 20.0
    keypoints[..., 2] = 1.0
    targets = train.make_targets(keypoints, pairs, map_idx, (h, w),
                                 info.num_parts, info.heatmap_channels)
    state, loss = train.make_train_step(torch.float32, mesh)(
        state, torch.zeros((n_local, h, w, 3), device=device), targets)
    out.update(mesh=list(mesh.shape), loss=float(loss), step=state.step)
    if not np.isfinite(out["loss"]):
        raise FloatingPointError(f"dryrun train step: loss {out['loss']}")

    # 2. the data-parallel inference batch: no collective
    data_mesh = mesh_lib.make_mesh(model=1, device_type=device.type)
    mpi = zoo.load_pose_model(PoseModel.MPI_15_4, device=device)
    inference = PoseInference(mpi, net_hw=(h, w), max_peaks=16,
                              compute_dtype=torch.float32, mesh=data_mesh)
    frames = torch.zeros((n_devices, h, w, 3))[
        inference.local_rows(n_devices)]
    (peaks, scores), counts = count_collectives(
        lambda: inference.fetch(*inference(frames)))
    out["inference"] = {"peaks": list(peaks.shape),
                        "scores": list(scores.shape), "collectives": counts}
    if counts["dist_calls"] or counts["traced"] or counts["nccl_kernels"]:
        raise RuntimeError(f"the data-parallel inference batch ran "
                           f"collectives: {counts}")

    # 3. bundle adjustment, the points over data
    rng = np.random.RandomState(0)
    n_pts, n_cams = 2 * n_devices, 3
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    kmat = np.tile(np.array([[100., 0, 32], [0, 100., 32], [0, 0, 1]],
                            np.float32), (n_cams, 1, 1))
    ext = np.tile(np.eye(3, 4, dtype=np.float32), (n_cams, 1, 1))
    ext[:, 0, 3] = np.linspace(-0.4, 0.4, n_cams)
    homog = np.concatenate([pts, np.ones((n_pts, 1), np.float32)], 1)
    proj = np.einsum("vij,vjk,nk->nvi", kmat, ext, homog)
    obs = (proj[..., :2] / proj[..., 2:3]).astype(np.float32)
    refined, _ = ba.bundle_adjust(pts + 0.05, obs,
                                  np.ones((n_pts, n_cams), np.float32), kmat,
                                  ext, iterations=3, mesh=data_mesh,
                                  device=device)
    out["bundle_mean_abs_dp"] = float(np.abs(refined - pts).mean())

    # 4. the whole-body cascade, 2 scales, face and hand crops
    face, hand = (zoo.load_face_model(device=device),
                  zoo.load_hand_model(device=device))
    wb = WholeBodyInference(
        mpi, face, hand, mesh=data_mesh, frame_hw=(96, 128), net_hw=(64, 80),
        people_cap=2, max_peaks=16, face_net_size=64, hand_net_size=64,
        compute_dtype=torch.float32, scale_number=2)
    mine = wb.local_rows(n_devices)
    frames = np.random.RandomState(1).randint(
        0, 255, (n_devices, 96, 128, 3)).astype(np.uint8)[mine]
    results = wb(frames)
    # random weights may assemble nobody: crop synthetic ROIs as well
    tr = np.tile(np.asarray(warp.rect_to_transform((8.0, 8.0, 40.0, 40.0),
                                                   64, False), np.float32),
                 (frames.shape[0], 2, 1))
    face_peaks = wb.face(frames, tr)
    hand_peaks = wb.hand(frames, np.tile(tr[:, :1], (1, 4, 1)))
    out["whole_body"] = {
        "frames": len(results),
        "people": sum(r.pose_keypoints.shape[0] for r in results),
        "face": list(face_peaks.shape), "hand": list(hand_peaks.shape)}

    # 5. injected net outputs: the body -> rects -> crops hand-off with
    # people in it
    wb_inj = WholeBodyInference(
        mpi, face, hand, mesh=data_mesh, frame_hw=None, net_hw=(64, 80),
        people_cap=2, max_peaks=16, face_net_size=64, hand_net_size=64,
        compute_dtype=torch.float32, net_bypass=True)
    n_parts = mpi.info.num_parts
    kp_inj = np.zeros((n_devices, 1, n_parts, 3), np.float32)
    for i in range(n_devices):
        kp_inj[i, 0] = _mpi_person(24.0 + 4.0 * (i % 8), 30.0)[:n_parts]
    inj_pairs, inj_map_idx = (torch.from_numpy(t).to(device)
                              for t in paf_ops.pair_tables(mpi.info))
    net_out = train.make_targets(
        torch.from_numpy(kp_inj[mine]).to(device), inj_pairs, inj_map_idx,
        (64, 80), n_parts, mpi.info.heatmap_channels)
    inj_frames = np.random.RandomState(7).randint(
        0, 255, (n_devices, 64, 80, 3)).astype(np.uint8)[mine]
    inj = wb_inj(inj_frames, net_output=net_out)
    out["injected"] = {
        "frames": len(inj),
        "people": sum(r.pose_keypoints.shape[0] for r in inj),
        "frames_with_face": sum(
            int(r.face_keypoints is not None
                and bool(np.any(r.face_keypoints[..., 2] > 0)))
            for r in inj)}
    if out["injected"]["people"] < len(inj):
        raise RuntimeError(f"the injected whole-body cascade assembled "
                           f"{out['injected']['people']} people on "
                           f"{len(inj)} frames (one a frame expected)")
    return out
