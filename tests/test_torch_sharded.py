"""The port's entry points over a device mesh against the JAX package's
sharded ones and against the port without a mesh (CPU, gloo).

One module fixture starts two gloo ranks through `torch.multiprocessing`
(spawn, a file `init_method` under the test's temporary directory, no
network, one torch thread each, oneDNN off for the trainer's gradients as
in `test_torch_train.py`); a second starts four for `dryrun_multichip(4)`
on a 2x2 world.  Each rank writes what it found to a file that the tests
read.  JAX runs in this process on 2 of its 8 virtual CPU devices; weights
reach the port from the JAX package's params through a checkpoint
(`checkpoint.load_npz`, i.e. `from_jax_params`).

Tolerances: against JAX, peak counts exact, peaks within 1e-4 px
(`tests/test_models.py`) plus 1e-5 of their value, pair scores rtol 1e-4
and atol 1e-4 (BODY_25's float32 sums, taken in another order than XLA's,
move a peak 62 px from the corner by 1.2e-4 px and one score of 26,624 by
8.7e-5, without a mesh as with one: `test_torch_inference.py` holds the
port to JAX there); top-down keypoints at the same pixel (1e-2) with
scores within 1e-4, injected people within 1e-3 px.  Against the port
without a mesh, on one thread as each rank: bit for bit.  The sharded
trainers against the one-process trainer: one step's loss rtol 1e-5 and
gradients within 1e-5 of each tensor's largest entry; three steps' losses
rtol 1e-5, and params: all but 0.01% of them within 1e-5 of the largest
entry of all the params, every one within 2 x the learning rate x the
steps (Adam divides a gradient by its own size, so where a gradient is a
sum near zero its last bits can turn that entry's step around); with
``model`` = 2 each rank runs the whole batch, and all of it is equal bit
for bit.  The accuracy loops' metrics equal.
"""

import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from openpose_tpu.models import checkpoint as jcheckpoint
from openpose_tpu.models import zoo as jzoo
from openpose_tpu.parallel import mesh as jmesh
from openpose_tpu.parallel.inference import (
    ShardedPoseInference, ShardedTopDown)
from openpose_tpu.params import PoseModel as JaxPoseModel
from openpose_tpu.runtime.whole_body import ShardedWholeBody
from openpose_tpu_torch import accuracy, synthetic, train, train_loop
from openpose_tpu_torch.models import checkpoint, graph, zoo
from openpose_tpu_torch.ops import paf, warp
from openpose_tpu_torch.parallel.inference import (
    PoseInference, TopDownInference)
from openpose_tpu_torch.params import PoseModel
from openpose_tpu_torch.runtime.video_runner import VideoRunner
from openpose_tpu_torch.runtime.whole_body import WholeBodyInference

JOIN_SECONDS = 240
FRAMES = 4                      # the global batch: two rows a data rank
NET_HW = (64, 64)
INFER_KW = dict(net_hw=NET_HW, max_peaks=16)
TD_NET = 64
WB_HW = (184, 320)
TRAIN_SIZE = (24, 32)
TRAIN_STEPS = 3
EVAL_KW = dict(n_images=6, net_hw=(64, 96), batch=4, noise=0.1)
TOPDOWN_KW = dict(n_frames=6, net_size=TD_NET, batch=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One thread, as on each rank: oneDNN's convolutions may sum in
    another order on another number of threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- inputs, made once in this process --------------------------------------


def _weights(tmp, jax_models):
    """The JAX models' params as checkpoints."""
    paths = {}
    for name, model in jax_models.items():
        paths[name] = str(tmp / f"{name}.npz")
        jcheckpoint.save(paths[name], model.params)
    return paths


def _frames(seed=0, hw=NET_HW, n=FRAMES):
    return np.random.RandomState(seed).randint(
        0, 255, (n, *hw, 3)).astype(np.uint8)


def _transforms():
    """[FRAMES, 2, 4] crop rows: one face a frame, a second on frame 2."""
    rows = np.tile(np.asarray(TopDownInference.INACTIVE, np.float32),
                   (FRAMES, 2, 1))
    for i in range(FRAMES):
        rows[i, 0] = warp.rect_to_transform((10.0 + i, 12.0, 40.0, 40.0),
                                            TD_NET, mirror=bool(i % 2))
    rows[2, 1] = warp.rect_to_transform((20.0, 14.0, 30.0, 30.0), TD_NET,
                                        mirror=False)
    return rows


def _injected():
    """Two frames of two BODY_25 people each and their rendered net
    outputs."""
    from openpose_tpu_torch.params import POSE_MODEL_INFO
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    rng = np.random.RandomState(9)
    people = [synthetic.random_people(rng, 2, WB_HW, height_range=(150, 170),
                                      min_spacing=130) for _ in range(2)]
    pairs, map_idx = paf.pair_tables(info)
    net_output = synthetic.make_targets(np.stack(people), pairs, map_idx,
                                        WB_HW, info.num_parts,
                                        info.heatmap_channels)
    frames = np.stack([synthetic.render_scene_image(p, WB_HW, rng)
                       for p in people])
    return frames, net_output


def _train_batches():
    rng = np.random.RandomState(4)
    h, w = TRAIN_SIZE
    out = []
    for _ in range(TRAIN_STEPS):
        kp = np.zeros((2, 3, 15, 3), np.float32)
        kp[:, :2] = np.stack([synthetic.random_people(
            rng, 2, TRAIN_SIZE, height_range=(14, 20))[:, :15]
            for _ in range(2)])
        out.append((rng.randint(0, 255, (2, h, w, 3)).astype(np.uint8), kp))
    return out


def _train_config(model_parallel, folder):
    return train_loop.TrainConfig(
        model=PoseModel.MPI_15_4, image_size=TRAIN_SIZE, batch_size=2,
        steps=TRAIN_STEPS, checkpoint_every=TRAIN_STEPS,
        checkpoint_dir=str(folder), model_parallel=model_parallel)


def _make_video(path, frames=5, wh=(64, 48)):
    import cv2
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, wh)
    rng = np.random.RandomState(0)
    for _ in range(frames):
        writer.write(rng.randint(0, 255, (wh[1], wh[0], 3), np.uint8))
    writer.release()


def _video(tmp):
    """A 5-frame clip where OpenCV and the native pump are built, else
    None."""
    from openpose_tpu_torch.io import native_loader
    try:
        _make_video(str(tmp / "clip.avi"))
    except ImportError:
        return None
    return str(tmp / "clip.avi") if native_loader.available() else None


def _first_step(batch, mesh=None):
    """Loss and gradients (full tensors) of one MPI_15_4 train step on
    `batch`, this rank's rows of it over a mesh."""
    from torch.distributed.tensor import DTensor
    from openpose_tpu_torch.ops.resize import normalize_vgg
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    from openpose_tpu_torch.params import POSE_MODEL_INFO
    images, kp = batch
    rows = slice(None) if mesh is None \
        else mesh_lib.local_rows(mesh, len(images))
    info = POSE_MODEL_INFO[PoseModel.MPI_15_4]
    state = train.init_train_state(graph.load_spec(info.spec),
                                   torch.Generator().manual_seed(0), 1e-4,
                                   "cpu", mesh=mesh)
    pairs, map_idx = (torch.from_numpy(t) for t in paf.pair_tables(info))
    targets = train.make_targets(torch.from_numpy(kp[rows]), pairs, map_idx,
                                 TRAIN_SIZE, info.num_parts,
                                 info.heatmap_channels)
    _, loss = train.make_train_step(torch.float32, mesh)(
        state, normalize_vgg(torch.from_numpy(images[rows]).float()),
        targets)
    return float(loss), {
        name: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
               else p.grad).numpy().copy()
        for name, p in state.net.weights.items()}


def _port_model(path, name, device="cpu"):
    from openpose_tpu_torch.params import POSE_MODEL_INFO
    spec = {"face": "face_70", "hand": "hand_21"}.get(name)
    info = None if spec else POSE_MODEL_INFO[PoseModel[name]]
    spec = graph.load_spec(spec or info.spec)
    return zoo.from_params(spec, checkpoint.load_npz(path), info, device)


# --- the ranks --------------------------------------------------------------


def _numpy(tensors):
    return [t.numpy() for t in tensors]


def _results(results):
    return [(r.pose_keypoints, r.pose_scores, r.face_keypoints,
             r.hand_left_keypoints, r.hand_right_keypoints)
            for r in results]


def _two_rank_job(rank, tmp, inputs):
    """What each of the two ranks finds over 2x1 and 1x2 meshes."""
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    from openpose_tpu_torch.parallel.dryrun import count_collectives
    weights = inputs["weights"]
    data = mesh_lib.make_mesh(device_type="cpu")
    model2 = mesh_lib.make_mesh(model=2, device_type="cpu")
    out = {"rows": mesh_lib.local_rows(data, FRAMES), "tmp": tmp}
    rows = out["rows"]
    frames = inputs["frames"]
    for name in ("MPI_15_4", "BODY_25"):
        inf = PoseInference(_port_model(weights[name], name), mesh=data,
                            compute_dtype=torch.float32, **INFER_KW)
        out[name], out[name + "_collectives"] = count_collectives(
            lambda: _numpy(inf(frames[rows])))
        out[name + "_fetch"] = inf.fetch(*inf(frames[rows]))
        out[name + "_dp"] = inf.data_parallelism
    inf = PoseInference(_port_model(weights["BODY_25"], "BODY_25"),
                        mesh=model2, compute_dtype=torch.float32, **INFER_KW)
    out["model2"], out["model2_collectives"] = count_collectives(
        lambda: _numpy(inf(frames)))
    try:
        mesh_lib.local_rows(data, 3)
    except ValueError as e:
        out["tile_error"] = str(e)
    try:
        VideoRunner(PoseInference(_port_model(weights["MPI_15_4"],
                                              "MPI_15_4"), mesh=data,
                                  **INFER_KW), batch_size=3)
    except ValueError as e:
        out["runner_tile_error"] = str(e)

    face = _port_model(weights["face"], "face")
    hand = _port_model(weights["hand"], "hand")
    td = TopDownInference(face, net_size=TD_NET, people_cap=2,
                          compute_dtype=torch.float32, mesh=data)
    out["topdown"] = td(inputs["td_frames"][rows],
                        inputs["transforms"][rows]).numpy()
    wb = WholeBodyInference(
        _port_model(weights["BODY_25"], "BODY_25"), face, hand, mesh=data,
        frame_hw=None, net_hw=WB_HW, people_cap=2, face_net_size=TD_NET,
        hand_net_size=TD_NET, net_bypass=True, compute_dtype=torch.float32)
    wb_frames, wb_net = inputs["injected"]
    mine = wb.local_rows(len(wb_frames))
    out["wb_rows"] = mine
    out["whole_body"] = _results(wb(wb_frames[mine],
                                    net_output=wb_net[mine]))

    with torch.backends.mkldnn.flags(enabled=False):
        out["step_data2"] = _first_step(inputs["train"][0], data)
        for tag, model_parallel in (("data2", 1), ("model2", 2)):
            stats = {}
            config = _train_config(model_parallel, tmp / f"ckpt_{tag}")
            state = train_loop.train(config, iter(inputs["train"]),
                                     verbose=False, stats_out=stats,
                                     device="cpu")
            params = mesh_lib.gather_params(state.params)
            out["train_" + tag] = {
                "losses": stats["losses"], "img_s": stats["img_s"],
                "sharded": sum(isinstance(p, torch.distributed.tensor.DTensor)
                               for p in state.net.parameters()),
                "params": {layer: {k: v.numpy().copy()
                                   for k, v in sub.items()}
                           for layer, sub in params.items()}}

    body = zoo.load_pose_model(device="cpu")
    out["coco_eval"] = accuracy.synthetic_coco_eval(model=body, mesh=data,
                                                    **EVAL_KW)
    out["topdown_eval"] = accuracy.synthetic_topdown_eval(
        "hand", mesh=data, **TOPDOWN_KW)

    if inputs["video"] is not None:
        inf = PoseInference(_port_model(weights["MPI_15_4"], "MPI_15_4"),
                            mesh=data, compute_dtype=torch.float32,
                            net_hw=(48, 64), max_peaks=16)
        out["video"] = [(r.index, r.keypoints, r.scores)
                        for r in VideoRunner(inf, batch_size=2).run_video(
                            inputs["video"])]
        wb = WholeBodyInference(
            _port_model(weights["MPI_15_4"], "MPI_15_4"), face, None,
            mesh=data, frame_hw=(48, 64), net_hw=(48, 64), people_cap=2,
            max_peaks=16, face_net_size=32, compute_dtype=torch.float32)
        out["video_wb"] = [(i, r.pose_keypoints, r.face_keypoints)
                           for i, r in VideoRunner.run_video_whole_body(
                               wb, inputs["video"], batch_size=2)]
    return out


def _four_rank_job(rank, tmp, inputs):
    from openpose_tpu_torch.parallel.dryrun import dryrun_multichip
    with torch.backends.mkldnn.flags(enabled=False):
        return dryrun_multichip(4, device="cpu")


def _worker(rank, world, job, init_file, tmp):
    """One rank: waits for its inputs (`_hand_over`), runs `job`, writes
    what it found."""
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(1)
    deadline = time.monotonic() + JOIN_SECONDS
    while not (tmp / "inputs.pkl").exists():
        assert time.monotonic() < deadline, "no inputs came"
        time.sleep(0.1)
    with open(tmp / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    with mesh_lib.process_group(init_file, world, rank, "cpu"):
        out = job(rank, tmp, inputs)
    with open(tmp / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _start(tmp, world, job):
    """Start the ranks of a world; they start working once `_hand_over`
    gave them their inputs (so that they start up while this process
    makes them)."""
    return mp.start_processes(
        _worker, args=(world, job, str(tmp / "init"), tmp),
        nprocs=world, join=False, start_method="spawn")


def _hand_over(tmp, inputs):
    with open(tmp / "inputs.tmp", "wb") as f:
        pickle.dump(inputs, f)
    (tmp / "inputs.tmp").rename(tmp / "inputs.pkl")


def _join(ctx, tmp, world):
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "gloo ranks did not finish"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    out = []
    for rank in range(world):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jax_models():
    return {"MPI_15_4": jzoo.load_pose_model(JaxPoseModel.MPI_15_4),
            "BODY_25": jzoo.load_pose_model(), "face": jzoo.load_face_model(),
            "hand": jzoo.load_hand_model()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory, jax_models):
    tmp = tmp_path_factory.mktemp("sharded_inputs")
    return {"weights": _weights(tmp, jax_models), "frames": _frames(),
            "td_frames": _frames(1, (96, 128)), "transforms": _transforms(),
            "injected": _injected(), "train": _train_batches(),
            "video": _video(tmp)}


def _references(jax_models, inputs, tmp):
    """The JAX package's sharded calls on a 2-device mesh, and the port's
    calls without a mesh."""
    mesh = jmesh.make_mesh(jax.devices()[:2], model=1)
    out = {}
    for name in ("MPI_15_4", "BODY_25"):
        inf = ShardedPoseInference(jax_models[name], mesh,
                                   compute_dtype=jnp.float32, **INFER_KW)
        out[name] = [np.asarray(a) for a in inf(inputs["frames"])]
        out[name + "_dp"] = inf.data_parallelism
    out["topdown"] = np.asarray(ShardedTopDown(
        jax_models["face"], mesh, net_size=TD_NET, people_cap=2,
        compute_dtype=jnp.float32)(inputs["td_frames"],
                                   inputs["transforms"]))
    frames, net_output = inputs["injected"]
    out["whole_body"] = ShardedWholeBody(
        jax_models["BODY_25"], jax_models["face"], jax_models["hand"],
        mesh=mesh, frame_hw=None, net_hw=WB_HW, people_cap=2,
        face_net_size=TD_NET, hand_net_size=TD_NET, net_bypass=True,
        compute_dtype=jnp.float32)(frames, net_output=net_output)

    weights = inputs["weights"]
    for name in ("MPI_15_4", "BODY_25"):
        inf = PoseInference(_port_model(weights[name], name),
                            compute_dtype=torch.float32, **INFER_KW,
                            device="cpu")
        out["port_" + name] = _numpy(inf(inputs["frames"]))
        out["port_fetch_" + name] = [inf.fetch(*inf(inputs["frames"][rows]))
                                     for rows in (slice(0, 2), slice(2, 4))]
    with torch.backends.mkldnn.flags(enabled=False):
        stats = {}
        state = train_loop.train(_train_config(1, tmp / "ckpt"),
                                 iter(inputs["train"]), verbose=False,
                                 stats_out=stats, device="cpu")
        out["train"] = stats, state.params
        out["step"] = _first_step(inputs["train"][0])
    out["coco_eval"] = accuracy.synthetic_coco_eval(
        model=zoo.load_pose_model(device="cpu"), device="cpu", **EVAL_KW)
    out["topdown_eval"] = accuracy.synthetic_topdown_eval(
        "hand", device="cpu", **TOPDOWN_KW)
    if inputs["video"] is not None:
        mpi = _port_model(weights["MPI_15_4"], "MPI_15_4")
        inf = PoseInference(mpi, compute_dtype=torch.float32,
                            net_hw=(48, 64), max_peaks=16, device="cpu")
        out["video"] = VideoRunner(inf, batch_size=2).run_video(
            inputs["video"])
        wb = WholeBodyInference(
            mpi, _port_model(weights["face"], "face"), None,
            frame_hw=(48, 64), net_hw=(48, 64), people_cap=2, max_peaks=16,
            face_net_size=32, compute_dtype=torch.float32, device="cpu")
        out["video_wb"] = VideoRunner.run_video_whole_body(
            wb, inputs["video"], batch_size=2)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, request):
    """The two-rank and the four-rank world run at once, while this
    process makes the inputs and the JAX references: (what each of the two
    ranks found, what each of the four found, the references)."""
    tmp2 = tmp_path_factory.mktemp("sharded2")
    tmp4 = tmp_path_factory.mktemp("sharded4")
    ctx2 = _start(tmp2, 2, _two_rank_job)
    ctx4 = _start(tmp4, 4, _four_rank_job)
    try:
        _hand_over(tmp4, None)
        inputs = request.getfixturevalue("inputs")
        _hand_over(tmp2, inputs)
        references = _references(request.getfixturevalue("jax_models"),
                                 inputs, tmp_path_factory.mktemp("refs"))
    finally:
        ranks2 = _join(ctx2, tmp2, 2)
        ranks4 = _join(ctx4, tmp4, 4)
    return ranks2, ranks4, references


@pytest.fixture(scope="module")
def ranks(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def ranks4(worlds):
    return worlds[1]


@pytest.fixture(scope="module")
def refs(worlds):
    return worlds[2]


def _gathered(ranks, key):
    """The ranks' outputs of `key` put back in row order (rank r's rows
    are rows[r])."""
    return [np.concatenate([r[key][i] for r in ranks])
            for i in range(len(ranks[0][key]))]


# --- serving ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["MPI_15_4", "BODY_25"])
def test_data_mesh_equals_sharded_jax(ranks, refs, name):
    assert [r["rows"] for r in ranks] == [slice(0, 2), slice(2, 4)]
    got_peaks, got_scores = _gathered(ranks, name)
    want_peaks, want_scores = refs[name]
    assert got_peaks.shape == want_peaks.shape
    assert got_scores.shape == want_scores.shape
    assert want_peaks[:, :, 0, 0].sum() > 0, "the frames must give peaks"
    np.testing.assert_array_equal(got_peaks[:, :, 0, 0],
                                  want_peaks[:, :, 0, 0])
    np.testing.assert_allclose(got_peaks, want_peaks, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4,
                               atol=1e-4)
    for r in ranks:
        assert r[name + "_dp"] == refs[name + "_dp"] == 2


@pytest.mark.parametrize("name", ["MPI_15_4", "BODY_25"])
def test_data_mesh_equals_the_port_without_a_mesh(ranks, refs, name):
    for got, w in zip(_gathered(ranks, name), refs["port_" + name]):
        np.testing.assert_array_equal(got, w)
    # fetch works on each rank's own outputs
    for r, want in zip(ranks, refs["port_fetch_" + name]):
        for got, w in zip(r[name + "_fetch"], want):
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("name", ["MPI_15_4", "BODY_25"])
def test_data_mesh_runs_no_collective(ranks, name):
    for r in ranks:
        assert r[name + "_collectives"] == {"dist_calls": {}, "traced": 0,
                                            "nccl_kernels": 0}


def test_model_mesh_equals_the_port_without_a_mesh(ranks, refs):
    """model=2: the weights sharded by their output channels and gathered
    at use (so this call does run collectives: the counter sees them)."""
    for r in ranks:
        for got, w in zip(r["model2"], refs["port_BODY_25"]):
            np.testing.assert_array_equal(got, w)
        assert r["model2_collectives"]["traced"] > 0


def test_a_batch_that_does_not_tile_the_mesh_raises(ranks):
    for r in ranks:
        assert r["tile_error"] == r["runner_tile_error"] \
            == "batch 3 does not tile the mesh's 2 data shards"


def test_topdown_on_a_data_mesh_equals_sharded_jax(ranks, inputs, refs):
    got = np.concatenate([r["topdown"] for r in ranks])
    want = refs["topdown"]
    assert got.shape == want.shape == (FRAMES, 2, 71, 3)
    # the active slots: what an inactive one holds differs (zeros after a
    # rank's last active slot, a black crop's peaks in JAX's program)
    active = inputs["transforms"][..., 2] > -1e5
    assert active.sum() == FRAMES + 1
    np.testing.assert_allclose(got[active][..., :2], want[active][..., :2],
                               atol=1e-2)
    np.testing.assert_allclose(got[active][..., 2], want[active][..., 2],
                               atol=1e-4)


def test_whole_body_on_a_data_mesh_equals_sharded_jax(ranks, refs):
    want = refs["whole_body"]
    assert [r["wb_rows"] for r in ranks] == [slice(0, 1), slice(1, 2)]
    got = [res for r in ranks for res in r["whole_body"]]
    assert len(got) == len(want) == 2
    for (pose, scores, face, left, right), w in zip(got, want):
        assert pose.shape == (2, 25, 3)
        np.testing.assert_allclose(pose, w.pose_keypoints, atol=1e-3)
        np.testing.assert_allclose(scores, w.pose_scores, rtol=1e-5)
        assert np.any(face[..., 2] != 0)
        for g, wk in ((face, w.face_keypoints),
                      (left, w.hand_left_keypoints),
                      (right, w.hand_right_keypoints)):
            np.testing.assert_allclose(g[..., :2], wk[..., :2], atol=1e-2)
            np.testing.assert_allclose(g[..., 2], wk[..., 2], atol=1e-4)


def test_runner_over_a_data_mesh_equals_the_runner_without(ranks, refs):
    if "video" not in refs:
        pytest.skip("needs OpenCV and the native frame pump")
    want = refs["video"]
    # rank 0 has frames 0, 2, 4, rank 1 frames 1, 3
    assert [i for i, _, _ in ranks[0]["video"]] == [0, 2, 4]
    assert [i for i, _, _ in ranks[1]["video"]] == [1, 3]
    got = sorted((row for r in ranks for row in r["video"]),
                 key=lambda row: row[0])
    assert [i for i, _, _ in got] == [w.index for w in want]
    for (_, kp, sc), w in zip(got, want):
        np.testing.assert_allclose(kp, w.keypoints, atol=1e-4)
        np.testing.assert_allclose(sc, w.scores, atol=1e-5)
    want = refs["video_wb"]
    got = sorted((row for r in ranks for row in r["video_wb"]),
                 key=lambda row: row[0])
    assert [i for i, _, _ in got] == [i for i, _ in want] == list(range(5))
    for (_, pose, face), (_, w) in zip(got, want):
        np.testing.assert_allclose(pose, w.pose_keypoints, atol=1e-4)
        if w.face_keypoints is not None:
            np.testing.assert_allclose(face, w.face_keypoints, atol=1e-4)


# --- training and the accuracy loops ----------------------------------------


@pytest.mark.parametrize("tag", ["data2", "model2"])
def test_sharded_trainer_equals_the_one_process_trainer(ranks, refs, tag):
    stats, params = refs["train"]
    for r in ranks:
        got = r["train_" + tag]
        assert got["losses"].keys() == stats["losses"].keys()
        for step, loss in stats["losses"].items():
            assert got["losses"][step] == pytest.approx(loss, rel=1e-5)
        scale = max(float(w.abs().max()) for sub in params.values()
                    for w in sub.values())
        lr = _train_config(1, "").learning_rate
        off = total = 0
        for layer, sub in params.items():
            for key, want in sub.items():
                diff = np.abs(got["params"][layer][key] - want.numpy())
                assert diff.max() <= 2 * lr * TRAIN_STEPS, (layer, key)
                off += int((diff > 1e-5 * scale).sum())
                total += diff.size
        assert off <= 1e-4 * total, f"{off} of {total} params differ"
        # the rates count the global batch
        assert got["img_s"] > 0
        if tag == "model2":
            assert got["sharded"] > 0
            for layer, sub in params.items():
                for key, want in sub.items():
                    np.testing.assert_array_equal(
                        got["params"][layer][key], want.numpy())
        else:
            assert got["sharded"] == 0
    # rank 0 alone wrote the one checkpoint, of the gathered params
    files = sorted((ranks[0]["tmp"] / f"ckpt_{tag}").iterdir())
    assert [f.name for f in files] == [f"MPI_15_4_step{TRAIN_STEPS}.npz"]
    saved = checkpoint.load_npz(str(files[0]))
    for layer, sub in ranks[0]["train_" + tag]["params"].items():
        for key, val in sub.items():
            np.testing.assert_array_equal(saved[layer][key].numpy(), val)


def test_accuracy_loops_over_a_data_mesh_equal_one_process(ranks, refs):
    want, want_td = refs["coco_eval"], refs["topdown_eval"]
    assert want["n_detections"] > 0 and want_td["n_instances"] > 0
    for r in ranks:
        assert r["coco_eval"] == want
        assert r["topdown_eval"] == want_td


def test_sharded_step_has_the_one_process_gradients(ranks, refs):
    """One step over the data ranks: their gradients averaged (the global
    batch's mean loss).  (The model ranks' step is the one-process step bit
    for bit: `test_sharded_trainer_equals_the_one_process_trainer`.)"""
    loss, grads = refs["step"]
    for r in ranks:
        got_loss, got = r["step_data2"]
        assert got.keys() == grads.keys()
        assert got_loss == pytest.approx(loss, rel=1e-5)
        for name, want in grads.items():
            np.testing.assert_allclose(got[name], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)


# --- the 2x2 world ----------------------------------------------------------


def test_dryrun_multichip_on_a_two_by_two_world(ranks4):
    """Every rank of four ran every path; the train step's loss equals the
    one-process step on the global batch (one row a data rank)."""
    info = __import__("openpose_tpu_torch.params", fromlist=["x"]) \
        .POSE_MODEL_INFO[PoseModel.BODY_25]
    spec = graph.load_spec(info.spec)
    with torch.backends.mkldnn.flags(enabled=False):
        state = train.init_train_state(spec, torch.Generator().manual_seed(0),
                                       1e-4, "cpu")
        pairs, map_idx = (torch.from_numpy(t)
                          for t in paf.pair_tables(info))
        keypoints = torch.zeros((2, 4, info.num_parts, 3))
        keypoints[..., :2] = 20.0
        keypoints[..., 2] = 1.0
        targets = train.make_targets(keypoints, pairs, map_idx, (64, 64),
                                     info.num_parts, info.heatmap_channels)
        _, loss = train.make_train_step(torch.float32)(
            state, torch.zeros((2, 64, 64, 3)), targets)
    for got in ranks4:
        assert got["mesh"] == [2, 2]
        assert got["step"] == 1
        assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
        assert got["inference"]["peaks"] == [1, 15, 17, 3]
        assert got["inference"]["collectives"]["traced"] == 0
        assert got["bundle_mean_abs_dp"] < 0.05
        assert got["whole_body"]["face"] == [1, 2, 71, 3]
        assert got["whole_body"]["hand"] == [1, 4, 22, 3]
        assert got["injected"]["people"] >= got["injected"]["frames"] == 1
    assert ranks4[0]["loss"] == ranks4[3]["loss"]
