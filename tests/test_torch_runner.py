"""The port's throughput runner (`runtime/video_runner.py`) and
`AsyncPipeline` (CPU, float32).

`VideoRunner`'s one batch loop is held to the sequential per-batch path
(`inference(batch)` -> `fetch` -> `assemble`) on the same in-memory frames:
equal results, every frame, in order.  Where the native frame pump is built,
`run_video` and `run_files` are held to the JAX package's runner on a small
clip with the same weights (keypoints within 1e-2 px, scores within 1e-3:
the nets and tap sums run in another order), and `run_video_whole_body` to
the cascade called on the decoded frames.
"""

import threading

import numpy as np
import pytest
import torch

from openpose_tpu.models import zoo as jzoo
from openpose_tpu.params import PoseModel
from openpose_tpu_torch import synthetic
from openpose_tpu_torch.io import native_loader
from openpose_tpu_torch.models import checkpoint, zoo
from openpose_tpu_torch.parallel.inference import PoseInference
from openpose_tpu_torch.runtime import pipeline
from openpose_tpu_torch.runtime.video_runner import FrameResult, VideoRunner

NET_HW = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(jax_model):
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jax_model.params.items()}
    return zoo.from_params(jax_model.spec, checkpoint.from_jax_params(params),
                           jax_model.info, device="cpu")


@pytest.fixture(scope="module")
def models():
    jax_model = jzoo.load_pose_model(PoseModel.BODY_25)
    return jax_model, _port(jax_model)


@pytest.fixture(scope="module")
def inference(models):
    return PoseInference(models[1], net_hw=NET_HW, device="cpu",
                         compute_dtype=torch.float32)


def _scene_frames(count, hw=NET_HW, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([synthetic.render_scene_image(
        synthetic.random_people(rng, 2, hw, height_range=(40, 60)), hw, rng)
        for _ in range(count)])


def _batches(frames, scales, batch_size):
    """(uint8 batch, scales, real count) with the tail batch padded."""
    for i in range(0, len(frames), batch_size):
        batch, scl = frames[i:i + batch_size], scales[i:i + batch_size]
        real = len(batch)
        if real < batch_size:
            pad = batch_size - real
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad, 0)])
            scl = np.concatenate([scl, np.repeat(scl[-1:], pad)])
        yield batch, scl, real


@pytest.mark.parametrize("workers,in_flight", [(1, 2), (4, 2), (2, 4)])
def test_batch_loop_equals_the_sequential_path(inference, workers, in_flight):
    frames = _scene_frames(7)
    scales = np.array([1.0, 0.5, 0.25, 2.0, 1.0, 0.8, 0.0])   # 0: unscaled
    runner = VideoRunner(inference, batch_size=2, assembly_workers=workers,
                         max_in_flight=in_flight)
    sizes = [(96 + i, 64 + i) for i in range(7)]
    got = list(runner._run_batches(_batches(frames, scales, 2),
                                   sizes.__getitem__))
    assert [r.index for r in got] == list(range(7))      # the pad is dropped
    assert [r.source_wh for r in got] == sizes
    index = 0
    for batch, scl, real in _batches(frames, scales, 2):
        peaks, scores = inference.fetch(*inference(batch))
        for bi in range(real):
            s = 1.0 / scl[bi] if scl[bi] > 0 else 1.0
            kp, person_scores = inference.assemble(peaks[bi], scores[bi], s)
            assert isinstance(got[index], FrameResult)
            np.testing.assert_array_equal(got[index].keypoints, kp)
            np.testing.assert_array_equal(got[index].scores, person_scores)
            index += 1
    assert got[0].keypoints.shape[0] > 0
    # a frame scaled by 0.5 on its way in comes back in source pixels
    unit = inference.assemble(*[a[1] for a in inference.fetch(
        *inference(frames[:2]))], 1.0)[0]
    np.testing.assert_allclose(got[1].keypoints[..., :2], 2 * unit[..., :2],
                               rtol=1e-6)


def test_assemble_defaults_to_the_plans_scale(inference):
    peaks, scores = inference.fetch(*inference(_scene_frames(1, seed=2)))
    for got, want in zip(inference.assemble(peaks[0], scores[0]),
                         inference.assemble(peaks[0], scores[0], 1.0)):
        np.testing.assert_array_equal(got, want)


def test_batch_loop_yields_early_and_holds_the_device_back(inference):
    """Results come out while later batches are still being fed, and no
    more than max_in_flight batches of frames wait for assembly."""
    frames = _scene_frames(2, seed=3)
    runner = VideoRunner(inference, batch_size=2, assembly_workers=1,
                         max_in_flight=2)
    fed = []

    def feed():
        for i in range(6):
            fed.append(i)
            yield frames, np.ones(2), 2
    seen_at = {}
    for res in runner._run_batches(feed(), lambda i: (96, 64)):
        seen_at[res.index] = len(fed)
    assert sorted(seen_at) == list(range(12))
    assert seen_at[0] < 6                 # before the feeder ran dry
    # frame i is out before batch i // 2 + 2 * max_in_flight + 1 is fed
    assert all(fed_then <= i // 2 + 5 for i, fed_then in seen_at.items())


def test_batch_loop_passes_an_assembly_error_on(inference):
    runner = VideoRunner(inference, batch_size=2, assembly_workers=2)

    def broken(*args):
        raise ValueError("assembly failed")
    runner._assemble_one = broken
    frames = _scene_frames(2)
    with pytest.raises(ValueError, match="assembly failed"):
        list(runner._run_batches([(frames, np.ones(2), 2)],
                                 lambda i: (96, 64)))
    assert threading.active_count() < 20


# --- the video feeder, with a fake pump -----------------------------------------


class FakePump:
    """`NativeVideoPump.next_batch` over frames in memory; `pops` scripts
    how many frames each pop returns (0: a timeout, None: end of stream)."""

    def __init__(self, frames, pops):
        self.frames, self.pops, self.at = frames, list(pops), 0

    def next_batch(self, n, timeout_ms=10000, out=None):
        count = self.pops.pop(0)
        if count is None:
            return None
        count = min(count, n, len(self.frames) - self.at)
        out[:count] = self.frames[self.at:self.at + count]
        self.at += count
        return count, out, np.full((n,), 0.5)


def test_a_pop_of_no_frames_raises_timeout(inference):
    """`next_batch` answers a timeout with a count of 0 and the end of the
    stream with None: the runner must not spin on the first."""
    runner = VideoRunner(inference, batch_size=4)
    frames = _scene_frames(3)
    feeder = runner._video_batches(FakePump(frames, [3, 0, None]))
    with pytest.raises(TimeoutError):
        list(feeder)
    with pytest.raises(TimeoutError):
        runner._collect(runner._video_batches(FakePump(frames, [0])),
                        lambda i: (96, 64), None)


def test_video_feeder_pads_the_tail_and_stops_at_max_frames(inference):
    runner = VideoRunner(inference, batch_size=4, max_in_flight=2)
    frames = _scene_frames(7, seed=4)
    out = [(b.copy(), s.copy(), r) for b, s, r in runner._video_batches(
        FakePump(frames, [3, 1, 3, None]))]
    assert [r for _, _, r in out] == [4, 3]
    np.testing.assert_array_equal(out[0][0], frames[:4])
    np.testing.assert_array_equal(out[1][0][:3], frames[4:])
    np.testing.assert_array_equal(out[1][0][3], frames[6])    # the pad
    assert (out[1][1] == 0.5).all()
    capped = list(runner._video_batches(FakePump(frames, [4, 4, 4]),
                                        max_frames=5))
    assert [r for _, _, r in capped] == [4, 1]
    seen = []
    results = runner._collect(
        runner._video_batches(FakePump(frames, [4, 3, None])),
        lambda i: (192, 128), seen.append)
    assert [r.index for r in results] == list(range(7)) \
        == [r.index for r in seen]
    assert results[0].source_wh == (192, 128)


def test_upload_buffers_are_plain_memory_on_the_cpu(inference):
    runner = VideoRunner(inference, batch_size=3, max_in_flight=2)
    buffers = runner._upload_buffers()
    assert len(buffers) == 3
    assert all(b.shape == (3, 64, 96, 3) and b.dtype == np.uint8
               for b in buffers)


# --- AsyncPipeline -----------------------------------------------------------------


def test_async_pipeline_defers_the_fetch(inference):
    """`process` returns a callable that ends a `fetch_begin`: it is
    resolved one step behind, in order."""
    frames = _scene_frames(5, seed=5)
    order, out = [], []

    def process(frame):
        handle = inference.fetch_begin(*inference(frame[None]))
        order.append("begin")

        def finish():
            order.append("end")
            peaks, scores = inference.fetch_end(handle)
            return inference.assemble(peaks[0], scores[0])[0]
        return finish
    stats = pipeline.AsyncPipeline(iter(frames), process, out.append,
                                   in_flight=2).run()
    assert stats.frames == 5 and stats.fps > 0 and len(out) == 5
    assert order[:3] == ["begin", "begin", "end"]
    for frame, kp in zip(frames, out):
        peaks, scores = inference.fetch(*inference(frame[None]))
        np.testing.assert_array_equal(
            kp, inference.assemble(peaks[0], scores[0])[0])


def test_async_pipeline_raises_a_consumer_error():
    def consumer(item):
        raise RuntimeError("writer failed")
    with pytest.raises(RuntimeError, match="writer failed"):
        pipeline.AsyncPipeline(range(20), lambda x: x, consumer).run()


# --- against the native pump and the JAX runner ---------------------------------------


def _needs_pump():
    if not native_loader.available():
        pytest.skip("native frame pump not built")


def _make_video(path, frames=10, wh=(64, 48)):
    import cv2
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, wh)
    rng = np.random.RandomState(0)
    for _ in range(frames):
        writer.write(rng.randint(0, 255, (wh[1], wh[0], 3), np.uint8))
    writer.release()


def _assert_results_match(got, want):
    assert [r.index for r in got] == [r.index for r in want]
    for g, w in zip(got, want):
        assert g.source_wh == tuple(w.source_wh)
        assert g.keypoints.shape == w.keypoints.shape
        np.testing.assert_allclose(g.keypoints[..., :2], w.keypoints[..., :2],
                                   atol=1e-2)
        np.testing.assert_allclose(g.keypoints[..., 2], w.keypoints[..., 2],
                                   atol=1e-3)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-3)


@pytest.fixture(scope="module")
def runners(models):
    import jax
    from openpose_tpu.parallel import mesh as mesh_lib
    from openpose_tpu.parallel.inference import ShardedPoseInference
    from openpose_tpu.pose.extractor import PoseExtractor as JaxPoseExtractor
    from openpose_tpu.runtime.video_runner import VideoRunner as JaxRunner
    jax_model, port_model = models
    mesh = mesh_lib.make_mesh(jax.devices()[:1])
    theirs = JaxRunner(
        ShardedPoseInference(jax_model, mesh, net_hw=(48, 48),
                             compute_dtype=jax.numpy.float32),
        JaxPoseExtractor(jax_model), batch_size=4)
    mine = VideoRunner(PoseInference(port_model, net_hw=(48, 48),
                                     device="cpu",
                                     compute_dtype=torch.float32),
                       batch_size=4)
    return mine, theirs


def test_run_video_matches_the_jax_runner(runners, tmp_path):
    _needs_pump()
    mine, theirs = runners
    path = str(tmp_path / "clip.avi")
    _make_video(path, frames=10)
    seen = []
    got = mine.run_video(path, on_result=seen.append)
    want = theirs.run_video(path)
    assert len(got) == 10 and [r.index for r in seen] == list(range(10))
    assert all(r.source_wh == (64, 48) for r in got)
    _assert_results_match(got, want)
    assert sum(r.keypoints.shape[0] for r in got) > 0
    _assert_results_match(mine.run_video(path, frame_step=2, max_frames=3),
                          theirs.run_video(path, frame_step=2, max_frames=3))


def test_run_files_matches_the_jax_runner(runners, tmp_path):
    _needs_pump()
    import cv2
    mine, theirs = runners
    rng = np.random.RandomState(1)
    paths = []
    for i, (h, w) in enumerate([(48, 64), (60, 60), (30, 90), (48, 64),
                                (96, 128), (50, 40)]):
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], rng.randint(0, 255, (h, w, 3), np.uint8))
    got = mine.run_files(paths)
    want = theirs.run_files(paths)
    assert [r.source_wh for r in got] == [(64, 48), (60, 60), (90, 30),
                                          (64, 48), (128, 96), (40, 50)]
    _assert_results_match(got, want)


def test_run_video_whole_body_equals_the_cascade_on_the_frames(models,
                                                               tmp_path):
    _needs_pump()
    from openpose_tpu_torch.runtime.whole_body import WholeBodyInference
    path = str(tmp_path / "clip.avi")
    _make_video(path, frames=5)
    whole_body = WholeBodyInference(
        models[1], zoo.load_face_model(device="cpu"), None,
        frame_hw=(48, 64), net_hw=(48, 64), people_cap=2, face_net_size=32,
        device="cpu", compute_dtype=torch.float32)
    seen = []
    got = VideoRunner.run_video_whole_body(
        whole_body, path, batch_size=2,
        on_result=lambda i, res: seen.append(i))
    assert [i for i, _ in got] == seen == list(range(5))
    pump = native_loader.NativeVideoPump(path, 16, 16)
    frames = np.stack([frame for _, frame, _, _ in pump])
    pump.close()
    want = whole_body(frames[:2]) + whole_body(frames[2:4]) \
        + whole_body(np.stack([frames[4], frames[4]]))[:1]
    for (_, g), w in zip(got, want):
        np.testing.assert_array_equal(g.pose_keypoints, w.pose_keypoints)
        np.testing.assert_array_equal(g.face_keypoints, w.face_keypoints)
