"""`openpose_tpu_torch/bench.py` against the repository's `bench.py`, on
the CPU.

`main(["--cpu", "--rehearse"])` runs every row at tiny shapes and prints
one JSON line with the original's keys (without the host-tail keys, which
the original too leaves out where the native pump or the video is
missing), every number finite.  A row that raises makes the run raise and
prints no row.  The roofline guard withholds a rate above 1.02x the
card's bf16 peak, and a withheld row publishes 0.0.  The headline's
synthetic targets are the original's draw through the original's
renderer.  The rehearsal's timings are CPU noise and are held to nothing
but being finite.
"""

import ast
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_tpu import train as jtrain
from openpose_tpu.ops import paf as jpaf
from openpose_tpu_torch import bench
from openpose_tpu_torch.device import NoCudaDeviceError
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel

ROOT = pathlib.Path(__file__).resolve().parents[1]
REHEARSE = ["--cpu", "--rehearse"]
TAIL_KEYS = {"host_tail_fps", "tail_only_fps"}
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two threads per worker: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def original_keys():
    """The string keys of every dict literal in the repository's
    `bench.py`: its JSON row and the rows merged into it."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    return {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
            for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


@pytest.fixture
def untimed(monkeypatch):
    """Chains that return 1.0 ms at once, and the labels they were asked
    for: the rows around them run as they are."""
    labels = []

    def chained(label, step, device, chain, shapes, traces):
        labels.append(label)
        traces[label] = {"chain_ms": 1.0, "trace": None}
        return 1.0
    monkeypatch.setattr(bench, "_chained", chained)
    return labels


def test_rehearsal_prints_one_row_with_the_original_keys(capsys):
    row, traces = bench.main(REHEARSE)
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == row
    assert set(row) == original_keys() - TAIL_KEYS
    assert len(original_keys()) == 35
    for key, value in row.items():
        if key in ("metric", "unit", "device_kind"):
            assert isinstance(value, str)
        else:
            assert isinstance(value, (int, float)) and math.isfinite(value), \
                (key, value)
    assert row["device_kind"] == "cpu" and row["cnn_mfu"] == 0.0
    assert row["e2e_disk_to_keypoints_fps"] == 0.0
    assert row["e2e_colocated_est_fps"] == 0.0
    # the two media-bound rows say why they did not run
    assert captured.err.count("no --video given; not measured") == 2
    # every chained row: net and three post contents, batch 1 (2), whole
    # body (4), 4 scales
    assert len(traces) == 11
    assert all(math.isfinite(t["chain_ms"]) and t["trace"] is None
               for t in traces.values())


@pytest.mark.parametrize("row", [
    "headline_inputs", "_bench_batch1", "_bench_whole_body",
    "_bench_multiscale", "_bench_end_to_end", "_bench_host_tail",
    "_bench_synthetic_ap", "_bench_topdown_accuracy"])
def test_a_row_that_fails_fails_the_run(row, untimed, monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError(f"{row} broke")
    monkeypatch.setattr(bench, row, broken)
    with pytest.raises(RuntimeError, match=f"{row} broke"):
        bench.main(REHEARSE)
    assert capsys.readouterr().out == ""


def test_roofline_guard_withholds_above_1_02_of_the_peak():
    peak = 989.4                         # H100 SXM dense bf16, TFLOP/s
    assert bench._roofline_ok("ok", 1.019 * peak, 1.0, H100)
    assert not bench._roofline_ok("over", 1.021 * peak, 1.0, H100)
    assert not bench._roofline_ok("over", 2.1 * peak, 2.0, H100)
    # no basis: no rate in the table, or no time
    assert bench._roofline_ok("cpu", 1e9, 1.0, "cpu")
    assert bench._roofline_ok("zero", 1.0, 0.0, H100)


def test_withheld_rows_publish_zero(untimed, monkeypatch, capsys):
    monkeypatch.setattr(bench, "_roofline_ok", lambda *args: False)
    row, _ = bench.main(REHEARSE)
    for key in ("value", "vs_baseline", "whole_body_fps",
                "whole_body_typical_fps", "multiscale4_fps"):
        assert row[key] == 0.0, key
    assert row["worst_case_fps"] > 0 and row["batch1_fps"] > 0
    # the headline was measured once more on a longer chain first
    assert untimed.count("net (batch 2)") == 1
    assert untimed.count("net (batch 2, longer chain)") == 1


def test_without_a_card_main_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--rehearse"]):
        with pytest.raises(NoCudaDeviceError):
            bench.main(argv)


def test_headline_inputs_are_the_originals_draw():
    """`bench.py:63-80`'s images and 8-person targets, drawn as it draws
    them and rendered by the original's `train.make_targets`."""
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    shapes = bench.REHEARSAL
    (h, w), batch = shapes.net_hw, shapes.batch
    images, sources = bench.headline_inputs(info, torch.device("cpu"), shapes)
    rng = np.random.RandomState(0)
    want_images = rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32)
    kp = np.zeros((batch, 8, info.num_parts, 3), np.float32)
    for b in range(batch):
        for p in range(8):
            cx = rng.uniform(60, w - 60)
            cy = rng.uniform(80, h - 80)
            kp[b, p, :, 0] = cx + rng.uniform(-40, 40, info.num_parts)
            kp[b, p, :, 1] = cy + rng.uniform(-70, 70, info.num_parts)
            kp[b, p, :, 2] = 1.0
    pairs, map_idx = (jnp.asarray(t) for t in jpaf.pair_tables(info))
    want = np.asarray(jtrain.make_targets(
        jnp.asarray(kp), pairs, map_idx, (h, w), info.num_parts,
        info.heatmap_channels))
    np.testing.assert_array_equal(images.numpy(), want_images)
    np.testing.assert_allclose(sources["synth"].numpy(), want, rtol=0,
                               atol=1e-6)
    assert {k: tuple(v.shape) for k, v in sources.items()} == {
        k: (batch, h // 8, w // 8, info.heatmap_channels)
        for k in ("synth", "crowd", "worst")}


def test_worst_case_fills_every_part_at_the_published_size():
    """At 368x656 the noise input gives 127 peaks in every part, and the
    8-person and crowd inputs far fewer (one frame of each)."""
    info = POSE_MODEL_INFO[PoseModel.BODY_25]
    device = torch.device("cpu")
    _, sources = bench.headline_inputs(info, device, bench.PUBLISHED)
    post = bench.Post(info, bench.PUBLISHED.net_hw, device)
    counts = {k: post(v[:1])[0][0, :, 0, 0] for k, v in sources.items()}
    assert bool((counts["worst"] == 127).all()), counts["worst"]
    assert 4 <= float(counts["synth"].mean()) <= 12, counts["synth"]
    assert 16 <= float(counts["crowd"].mean()) <= 40, counts["crowd"]


def test_media_rows_run_with_the_pump_and_a_video(untimed, tmp_path):
    """With the native pump built and a video given, the host-tail and
    disk-to-keypoints rows run, and the row has every key of the
    original's."""
    import cv2
    from openpose_tpu_torch.io import native_loader
    if not native_loader.available():
        pytest.skip("native frame pump not built")
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (96, 64))
    rng = np.random.RandomState(0)
    for _ in range(12):
        writer.write(rng.randint(0, 255, (64, 96, 3), np.uint8))
    writer.release()
    row, _ = bench.main(REHEARSE + ["--video", path])
    assert set(row) == original_keys()
    assert row["host_tail_fps"] > 0 and row["tail_only_fps"] > 0
    assert row["e2e_disk_to_keypoints_fps"] > 0
    assert row["e2e_colocated_est_fps"] == round(
        min(row["value"], row["host_tail_fps"]), 2)
    # a video that is not there: not measured, and said so
    missing = str(tmp_path / "missing.avi")
    cpu = torch.device("cpu")
    assert bench._bench_end_to_end(None, cpu, bench.REHEARSAL, missing) == 0.0
    assert bench._bench_host_tail(None, None, cpu, bench.REHEARSAL,
                                  missing) == {}
