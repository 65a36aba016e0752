"""The comparison that decides `correct`: a run with the timed path broken
underneath, the chip's check skipped (--cpu), reads `correct` false; the
control, the reference one precision down, fails it too."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from openpose_tpu_torch.parallel.inference import PoseInference
from openpose_tpu_torch.runtime.whole_body import WholeBodyInference
from perfbench import control, loops, run


def _last_line(workload, seed=77):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "1", "--trace", "0", "--cpu"])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct():
    assert _last_line("body25.video_b8")["correct"] is True


def test_an_altered_keypoint_fails(monkeypatch):
    real = PoseInference.assemble

    def altered(self, peaks, scores, *a):
        kp, s = real(self, peaks, scores, *a)
        if len(kp):
            kp = kp.copy()
            kp[0, 3, 0] += 0.5
        return kp, s
    monkeypatch.setattr(PoseInference, "assemble", altered)
    out = _last_line("body25.video_b8")
    assert out["correct"] is False
    assert out["checks"]["keypoint_gap"]["value"] >= 0.5


def test_half_the_batch_left_out_fails(monkeypatch):
    real = PoseInference.fetch_end

    def half(self, handle):
        peaks, scores = real(self, handle)
        keep = max(1, peaks.shape[0] // 2)
        return peaks[:keep], scores[:keep]
    monkeypatch.setattr(PoseInference, "fetch_end", half)
    out = _last_line("body25.video_b8")
    assert out["correct"] is False
    assert out["checks"]["missing_answers"]["value"] > 0


def test_an_altered_cnn_output_fails(monkeypatch):
    real = PoseInference.net_outputs

    def altered(self, images):
        return [s * 1.25 for s in real(self, images)]
    monkeypatch.setattr(PoseInference, "net_outputs", altered)
    out = _last_line("body25.live_b1")
    assert out["correct"] is False
    assert out["checks"]["cnn_rel_err"]["value"] > 0.2


@pytest.mark.parametrize("steps", [40, 3200])
def test_the_cnn_sample_grows_with_the_window_and_spans_it(steps):
    """1 step in `run.CNN_SAMPLE_EVERY` is kept, spread over the window,
    and a window shorter than that still keeps one."""
    every = run.CNN_SAMPLE_EVERY
    sample = loops.Sample(every, np.random.default_rng(1))
    for i in range(steps):
        sample.offer(i)
    kept = sample.items
    assert len(kept) >= max(1, steps // every // 2)
    assert len(kept) <= max(1, 2 * steps // every)
    if steps >= 100 * every:
        assert min(kept) < steps // 4 and max(kept) > 3 * steps // 4
    none = loops.Sample(0, np.random.default_rng(1))
    none.offer(0)
    assert none.items == []


def test_an_altered_face_keypoint_fails(monkeypatch):
    real = WholeBodyInference.face_stage

    def altered(self, frames, results):
        real(self, frames, results)
        for r in results:
            if r.face_keypoints is not None and len(r.face_keypoints):
                r.face_keypoints[0, :, 0] += 24.0
    monkeypatch.setattr(WholeBodyInference, "face_stage", altered)
    out = _last_line("wholebody.video_b8")
    assert out["correct"] is False
    assert out["checks"]["topdown_gap"]["value"] > \
        out["checks"]["topdown_gap"]["limit"]


@pytest.mark.parametrize("workload", ["body25.video_b8",
                                      "wholebody.video_b8"])
def test_control_fails_on_the_cpu(workload):
    got = control.control_numbers(workload, 5, torch.device("cpu"), True)
    assert got["correct"] is False
    assert got["people_per_frame"] > 0
    # each number has an upper reading: the control fails each one
    for name in ("cnn_rel_err", "keypoint_gap"):
        assert got["checks"][name]["value"] > got["checks"][name]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["body25.video_b8", "body25.live_b1",
                                      "wholebody.video_b8"])
def test_control_fails_on_the_card_at_the_cells_size(card, workload):
    for seed in (101, 102, 103):
        got = control.control_numbers(workload, seed, card, False)
        assert got["correct"] is False, got
