"""The port's closed accuracy loop vs the JAX package's (CPU, float32).

`synthetic_coco_eval` and `synthetic_topdown_eval` of both packages run on
the same scenes (numpy `RandomState(seed)`), the JAX side as its own tests
run it on the CPU.  Without noise and jitter the two see the same net
outputs, so they are held to the same detections and the same AP; with
noise or jitter each draws from its own generator and they are held to the
AP they reach.

Tolerances: AP 1e-6 (the evaluator is the same code on detections that
agree to 1e-3 px, and no OKS threshold sits that close); keypoints 1e-3 px
and scores 1e-3 (resize products and tap sums in another order, then the
saver's rounding to three decimals); face and hand RMSE 0.05 px.
"""

import numpy as np
import pytest
import torch

from openpose_tpu import accuracy as jaccuracy
from openpose_tpu import scenes as jscenes
from openpose_tpu.io import coco_eval as jcoco_eval
from openpose_tpu.models import zoo as jzoo
from openpose_tpu_torch import accuracy, synthetic, train_loop
from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.io import coco_eval
from openpose_tpu_torch.models import checkpoint, graph, zoo
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """(JAX BODY_25, port BODY_25).  The closed loop bypasses the CNN, so
    the weights play no part; each package loads its own."""
    return jzoo.load_pose_model(), zoo.load_pose_model(device="cpu")


def _detections(rng, n_images, hw=(368, 656)):
    """Seeded detections and ground truth: placed people, detected with a
    localization error that grows from image to image, some missed, some
    spurious, one crowd annotation and one without visible keypoints."""
    gts, dets = [], []
    for image_id in range(n_images):
        people = jscenes.random_people(rng, rng.randint(1, 4), hw)
        gts.extend(jscenes.coco_ground_truth(people, image_id))
        for person in people:
            if rng.rand() < 0.2:
                continue                                 # a miss
            kp = person[jscenes.COCO_ORDER_25].copy()
            kp[:, :2] += rng.normal(0, 1.0 + 2.0 * image_id, (17, 2))
            dets.append({"image_id": image_id, "category_id": 1,
                         "keypoints": kp.reshape(-1).tolist(),
                         "score": float(rng.uniform(0.2, 1.0))})
        if rng.rand() < 0.5:                             # a spurious one
            kp = np.concatenate([rng.uniform(0, 300, (17, 2)),
                                 np.ones((17, 1))], axis=1)
            dets.append({"image_id": image_id, "category_id": 1,
                         "keypoints": kp.reshape(-1).tolist(),
                         "score": float(rng.uniform(0.0, 0.5))})
    gts[0]["iscrowd"] = 1
    gts[-1]["num_keypoints"] = 0
    gts[-1]["keypoints"] = [0.0] * 51
    return dets, gts


@pytest.mark.parametrize("seed,n_images", [(0, 6), (1, 3), (2, 10)])
def test_coco_evaluate_equals_jax(seed, n_images):
    dets, gts = _detections(np.random.RandomState(seed), n_images)
    got = coco_eval.evaluate(dets, gts)
    want = jcoco_eval.evaluate(dets, gts)
    assert got == want
    assert 0.0 < got["AP"] < 1.0 and got["AP50"] >= got["AP75"]
    assert coco_eval.evaluate([], gts) == jcoco_eval.evaluate([], gts)
    kp = np.asarray(dets[0]["keypoints"]).reshape(17, 3)
    gt = np.asarray(gts[1]["keypoints"]).reshape(17, 3)
    assert coco_eval.oks(kp, gt, gts[1]["area"], gts[1]["bbox"]) \
        == jcoco_eval.oks(kp, gt, gts[1]["area"], gts[1]["bbox"])


def test_coco_ground_truth_equals_jax():
    people = jscenes.random_people(np.random.RandomState(3), 3, (368, 656))
    assert synthetic.coco_ground_truth(people, 7) \
        == jscenes.coco_ground_truth(people, 7)
    assert synthetic.COCO_ORDER_25 == jscenes.COCO_ORDER_25


def _capture(monkeypatch, module):
    """Keep the (detections, ground truth) that `module.evaluate` is given."""
    seen = {}
    real = module.evaluate

    def evaluate(detections, ground_truth, *args, **kwargs):
        seen["detections"], seen["ground_truth"] = detections, ground_truth
        return real(detections, ground_truth, *args, **kwargs)
    monkeypatch.setattr(module, "evaluate", evaluate)
    return seen


@pytest.mark.parametrize("net_hw,n_images,batch", [((176, 320), 6, 4),
                                                   ((368, 656), 2, 2)])
def test_synthetic_coco_eval_equals_jax(monkeypatch, models, net_hw,
                                        n_images, batch):
    """Clean scenes (1-4 people a frame; the last batch padded): the same
    detections, the same ground truth, the same AP."""
    jmodel, model = models
    jseen = _capture(monkeypatch, jcoco_eval)
    seen = _capture(monkeypatch, coco_eval)
    want = jaccuracy.synthetic_coco_eval(
        n_images=n_images, net_hw=net_hw, batch=batch, seed=4, model=jmodel)
    got = accuracy.synthetic_coco_eval(
        n_images=n_images, net_hw=net_hw, batch=batch, seed=4, model=model,
        device="cpu")
    assert seen["ground_truth"] == jseen["ground_truth"]
    assert len(seen["detections"]) == len(jseen["detections"]) > 0
    for det, jdet in zip(seen["detections"], jseen["detections"]):
        assert det["image_id"] == jdet["image_id"]
        # 1e-3 px: one step of the saver's rounding to three decimals,
        # which a far smaller difference can tip
        np.testing.assert_allclose(det["keypoints"], jdet["keypoints"],
                                   rtol=0, atol=1e-3 + 1e-9)
        assert det["score"] == pytest.approx(jdet["score"], abs=1e-3 + 1e-9)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-6), key
    assert got["AP"] >= 0.9 and got["n_gt"] == got["n_detections"]


def test_jitter_and_noise_degrade_like_jax(models):
    """Other draws in the two packages, so the comparison is by AP: 4 px of
    keypoint jitter leaves everybody found and costs AP at the tight
    thresholds, in both; correlated map noise of 0.1 costs little."""
    jmodel, model = models
    kwargs = dict(n_images=8, net_hw=(176, 320), batch=8, seed=2)
    clean = accuracy.synthetic_coco_eval(model=model, device="cpu", **kwargs)
    jittered, noisy = accuracy.jitter_sweep(
        levels=(4.0,), model=model, device="cpu", **kwargs) \
        + accuracy.noise_sweep(levels=(0.1,), model=model, device="cpu",
                               **kwargs)
    jjittered = jaccuracy.synthetic_coco_eval(model=jmodel, kp_jitter=4.0,
                                              **kwargs)
    jnoisy = jaccuracy.synthetic_coco_eval(model=jmodel, noise=0.1, **kwargs)
    assert jittered["kp_jitter"] == 4.0 and noisy["noise"] == 0.1
    for run, jrun in ((jittered, jjittered), (noisy, jnoisy)):
        assert run["AP50"] >= 0.9 and jrun["AP50"] >= 0.9, (run, jrun)
        assert abs(run["AP"] - jrun["AP"]) <= 0.15, (run, jrun)
    assert 0.4 < jittered["AP"] < clean["AP"]
    assert noisy["AP"] >= clean["AP"] - 0.15
    # the draws come from the seed: the same call, the same AP
    again = accuracy.synthetic_coco_eval(model=model, device="cpu",
                                         kp_jitter=4.0, **kwargs)
    assert again == jittered


@pytest.mark.parametrize("kind,seed", [("face", 0), ("hand", 1)])
def test_synthetic_topdown_eval_equals_jax(kind, seed):
    kwargs = dict(n_frames=8, net_size=64, batch=8, seed=seed)
    want = jaccuracy.synthetic_topdown_eval(kind, **kwargs)
    got = accuracy.synthetic_topdown_eval(kind, device="cpu", **kwargs)
    assert got["n_instances"] == want["n_instances"] >= 8
    assert got["n_parts"] == want["n_parts"]
    assert got["rmse_px"] == pytest.approx(want["rmse_px"], abs=0.05)
    assert got["max_err_px"] == pytest.approx(want["max_err_px"], abs=0.05)
    assert got["pck05"] == pytest.approx(want["pck05"], abs=1e-3)
    assert got["rmse_px"] < 2.0 and got["pck05"] >= 0.99


def test_held_out_scenes_are_the_jax_evaluations():
    """`train_to_ap` evaluates on the scenes the JAX function makes from
    `seed + 1`: the same people, drawn by the port's renderer."""
    scenes = accuracy.held_out_scenes(3, (96, 160), (1, 3), seed=1)
    rng = np.random.RandomState(1)
    hr = (max(80.0, 96 * 0.45), 96 * 0.9)
    for people, image in scenes:
        want = jscenes.random_people(rng, rng.randint(1, 4), (96, 160),
                                     height_range=hr, min_spacing=60.0)
        np.testing.assert_array_equal(people, want)
        jimage = jscenes.render_scene_image(want, (96, 160), rng=rng)
        assert image.shape == jimage.shape and image.dtype == np.uint8
        assert image.max() > 100


@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    """`train_to_ap` for 2 steps of BODY_25 at 64x96: far too short to
    learn anything, long enough to run every stage once."""
    ckpt_dir = tmp_path_factory.mktemp("t2ap")
    metrics = accuracy.train_to_ap(
        steps=2, image_size=(64, 96), batch=1, n_eval=2, seed=0,
        checkpoint_dir=str(ckpt_dir), lr_schedule="cosine", verbose=False,
        device="cpu")
    return metrics, ckpt_dir


def test_train_to_ap_runs_train_checkpoint_serve_score(short_run):
    metrics, ckpt_dir = short_run
    for key in ("AP", "AP50", "AP75", "AR"):
        assert 0.0 <= metrics[key] <= 1.0, key
    assert metrics["steps"] == 2 and metrics["n_eval"] == 2
    assert metrics["lr_schedule"] == "cosine"
    assert 2 <= metrics["n_gt"] <= 6 and metrics["n_detections"] >= 0
    assert set(metrics["losses"]) == {0, 1}
    assert all(np.isfinite(v) for v in metrics["losses"].values())
    for key in ("img_s", "step_ms", "device_step_ms", "device_img_s"):
        assert metrics[key] > 0, key
    # the checkpoint of the run serves in a model of its own
    path = ckpt_dir / "BODY_25_step2.npz"
    assert [p.name for p in ckpt_dir.iterdir()] == [path.name]
    model = zoo.from_params(graph.load_spec("body_25"),
                            checkpoint.load_npz(str(path)),
                            POSE_MODEL_INFO[PoseModel.BODY_25], device="cpu")
    x = torch.zeros((1, 64, 96, 3))
    with torch.inference_mode():
        out = model.forward(x)
    assert tuple(out.shape) == (1, 8, 12, 78) and bool(out.isfinite().all())
    assert not out.requires_grad


def test_a_failing_probe_fails_train_to_ap(monkeypatch, tmp_path):
    """The JAX function swallows a failing device probe; the port's raises
    it."""
    def probe(*args, **kwargs):
        raise RuntimeError("the probe failed")
    monkeypatch.setattr(train_loop, "device_step_probe", probe)
    with pytest.raises(RuntimeError, match="the probe failed"):
        accuracy.train_to_ap(steps=1, image_size=(48, 64), batch=1, n_eval=1,
                             checkpoint_dir=str(tmp_path), verbose=False,
                             device="cpu")


@pytest.mark.parametrize("entry", [
    lambda: accuracy.synthetic_coco_eval(n_images=1),
    lambda: accuracy.synthetic_topdown_eval("face", n_frames=1),
    lambda: accuracy.synthetic_topdown_eval("hand", n_frames=1),
    lambda: accuracy.train_to_ap(steps=1),
    lambda: accuracy.noise_sweep(levels=(0.0,), n_images=1),
    lambda: accuracy.jitter_sweep(levels=(0.0,), n_images=1),
], ids=["synthetic_coco_eval", "topdown_face", "topdown_hand", "train_to_ap",
        "noise_sweep", "jitter_sweep"])
def test_accuracy_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(device_rule.NoCudaDeviceError):
        entry()
