"""The port's top-down refinement vs the JAX package (CPU, float32).

`openpose_tpu.pose.refine` and `openpose_tpu_torch.pose.refine` get the same
numpy inputs and the same weights (JAX's, through the bridge).  On the JAX
side the fused PAF kernel runs as the JAX package runs it on the CPU (Pallas
interpret mode); on the port's side the kernel wrapper runs its plain
version, as it does for every CPU tensor.

Tolerances: the host helpers (`_person_rois`, `_merge_refined`) exact;
`_decode_crops` equal peak counts, peaks rtol = atol = 1e-4 (the sub-pixel
offset divides sums of float32 heat values that differ in their last bits:
2e-4 on a position of 4 px was seen), pair scores rtol 1e-4 / atol 1e-5, the
tolerances of `tests/test_torch_pipeline.py` (the CNN, resize and tap sums
run in another order), on all but at most 8 of the 840k scores, which may
differ by up to 1e-2 (2 did, by 2.5e-3: one line sample on the threshold);
`refine_prediction` the same people, keypoints within 1e-2 px and scores
within 1e-3.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openpose_tpu.models import zoo as jzoo
from openpose_tpu.params import PoseModel
from openpose_tpu.pose import refine as jrefine
from openpose_tpu.pose.extractor import PoseExtractor as JaxPoseExtractor
from openpose_tpu_torch import synthetic
from openpose_tpu_torch.models import checkpoint, zoo
from openpose_tpu_torch.pose import refine
from openpose_tpu_torch.pose.extractor import PoseExtractor


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def extractors():
    jax_model = jzoo.load_pose_model(PoseModel.BODY_25)
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jax_model.params.items()}
    port_model = zoo.from_params(jax_model.spec,
                                 checkpoint.from_jax_params(params),
                                 jax_model.info, device="cpu")
    return (JaxPoseExtractor(jax_model, compute_dtype=jnp.float32),
            PoseExtractor(port_model, compute_dtype=torch.float32,
                          device="cpu"))


def test_thresholds_equal():
    assert refine.NMS_THRESHOLD_REFINED == jrefine.NMS_THRESHOLD_REFINED
    assert refine.INTER_THRESHOLD_REFINED == jrefine.INTER_THRESHOLD_REFINED


@pytest.mark.parametrize("net_wh,scale", [
    ((656, 368), 1.0), ((656, 368), 1.9512), ((160, 96), 1.5), ((96, 160), 2.0),
    ((368, 368), 1.0)])
def test_person_rois_equal(net_wh, scale):
    """Seeded people of many sizes: small ones get a ROI, one that fills the
    net input does not, one without keypoints is skipped."""
    rng = np.random.RandomState(net_wh[0] + int(scale * 10))
    hw = (int(net_wh[1] * scale), int(net_wh[0] * scale))
    people = np.concatenate([
        synthetic.random_people(rng, 3, hw,
                                height_range=(0.2 * hw[0], 0.5 * hw[0])),
        synthetic.random_people(rng, 1, hw,
                                height_range=(0.95 * hw[0], 0.99 * hw[0])),
        np.zeros((1, 25, 3), np.float32)])
    people[0, 10:, 2] = 0.01          # half a person
    got = refine._person_rois(people, 0.05, scale, net_wh)
    want = jrefine._person_rois(people, 0.05, scale, net_wh)
    assert [dataclasses.astuple(r) for r in got] \
        == [dataclasses.astuple(r) for r in want]
    assert 1 <= len(got) <= 4


def test_person_rois_takes_a_one_pixel_roi():
    """Three keypoints in a vertical line: the ROI is one pixel wide.  The
    JAX package divides by zero there; the port follows the reference's
    float arithmetic (the other side sets the scale), and skips a person
    who is a single point."""
    line = np.zeros((1, 25, 3), np.float32)
    line[0, :3] = [(50.0, 20.0, 0.9), (50.2, 40.0, 0.9), (50.4, 60.0, 0.9)]
    with pytest.raises(ZeroDivisionError):
        jrefine._person_rois(line, 0.05, 1.0, (160, 96))
    rois = refine._person_rois(line, 0.05, 1.0, (160, 96))
    assert len(rois) == 1 and rois[0].person == 0
    assert rois[0].rect[2] >= 1 and rois[0].rect[3] >= 40
    assert 1.0 < rois[0].scale_net_to_roi < 5.0
    dot = np.zeros((1, 25, 3), np.float32)
    dot[0, 0] = (50.0, 20.0, 0.9)
    dot[0, 1] = (50.3, 20.3, 0.9)
    assert refine._person_rois(dot, 0.05, 1.0, (160, 96)) == []
    for a, b in (((20, 30), (96, 160)), ((7, 3), (368, 368))):
        assert refine._resize_scale(a, b) \
            == refine.scaler.resize_get_scale_factor(a, b)


def _person(offset, score=0.9, n=25):
    kp = np.zeros((n, 3), np.float32)
    kp[:, 0] = 100 + offset + np.arange(n)
    kp[:, 1] = 200 + 2 * np.arange(n)
    kp[:, 2] = score
    return kp


@pytest.mark.parametrize("name,cands,accepted", [
    ("close", [_person(1.0, 0.95)], True),
    ("far", [_person(500.0)], False),
    ("closest_of_three", [_person(40.0), _person(2.0), _person(90.0)], True),
    ("none", [], False),
])
def test_merge_refined_equal(name, cands, accepted):
    outs = []
    for module in (refine, jrefine):
        kp_all = np.stack([_person(0), _person(300.0)])
        scores = np.array([0.5, 0.6], np.float32)
        cand = np.stack(cands) if cands else np.zeros((0, 25, 3), np.float32)
        ok = module._merge_refined(
            kp_all, scores, 0, cand,
            np.linspace(0.9, 0.7, len(cands)).astype(np.float32), 0.05)
        outs.append((ok, kp_all, scores))
    assert outs[0][0] == outs[1][0] == accepted
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])


def test_merge_refined_rejects_a_sparse_candidate_like_jax():
    for module in (refine, jrefine):
        kp_all = _person(0)[None]
        cand = _person(1.0)[None].copy()
        cand[0, 10:, 2] = 0.0                   # < 75% of the keypoints
        assert not module._merge_refined(
            kp_all, np.array([0.5], np.float32), 0, cand,
            np.array([0.9], np.float32), 0.05)


def _scene(seed, hw=(96, 160)):
    rng = np.random.RandomState(seed)
    people = synthetic.random_people(rng, 2, hw, height_range=(40, 70))
    return synthetic.render_scene_image(people, hw, rng)


@pytest.mark.parametrize("target_hw,seed", [((96, 160), 3), ((160, 96), 1)])
def test_decode_crops_matches_jax(extractors, target_hw, seed):
    """Two crops of a scene through the batched forward + decode, at the
    two crop geometries a 160x96 net input gives."""
    jax_ex, port_ex = extractors
    th, tw = target_hw
    rng = np.random.RandomState(seed)
    crops = np.stack([
        synthetic.render_scene_image(
            synthetic.random_people(rng, 2, (th, tw),
                                    height_range=(0.5 * th, 0.8 * th)),
            (th, tw), rng) for _ in range(2)]).astype(np.float32)
    want_peaks, want_scores = jrefine._decode_crops(
        jax_ex, jnp.asarray(crops), (th, tw))
    got_peaks, got_scores = refine._decode_crops(
        port_ex, torch.from_numpy(crops), (th, tw))
    assert isinstance(got_peaks, np.ndarray)
    assert got_peaks.shape == want_peaks.shape == (2, 25, 128, 3)
    assert got_scores.shape == want_scores.shape == (2, 26, 127, 127)
    np.testing.assert_array_equal(got_peaks[:, :, 0, 0],
                                  want_peaks[:, :, 0, 0])
    assert got_peaks[:, :, 0, 0].sum() > 50
    np.testing.assert_allclose(got_peaks, want_peaks, rtol=1e-4, atol=1e-4)
    # ~1000 peaks and ~8000 accepted lines per case at the refinement
    # thresholds: a line sample that sits on inter_threshold = 0.01 counts
    # on one side and not on the other
    off = ~np.isclose(got_scores, want_scores, rtol=1e-4, atol=1e-5)
    assert off.sum() <= 8, off.sum()
    assert np.abs(got_scores - want_scores).max() <= 1e-2


def test_decode_uses_the_refinement_thresholds(extractors):
    """`PoseExtractor.decode` with threshold arguments: more peaks survive
    0.02 than the model's 0.05, and the defaults are the model's."""
    _, port_ex = extractors
    from openpose_tpu_torch.ops import resize
    from openpose_tpu_torch.pose import scaler
    x = torch.from_numpy(_scene(4).astype(np.float32))[None]
    with torch.inference_mode():
        out = port_ex.model.forward(resize.normalize_vgg(x), torch.float32)
    plan = scaler.ScalePlan((1.0,), ((160, 96),), 1.0, (160, 96))
    default = port_ex.decode([out], plan, 0.0)
    explicit = port_ex.decode([out], plan, 0.0, nms_threshold=0.05,
                              inter_threshold=0.05)
    low = port_ex.decode([out], plan, 0.0, nms_threshold=0.02,
                         inter_threshold=0.01)
    for d, e in zip(default, explicit):
        assert torch.equal(d, e)
    assert low[0][0, :, 0, 0].sum() > default[0][0, :, 0, 0].sum()
    assert (low[1] > 0).sum() >= (default[1] > 0).sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_prediction_matches_jax(extractors, seed):
    jax_ex, port_ex = extractors
    img = _scene(seed)
    want = jax_ex.forward(img, net_resolution=(160, 96))
    got = port_ex.forward(img, net_resolution=(160, 96))
    assert got.keypoints.shape == want.keypoints.shape
    assert got.keypoints.shape[0] > 0
    rois = refine._person_rois(got.keypoints, 0.05, got.scale_net_to_output,
                               got.net_output_size)
    assert rois, "no person small enough to refine: pick another scene"
    want = jrefine.refine_prediction(jax_ex, img.astype(np.float32), want,
                                     people_cap=2)
    out = refine.refine_prediction(port_ex, img, got, people_cap=2)
    assert out is got
    assert got.keypoints.shape == want.keypoints.shape
    np.testing.assert_allclose(got.keypoints[..., :2], want.keypoints[..., :2],
                               atol=1e-2)
    np.testing.assert_allclose(got.keypoints[..., 2], want.keypoints[..., 2],
                               atol=1e-3)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-3)


def test_refine_prediction_replaces_a_person_when_the_crop_agrees(extractors):
    """A stub extractor whose crop decode finds the person again, half a
    pixel off: the merged keypoints are the candidate's, in image pixels."""
    _, port_ex = extractors
    rng = np.random.RandomState(7)
    hw = (96, 160)
    person = synthetic.random_people(rng, 1, hw, height_range=(30, 40))
    img = np.zeros((*hw, 3), np.uint8)

    class Stub:
        device = port_ex.device
        connect = port_ex.connect
        model = port_ex.model
        compute_dtype = torch.float32
        decode = port_ex.decode

        def __init__(self):
            self.scales = []

        def assemble(self, peaks, scores, scale_roi_to_out):
            self.scales.append(scale_roi_to_out)
            cand = person.copy()
            # relative to the ROI origin: refine_prediction adds it back,
            # and the 0.5 px of the NMS offset it left out
            cand[..., 0] -= self.origin[0]
            cand[..., 1] -= self.origin[1]
            return cand, np.array([0.77], np.float32)

    @dataclasses.dataclass
    class Pred:
        keypoints: np.ndarray
        scores: np.ndarray
        scale_net_to_output: float = 1.0
        net_output_size: tuple = (160, 96)

    stub = Stub()
    pred = Pred(person.copy(), np.array([0.3], np.float32))
    roi = refine._person_rois(pred.keypoints, 0.05, 1.0, (160, 96))[0]
    stub.origin = (roi.rect[0], roi.rect[1])
    refine.refine_prediction(stub, img, pred)
    assert stub.scales == [pytest.approx(1.0 / roi.scale_net_to_roi)]
    np.testing.assert_allclose(pred.keypoints[0, :, :2],
                               person[0, :, :2] + 0.5, atol=1e-4)
    assert pred.scores[0] == pytest.approx(0.77)
