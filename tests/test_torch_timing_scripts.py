"""The port's timing scripts (`openpose_tpu_torch/scripts/speed_test.py`,
`profile_net.py`, `profile_train_step.py`, `scaling_bench.py`,
`analyze_scaling.py`) against the JAX package's (`scripts/`), on the CPU.

Each stage of `speed_test` is held to the JAX function the JAX script
calls, on the port's input to that stage and the same seeded weights
(through the checkpoint bridge): the net within 1e-3 of its range, the
resize within 1e-5 of its range, NMS with exact counts and scores and
positions within 1e-4 px (`tests/test_torch_nms.py`), PAF scores rtol 1e-4,
atol 1e-5 (`tests/test_ops.py:404`).  `profile_net`'s cuts and GFLOP are
JAX's exactly.  The multi-process scripts, asked for the CPU, start gloo
ranks with one torch thread each, under a deadline (without that request
and without a card for each rank they raise): their reports carry the
JAX reports' keys
and findings (no collective in data-parallel inference, an all-reduce in
the sharded train step); their timings are CPU noise and are held to
nothing but being finite and positive.
"""

import importlib.util
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_tpu.models import graph as jgraph
from openpose_tpu.ops import nms as jnms
from openpose_tpu.ops import paf as jpaf
from openpose_tpu.ops import resize as jresize
from openpose_tpu_torch.device import NoCudaDeviceError
from openpose_tpu_torch.models import checkpoint, zoo
from openpose_tpu_torch.ops import paf
from openpose_tpu_torch.params import PoseModel
from openpose_tpu_torch.scripts import (analyze_scaling, profile_net,
                                        profile_train_step, scaling_bench,
                                        speed_test)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JOIN_SECONDS = 240


def jax_script(name):
    """The JAX package's `scripts/<name>.py` as a module of its own (the
    timing scripts import nothing of JAX until main runs)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def body25():
    model = zoo.load_pose_model(PoseModel.BODY_25, seed=0, device="cpu")
    params = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
              for k, v in checkpoint.to_jax_params(model.net.params()).items()}
    return model, params


def test_speed_test_stages_match_the_jax_functions(body25, capsys):
    model, jparams = body25
    res = speed_test.main(["--cpu", "--net_resolution", "64x64", "--dtype",
                           "float32", "--iters", "2"])
    printed = capsys.readouterr().out.splitlines()
    names = ["net forward (float32)", "resize 8x (parts)", "nms",
             "paf scores (multiscale)"]
    assert [line.split(":")[0] for line in printed] == names
    assert list(res["ms"]) == names
    assert all(math.isfinite(ms) and ms > 0 for ms in res["ms"].values())
    assert res["device"] == "cpu"
    o = {k: v.numpy() for k, v in res["outputs"].items()}
    # the JAX script's image
    np.testing.assert_array_equal(o["image"], np.random.RandomState(0).uniform(
        0, 255, (1, 64, 64, 3)).astype(np.float32))

    net = np.asarray(jgraph.forward(
        jparams, jgraph.load_spec(model.info.spec),
        jresize.normalize_vgg(jnp.asarray(o["image"])), jnp.float32))
    assert o["net"].shape == net.shape == (1, 8, 8, 78)
    span = float(net.max() - net.min())
    np.testing.assert_allclose(o["net"], net, rtol=0, atol=1e-3 * span)

    merged = np.asarray(jresize.resize_bicubic(
        jnp.asarray(o["net"])[..., :model.info.num_parts], (64, 64)))
    np.testing.assert_allclose(o["merged"], merged, rtol=0,
                               atol=1e-5 * float(np.ptp(merged)))

    peaks = np.asarray(jnms.nms(jnp.asarray(o["merged"]), 0.05, 127))
    assert o["peaks"].shape == peaks.shape == (1, 25, 128, 3)
    np.testing.assert_array_equal(o["peaks"][..., 0, 0], peaks[..., 0, 0])
    assert peaks[..., 0, 0].sum() > 0
    np.testing.assert_array_equal(o["peaks"][..., 2], peaks[..., 2])
    np.testing.assert_allclose(o["peaks"], peaks, rtol=0, atol=1e-4)

    pairs, map_idx = paf.pair_tables(model.info)
    scores = np.asarray(jpaf.paf_scores_multiscale(
        (jnp.asarray(o["net"]),), (1.0,), (64, 64), jnp.asarray(o["peaks"]),
        jnp.asarray(pairs), jnp.asarray(map_idx), 0.05, 0.95, 0.05))
    assert o["scores"].shape == scores.shape == (1, 26, 127, 127)
    np.testing.assert_allclose(o["scores"], scores, rtol=1e-4, atol=1e-5)
    # no launch on the CPU: the wrappers ran their plain versions
    assert all(n == 0 for stage in res["launches"].values()
               for n in stage.values())


def test_profile_net_cuts_and_gflop_match_the_jax_script(body25, capsys):
    model, _ = body25
    rows = profile_net.main(["--cpu", "--batch", "1", "--net_resolution",
                             "64x64"], chain=(1, 2, 1))
    out = capsys.readouterr().out
    assert out.startswith("# device cpu, bf16 peak n/a TFLOP/s, batch 1")
    assert out.count("(n/a of peak)") == len(rows)
    jscript = jax_script("profile_net")
    assert profile_net.CUTS == jscript.CUTS
    jspec = jgraph.load_spec(model.info.spec)
    jnames = [layer.name for layer in jspec.layers]
    jcuts = [c for c in jscript.CUTS if c in jnames] + [jnames[-1]]
    assert [r["cut"] for r in rows] == jcuts
    flops = jgraph.count_flops(jspec, (64, 64))
    prev = 0
    for row, cut in zip(rows, jcuts):
        total = sum(flops[n] for n in jnames[:jnames.index(cut) + 1])
        assert row["gflop"] == pytest.approx((total - prev) / 1e9,
                                             rel=1e-12)
        assert row["share_of_peak"] is None
        assert math.isfinite(row["ms_per_frame"])
        prev = total


def test_profile_net_last_cut_is_the_whole_net(body25):
    """The last prefix is BODY_25 itself: bit for bit `PoseNet.forward`."""
    model, _ = body25
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -0.5, 0.5, (1, 32, 48, 3)).astype(np.float32))
    last = profile_net.cut_names(model.spec)[-1]
    with torch.inference_mode():
        got = profile_net.prefix_net(model, last)(x, torch.float32)
        want = model.forward(x, torch.float32)
    assert torch.equal(got, want)


def test_profile_train_step_prints_the_jax_keys(capsys):
    out = profile_train_step.main(["--cpu", "--image_size", "32x32",
                                   "--batch", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert set(printed) == {"device_step_ms", "device_img_s",
                            "device_train_tflops", "device_train_mfu",
                            "image_size", "batch", "device_kind"}
    assert printed["image_size"] == "32x32" and printed["batch"] == 2
    assert printed["device_kind"] == "cpu"
    assert printed["device_train_mfu"] is None
    assert printed["device_step_ms"] > 0


def test_scaling_bench_report_on_gloo(tmp_path):
    """One pair of 1- and 2-rank worlds: the report has the keys of the
    JAX script's (`SCALING_r05.json`), no collective in inference, and a
    positive efficiency (no 0.8 gate: the JAX one is `slow`-marked for
    CPU noise)."""
    report = scaling_bench.measure(batch=2, iters=2, reps=1,
                                   workdir=tmp_path, four_host=False,
                                   device_type="cpu", timeout=JOIN_SECONDS)
    want = json.loads((ROOT / "SCALING_r05.json").read_text())
    assert set(report) == set(want)
    assert set(report["pairs"][0]) == set(want["pairs"][0])
    assert set(report["pairs"][0]["two_hosts"]) \
        >= set(want["pairs"][0]["two_hosts"])
    assert report["collectives_inference"] == {}
    assert report["efficiency_2_hosts_median"] > 0
    assert report["four_hosts"] is None
    assert "gloo" in report["config"]
    assert report["pairs"][0]["two_hosts"]["n_hosts"] == 2
    assert len(report["pairs"][0]["two_hosts"]["per_proc_dts"]) == 2
    assert report["pairs"][0]["two_hosts"]["per_proc_trace"] \
        == {0: None, 1: None}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where there is no card")
def test_multi_process_scripts_stay_off_the_cpu_unless_asked(tmp_path):
    """Without --cpu (device_type="cpu") and with fewer cards than ranks
    both scripts raise before they start a rank, naming the two counts."""
    with pytest.raises(NoCudaDeviceError, match="4 ranks .* --cpu"):
        scaling_bench.measure(batch=2, iters=2, reps=1, workdir=tmp_path)
    with pytest.raises(NoCudaDeviceError, match="8 ranks .* --cpu"):
        analyze_scaling.main([])
    assert not any(tmp_path.iterdir())


def test_analyze_scaling_on_four_gloo_ranks():
    """The JAX report's shape and findings on a world of 4: no collective
    in data-parallel inference, the gradient all-reduce (and the weight
    shards' all-gathers) in the (2, 2) train step."""
    report = analyze_scaling.main(["--ranks", "4", "--cpu"],
                                  timeout=JOIN_SECONDS)
    assert set(report) == {"inference", "train"}
    for part in report.values():
        assert set(part) == {"mesh", "collectives", "scaling"}
    assert report["inference"]["mesh"] == {"data": 4, "model": 1}
    assert report["inference"]["collectives"] == {}
    assert report["inference"]["scaling"].startswith("embarrassingly")
    assert report["train"]["mesh"] == {"data": 2, "model": 2}
    assert report["train"]["collectives"]["all-reduce"] >= 1
    assert report["train"]["collectives"]["all-gather"] >= 1
