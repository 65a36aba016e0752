"""The port's user scripts (`openpose_tpu_torch/scripts/`) against the JAX
package's (`scripts/`), on the CPU.

Each pair runs with the same flags on the same inputs; the port's side gets
`--cpu` (or `device="cpu"`).  Tolerances are stated per test: the closed
accuracy loop gives the same AP, AP50 and AR exactly (the same rendered net
outputs and the same people); the 3-D table within 1e-4 (float32
reductions in another order); COCO detections within 1e-3 px and 1e-4
score, the same AP, as the wrapper tests hold keypoints.  Nothing is
downloaded: the model fetcher is fed by a fake server and a local folder,
as `tests/test_fetch_models.py` feeds the JAX one.
"""

import contextlib
import functools
import hashlib
import importlib.util
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from openpose_tpu import wrapper as jwrapper
from openpose_tpu.models import checkpoint as jcheckpoint
from openpose_tpu.models import graph as jgraph
from openpose_tpu_torch import synthetic, wrapper
from openpose_tpu_torch.models import caffe_proto, checkpoint, graph, zoo
from openpose_tpu_torch.params import PoseModel
from openpose_tpu_torch.scripts import (coco_val, fetch_models,
                                        synthetic_eval, threed_eval,
                                        train_to_ap)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def jax_script(name):
    """The JAX package's `scripts/<name>.py` as a module of its own."""
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


def caffemodel_bytes(spec_name, seed=0):
    """Seeded random weights of a spec as caffemodel bytes (OIHW blobs),
    which both packages' loaders read; the port's params."""
    spec = graph.load_spec(spec_name)
    params = graph.init_params(spec, torch.Generator().manual_seed(seed))
    layers = {name: [p["w"].numpy(), p["b"].numpy()] if "w" in p
              else [p["slope"].numpy()] for name, p in params.items()}
    return caffe_proto.serialize_caffemodel(layers), params


# --- synthetic_eval --------------------------------------------------------


def test_synthetic_eval_gives_the_jax_scripts_ap(tmp_path):
    """4 rendered scenes of 1-4 people at 176x320, f32: the same AP, AP50,
    AR (exactly) and counts as the JAX script."""
    flags = ["--images", "4", "--net_resolution", "320x176", "--batch", "4",
             "--cpu"]
    assert synthetic_eval.main(flags + ["--out", str(tmp_path / "mine")]) \
        == 0
    assert jax_script("synthetic_eval").main(
        flags + ["--out", str(tmp_path / "theirs")]) == 0
    got = json.loads((tmp_path / "mine").read_text())
    want = json.loads((tmp_path / "theirs").read_text())
    assert got["n_gt"] > 4 and got["AP"] > 0.9, got
    for key in ("AP", "AP50", "AR", "n_detections", "n_gt", "n_images"):
        assert got[key] == want[key], (key, got, want)


def test_synthetic_eval_topdown_runs_the_ports_face_loop(tmp_path):
    """--topdown face on 2 frames: the port's closed face loop, its
    localization error under the JAX suite's 2 px limit."""
    assert synthetic_eval.main(
        ["--topdown", "face", "--images", "2", "--net_resolution", "320x176",
         "--batch", "2", "--cpu", "--out", str(tmp_path / "face")]) == 0
    got = json.loads((tmp_path / "face").read_text())
    assert got["n_instances"] > 0 and got["rmse_px"] < 2.0, got


def test_scripts_raise_without_a_card_when_not_told_cpu():
    """No `--cpu` and no card: the script stops; it never carries on on
    the CPU by itself."""
    from openpose_tpu_torch.device import NoCudaDeviceError
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (synthetic_eval.main, threed_eval.main, train_to_ap.main):
        with pytest.raises(NoCudaDeviceError):
            main(["--out", ""])


# --- threed_eval -----------------------------------------------------------


def test_threed_eval_gives_the_jax_scripts_json(tmp_path, monkeypatch):
    """2 people x 3 cameras: the triangulation sweep within rtol 1e-4 of
    the JAX script's (1e-3 mm and px at zero noise, where both are float32
    rounding), the bundle adjustment's figures within rtol 1e-2, the
    tolerances of `tests/test_torch_accuracy3d.py` (15 float32 LM
    iterations, a rotation error that is an arccos near 1: 7e-4 apart
    here); the default output is BENCH3D_torch.json, not the JAX package's
    BENCH3D.json."""
    monkeypatch.chdir(tmp_path)
    flags = ["--people", "2", "--cams", "3", "--cpu"]
    assert threed_eval.main(flags) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["BENCH3D_torch.json"]
    assert jax_script("threed_eval").main(flags + ["--out", "theirs.json"]) \
        == 0
    got = json.loads((tmp_path / "BENCH3D_torch.json").read_text())
    want = json.loads((tmp_path / "theirs.json").read_text())
    assert got.keys() == want.keys()
    sweep = list(zip(got["triangulation_sweep"], want["triangulation_sweep"]))
    assert len(sweep) == 5
    for g, w in sweep:
        assert g.keys() == w.keys()
        assert g["valid_fraction"] == w["valid_fraction"]
        for key in w:
            assert g[key] == pytest.approx(
                w[key], rel=1e-4, abs=1e-3 if w["pixel_noise"] == 0 else 0), \
                (key, g, w)
    g, w = got["bundle_adjustment"], want["bundle_adjustment"]
    assert g.keys() == w.keys()
    for key in w:
        assert g[key] == pytest.approx(w[key], rel=1e-2), (key, g, w)
    assert g["rmse_mm_after_ba"] < g["rmse_mm_before_ba"], g


# --- train_to_ap -----------------------------------------------------------


def test_train_to_ap_writes_the_jax_scripts_keys(tmp_path, monkeypatch):
    """2 steps at 48x64, batch 2, one held-out scene: a plumbing check.
    The JSON (by default TRAIN2AP_torch.json) has every key of the JAX
    script's `TRAIN2AP.json`.  The scene streams differ by design: the
    port draws without OpenCV."""
    monkeypatch.chdir(tmp_path)
    assert train_to_ap.main(["--steps", "2", "--image_size", "48x64",
                             "--batch", "2", "--eval_images", "1",
                             "--cpu"]) == 0
    got = json.loads((tmp_path / "TRAIN2AP_torch.json").read_text())
    want = json.loads((ROOT / "TRAIN2AP.json").read_text())
    assert set(want) <= set(got), set(want) - set(got)
    assert got["steps"] == 2 and got["n_eval"] == 1
    assert np.isfinite(list(got["losses"].values())).all()


# --- fetch_models ----------------------------------------------------------


@pytest.fixture(scope="module")
def mpi_blob():
    data, params = caffemodel_bytes("mpi_15")
    return data, hashlib.md5(data).hexdigest(), params


def patched_models(monkeypatch, md5):
    rel, _md5, spec = fetch_models.MODELS["mpi_15"]
    monkeypatch.setitem(fetch_models.MODELS, "mpi_15", (rel, md5, spec))
    return rel


def offline_copy(tmp_path, rel, data):
    src = tmp_path / "offline" / rel
    src.parent.mkdir(parents=True)
    src.write_bytes(data)
    return tmp_path / "offline"


def test_fetch_models_offline_from_dir_and_convert(tmp_path, monkeypatch,
                                                   mpi_blob):
    data, md5, params = mpi_blob
    rel = patched_models(monkeypatch, md5)
    from_dir = offline_copy(tmp_path, rel, data)
    dest = tmp_path / "models"
    out = fetch_models.fetch_one("mpi_15", dest, "http://unused",
                                 from_dir=from_dir)
    assert out == dest / rel and out.exists()
    loaded = checkpoint.load_npz(str(fetch_models.convert_one("mpi_15", out)))
    assert loaded.keys() == params.keys()
    for layer, leaves in params.items():
        assert loaded[layer].keys() == leaves.keys(), layer
        for key, value in leaves.items():
            assert torch.equal(loaded[layer][key], value), (layer, key)


def test_fetch_models_npz_serves_the_same_forward_in_both_packages(
        tmp_path, monkeypatch, mpi_blob):
    """The port's conversion writes the JAX converter's file, and the
    converted `.npz` loaded by each package gives the same forward within
    1e-4 (float32 convolutions in another order)."""
    data, md5, _params = mpi_blob
    rel = patched_models(monkeypatch, md5)
    from_dir = offline_copy(tmp_path, rel, data)
    out = fetch_models.fetch_one("mpi_15", tmp_path / "m", "http://unused",
                                 from_dir=from_dir)
    npz = fetch_models.convert_one("mpi_15", out)
    theirs = jcheckpoint.convert_caffemodel(str(out), "mpi_15")
    with np.load(npz) as mine:
        assert sorted(mine.files) == sorted(
            f"{layer}/{key}" for layer, leaves in theirs.items()
            for key in leaves)
        for layer, leaves in theirs.items():
            for key, value in leaves.items():
                np.testing.assert_array_equal(mine[f"{layer}/{key}"],
                                              np.asarray(value))
    import jax.numpy as jnp
    x = np.random.RandomState(0).uniform(
        -0.5, 0.5, (1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jgraph.forward(jcheckpoint.load(str(npz)),
                                     jgraph.load_spec("mpi_15"),
                                     jnp.asarray(x), jnp.float32))
    model = zoo.load_pose_model(PoseModel.MPI_15, device="cpu",
                                caffemodel=str(npz))
    with torch.no_grad():
        got = model.forward(torch.from_numpy(x), torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fetch_models_fake_server_download(tmp_path, monkeypatch, mpi_blob):
    data, md5, _params = mpi_blob
    rel = patched_models(monkeypatch, md5)
    urls = []

    @contextlib.contextmanager
    def opener(url):
        urls.append(url)
        yield io.BytesIO(data)

    out = fetch_models.fetch_one("mpi_15", tmp_path, "http://srv/models/",
                                 opener=opener)
    assert out.exists() and urls == ["http://srv/models/" + rel]
    # second call: cached, checksum OK, no new request
    fetch_models.fetch_one("mpi_15", tmp_path, "http://srv/models/",
                           opener=opener)
    assert len(urls) == 1


def test_fetch_models_checksum_mismatch_rejected(tmp_path, monkeypatch,
                                                 mpi_blob):
    data, _md5, _params = mpi_blob
    patched_models(monkeypatch, "0" * 32)

    @contextlib.contextmanager
    def opener(url):
        yield io.BytesIO(data)

    with pytest.raises(ValueError, match="MD5"):
        fetch_models.fetch_one("mpi_15", tmp_path, "http://srv/",
                               opener=opener)
    assert not (tmp_path / fetch_models.MODELS["mpi_15"][0]).exists()


def test_fetch_models_offline_missing_file_lists_name(tmp_path, monkeypatch,
                                                      mpi_blob):
    _data, md5, _params = mpi_blob
    patched_models(monkeypatch, md5)
    with pytest.raises(FileNotFoundError, match="mpi_15"):
        fetch_models.fetch_one("mpi_15", tmp_path / "d", "http://unused",
                               from_dir=tmp_path / "empty")


def test_fetch_models_main_names_every_failure(tmp_path, capsys):
    """Offline with nothing to copy: `main` fails and names each model."""
    rc = fetch_models.main(["--dest", str(tmp_path / "m"), "--from-dir",
                            str(tmp_path / "empty"), "--only", "face",
                            "hand"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "face: FAILED" in err and "hand: FAILED" in err
    assert "2/2 failed" in err


def test_fetch_models_main_offline_end_to_end(tmp_path, monkeypatch,
                                              mpi_blob):
    data, md5, _params = mpi_blob
    rel = patched_models(monkeypatch, md5)
    from_dir = offline_copy(tmp_path, rel, data)
    assert fetch_models.main(["--dest", str(tmp_path / "m"), "--only",
                              "mpi_15", "--from-dir", str(from_dir)]) == 0
    assert (tmp_path / "m" / rel).with_suffix(".npz").exists()


# --- coco_val --------------------------------------------------------------


def test_coco_val_equals_the_jax_script(tmp_path, monkeypatch, capsys):
    """Three frames written with OpenCV, their people as the annotations,
    `-1x64`, float32 (both packages' `PoseConfig` made float32 for the
    run), the same random BODY_25 weights as a caffemodel: detections
    within 1e-3 px and 1e-4 score, and the same AP."""
    cv2 = pytest.importorskip("cv2")
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(0)
    hw = (120, 200)
    entries, gts = [], []
    for i in range(3):
        people = synthetic.random_people(rng, 2, hw, height_range=(60, 100))
        name = f"{i:012d}.png"
        cv2.imwrite(str(images / name),
                    synthetic.render_scene_image(people, hw, rng))
        entries.append({"id": i, "file_name": name, "height": hw[0],
                        "width": hw[1]})
        gts.extend(synthetic.coco_ground_truth(people, i))
    for k, gt in enumerate(gts):
        gt["id"] = k + 1
    annotations = tmp_path / "annotations.json"
    annotations.write_text(json.dumps({
        "images": entries, "annotations": gts,
        "categories": [{"id": 1, "name": "person"}]}))
    weights = tmp_path / "body_25.caffemodel"
    weights.write_bytes(caffemodel_bytes("body_25")[0])
    argv = ["--images", str(images), "--annotations", str(annotations),
            "--caffemodel", str(weights), "--net_resolution=-1x64"]
    for module in (wrapper, jwrapper):
        monkeypatch.setattr(module, "PoseConfig", functools.partial(
            module.PoseConfig, compute_dtype="float32"))
    assert coco_val.main(argv + ["--out", str(tmp_path / "mine.json")],
                         device="cpu") == 0
    mine_metrics = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["coco_val.py", *argv, "--out",
                                     str(tmp_path / "theirs.json")])
    jax_script("coco_val").main()
    theirs_metrics = capsys.readouterr().out

    def metrics(text):
        return json.loads(text[text.index("{"):])
    got, want = metrics(mine_metrics), metrics(theirs_metrics)
    assert got.keys() == want.keys() and "AP" in got
    assert got["AP"] == want["AP"]
    mine = json.loads((tmp_path / "mine.json").read_text())
    theirs = json.loads((tmp_path / "theirs.json").read_text())
    assert len(mine) == len(theirs) > 0
    for g, w in zip(mine, theirs):
        assert (g["image_id"], g["category_id"]) \
            == (w["image_id"], w["category_id"])
        kg = np.asarray(g["keypoints"], np.float64).reshape(-1, 3)
        kw = np.asarray(w["keypoints"], np.float64).reshape(-1, 3)
        np.testing.assert_allclose(kg[:, :2], kw[:, :2], atol=1e-3)
        np.testing.assert_array_equal(kg[:, 2], kw[:, 2])
        assert g["score"] == pytest.approx(w["score"], abs=1e-4)
