"""The port stands alone: `openpose_tpu_torch` and `chip_smoke.py` import
nothing of `openpose_tpu` and nothing of JAX, and the port's own copies of
the JAX package's host modules give what the originals give.

Only this file (and the other `tests/test_torch_*.py`) imports both
packages: that is how the two are compared.
"""

import ast
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import openpose_tpu.params as jparams
import openpose_tpu.scenes as jscenes
from openpose_tpu.face import detector as jface
from openpose_tpu.hand import detector as jhand
from openpose_tpu.io import json_io as jjson
from openpose_tpu.models import caffe_proto as jproto
from openpose_tpu.ops import assembly as jassembly
from openpose_tpu.pose import scaler as jscaler
import openpose_tpu_torch.params as params
from openpose_tpu_torch import synthetic
from openpose_tpu_torch.face import detector as face
from openpose_tpu_torch.hand import detector as hand
from openpose_tpu_torch.io import json_io
from openpose_tpu_torch.models import caffe_proto
from openpose_tpu_torch.ops import assembly
from openpose_tpu_torch.pose import scaler

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "openpose_tpu_torch"
JAX_NAME = re.compile(r"openpose_tpu(?!_torch)\b")
# the one place a string may name a file of the JAX package: the labels of
# chip_smoke.py's kernel summary ("replaces": file:line of the TPU kernel)
ALLOWED_STRING = re.compile(r"openpose_tpu/ops/paf_pallas\.py:\d+")


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    """A fresh interpreter in which any import of `openpose_tpu`, `jax`,
    `optax` or `cv2` raises imports every module of the port (walking the
    package, the trainer, the accuracy harness, the entry points and what
    they drive included) and `chip_smoke.py`; only `render/render.py`,
    which draws with OpenCV, is imported after `cv2` is let through
    again."""
    script = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        blocked = {"openpose_tpu", "jax", "jaxlib", "optax", "cv2"}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in blocked:
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import openpose_tpu_torch
        names = ["openpose_tpu_torch", "chip_smoke"] + [
            m.name for m in pkgutil.walk_packages(
                openpose_tpu_torch.__path__, "openpose_tpu_torch.")]
        needs_cv2 = "openpose_tpu_torch.render.render"
        assert needs_cv2 in names
        for new in ("train", "train_loop", "accuracy", "io.coco_eval",
                    "cli", "pyopenpose", "capi", "io.producers",
                    "io.savers", "io.bvh", "render.heatmaps", "render.gui",
                    "render.gui3d", "threed.camera", "threed.triangulation",
                    "threed.bundle_adjustment", "parallel.mesh",
                    "accuracy3d", "threed.calibration", "threed.visualsfm",
                    "calibration_cli"):
            assert "openpose_tpu_torch." + new in names, new
        for name in names:
            if name != needs_cv2:
                importlib.import_module(name)
        loaded = [m for m in sys.modules if m.split(".")[0] in blocked]
        assert not loaded, loaded
        blocked.discard("cv2")
        importlib.import_module(needs_cv2)
        assert "cv2" in sys.modules
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) >= 61


def _docstrings(tree):
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                found.add(id(body[0].value))
    return found


def _python_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _python_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_python_source_names_the_jax_package(path):
    """No import of, and no string with a path into, `openpose_tpu` other
    than in comments and docstrings."""
    tree = ast.parse(path.read_text())
    docstrings = _docstrings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert not JAX_NAME.match(alias.name), (path, alias.name)
                assert alias.name.split(".")[0] != "jax", (path, alias.name)
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            assert not JAX_NAME.match(module), (path, module)
            assert module.split(".")[0] != "jax", (path, module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docstrings:
            rest = ALLOWED_STRING.sub("", node.value)
            assert not JAX_NAME.search(rest), (path, node.lineno, node.value)


def test_only_the_renderer_imports_opencv():
    """`render/render.py` is the one module that imports OpenCV when it is
    imported.  Other modules import it inside the functions that read or
    write image and video files, draw, or show a window, and only there:
    the trainer's `coco_data_iterator`, the producers and savers, the
    heatmap overlays, the GUI and the CLI (the card's machine has no
    OpenCV, and what runs there calls none of them).  The calibration
    toolbox gets it from `threed/calibration.py::opencv`, which names
    OpenCV where it is missing."""
    importers = []
    for path in _python_sources():
        tree = ast.parse(path.read_text())
        at_top = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            if any(n.split(".")[0] == "cv2" for n in names):
                importers.append((str(path.relative_to(ROOT)),
                                  id(node) in at_top))
    assert sorted(set(importers)) == [
        ("openpose_tpu_torch/cli.py", False),
        ("openpose_tpu_torch/io/producers.py", False),
        ("openpose_tpu_torch/io/savers.py", False),
        ("openpose_tpu_torch/render/gui.py", False),
        ("openpose_tpu_torch/render/heatmaps.py", False),
        ("openpose_tpu_torch/render/render.py", True),
        ("openpose_tpu_torch/threed/calibration.py", False),
        ("openpose_tpu_torch/train_loop.py", False)]
    tree = ast.parse((PORT / "train_loop.py").read_text())
    inside = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
              and any(isinstance(m, ast.Import)
                      and m.names[0].name == "cv2" for m in ast.walk(n))]
    assert inside == ["coco_data_iterator"]


def _top_level_names(node):
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        return {t.id for t in targets if isinstance(t, ast.Name)}
    return {getattr(node, "name", None)}


def _code(path, only=None, drop=(), transform=None):
    """The file's code as an AST dump without docstrings, with the JAX
    package's name replaced by the port's; only: the top-level names to
    keep; drop: top-level names (functions, classes, constants) to leave
    out; transform: an `ast.NodeTransformer` applied first."""
    tree = ast.parse(JAX_NAME.sub("openpose_tpu_torch", path.read_text()))
    if transform is not None:
        tree = transform.visit(tree)
    tree.body = [n for n in tree.body if not _top_level_names(n) & set(drop)]
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and node.body and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    if only is not None:
        tree.body = [n for n in tree.body
                     if getattr(n, "name", None) in only]
        assert len(tree.body) == len(only), [n.name for n in tree.body]
    return ast.dump(tree)


# what the port adds to a copied module: the build of its own C shim
PORT_ADDITIONS = {"utils/native_build.py": ("CAPI_SOURCE", "build_capi")}


@pytest.mark.parametrize("relative", [
    "utils/logging.py", "utils/native_build.py", "io/native_loader.py",
    "runtime/pipeline.py", "render/render.py", "io/coco_eval.py",
    "threed/camera.py", "io/bvh.py", "render/gui.py", "render/gui3d.py"])
def test_copied_module_has_the_originals_code(relative):
    """The modules that need no device library are copies: the same code
    (docstrings aside) under the port's package name, plus what
    `PORT_ADDITIONS` names.  `io/producers.py`, `io/savers.py` and
    `render/heatmaps.py` import OpenCV inside their functions instead, and
    `tests/test_torch_io.py` holds them by what they do."""
    drop = PORT_ADDITIONS.get(relative, ())
    assert _code(PORT / relative, drop=drop) \
        == _code(ROOT / "openpose_tpu" / relative)
    names = set().union(*map(_top_level_names,
                             ast.parse((PORT / relative).read_text()).body))
    assert set(drop) <= names


class _WithoutOpenCV(ast.NodeTransformer):
    """Takes out where a module gets OpenCV: `import cv2`, `cv2 =
    opencv()`, the port's `opencv` helper and the imports of it."""

    def visit_Import(self, node):
        return None if any(a.name == "cv2" for a in node.names) else node

    def visit_ImportFrom(self, node):
        node.names = [a for a in node.names if a.name != "opencv"]
        return node if node.names else None

    def visit_Assign(self, node):
        targets = [getattr(t, "id", None) for t in node.targets]
        return None if targets == ["cv2"] else node

    def visit_FunctionDef(self, node):
        if node.name == "opencv":
            return None
        self.generic_visit(node)
        return node


@pytest.mark.parametrize("relative", [
    "threed/calibration.py", "threed/visualsfm.py", "calibration_cli.py"])
def test_calibration_toolbox_is_the_originals_code(relative):
    """The calibration toolbox is a copy that gets OpenCV where it is used
    (`threed/calibration.py::opencv`) instead of at the top of a module:
    with that taken out of both, the code is the original's under the
    port's package name.  `tests/test_torch_calibration.py` runs both."""
    mine = _code(PORT / relative, transform=_WithoutOpenCV())
    assert mine == _code(ROOT / "openpose_tpu" / relative,
                         transform=_WithoutOpenCV())
    assert mine != _code(PORT / relative)     # the port gets cv2 elsewhere


@pytest.mark.parametrize("relative,names", [
    ("pose/refine.py", ["_keypoints_rectangle", "_distance_average",
                        "_rect_iou", "_Roi", "_merge_refined"]),
    ("face/haar.py", ["HaarCascade", "parse_cascade", "_find_default_cascade",
                      "_integral", "_rect_sums", "_detect_single_scale",
                      "group_rectangles"]),
    ("wrapper.py", ["PoseConfig", "FaceConfig", "HandConfig", "Datum"]),
    ("tracking/person_id.py", ["PersonEntry"]),
    ("train_loop.py", ["coco_to_model_keypoints", "TrainConfig",
                       "coco_data_iterator"]),
])
def test_copied_host_helpers_have_the_originals_code(relative, names):
    assert _code(PORT / relative, names) \
        == _code(ROOT / "openpose_tpu" / relative, names)


def test_ground_truth_helper_has_the_originals_code():
    """`scenes.py`'s annotations live in the port's `synthetic.py`."""
    assert _code(PORT / "synthetic.py", ["coco_ground_truth"]) \
        == _code(ROOT / "openpose_tpu" / "scenes.py", ["coco_ground_truth"])


def _method(path, cls, name):
    tree = ast.parse(JAX_NAME.sub("openpose_tpu_torch", path.read_text()))
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for item in node.body:
                if getattr(item, "name", None) == name:
                    return ast.dump(item)
    raise AssertionError((path, cls, name))


@pytest.mark.parametrize("relative,cls,name", [
    ("wrapper.py", "Wrapper", "process"),
    ("wrapper.py", "Wrapper", "render"),
    ("tracking/person_id.py", "PersonIdExtractor", "_match_greedy"),
    ("tracking/person_id.py", "PersonIdExtractor", "_capture"),
    ("tracking/pose_graph.py", "KeyframeSmoother", "_assign_slots"),
    ("tracking/pose_graph.py", "KeyframeSmoother", "push"),
])
def test_host_methods_are_the_originals(relative, cls, name):
    """Host logic that the port took over as it is: every branch of
    `Wrapper.process`, the greedy id matching, the smoother's slots."""
    assert _method(PORT / relative, cls, name) \
        == _method(ROOT / "openpose_tpu" / relative, cls, name)


def test_haar_image_helpers_are_within_one_level_of_opencv():
    """The port's Haar detector does in NumPy what the original takes from
    cv2: gray conversion and the pyramid step exactly, the bilinear resize
    within one gray level (cv2 interpolates in fixed point)."""
    import cv2
    from openpose_tpu_torch.face import haar
    rng = np.random.RandomState(0)
    image = cv2.GaussianBlur(rng.randint(0, 256, (121, 163, 3))
                             .astype(np.uint8), (9, 9), 3)
    gray = haar._bgr_to_gray(image)
    np.testing.assert_array_equal(gray,
                                  cv2.cvtColor(image, cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(haar._pyr_down(gray), cv2.pyrDown(gray))
    for size in ((100, 80), (136, 101), (60, 45), (163, 121)):
        got = haar._resize_linear(gray, size).astype(int)
        want = cv2.resize(gray, size, interpolation=cv2.INTER_LINEAR)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1


def test_haar_detector_equals_the_original_on_frames_without_faces():
    from openpose_tpu.face import haar as jhaar
    from openpose_tpu_torch.face import haar
    if haar._find_default_cascade() is None:
        pytest.skip("no haarcascade_frontalface_alt.xml on this machine")
    assert haar._find_default_cascade() == jhaar._find_default_cascade()
    rng = np.random.RandomState(1)
    frame = rng.randint(0, 255, (400, 700, 3)).astype(np.uint8)  # pyrDown once
    mine, theirs = haar.FaceDetectorOpenCV(), jhaar.FaceDetectorOpenCV()
    got, want = mine.detect_faces(frame), theirs.detect_faces(frame)
    assert got.shape == want.shape == (0, 4)
    gray = rng.randint(0, 255, (90, 120)).astype(np.uint8)
    assert haar.detect_multiscale(gray, mine.cascade) \
        == jhaar.detect_multiscale(gray, theirs.cascade) == []


def test_no_kernel_source_names_the_jax_package_outside_comments():
    sources = sorted(PORT.rglob("*.cu")) + sorted(PORT.rglob("*.cuh"))
    assert sources
    for path in sources:
        for number, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("//")[0]
            assert not JAX_NAME.search(code), (path, number, line)


@pytest.mark.parametrize("model", list(params.PoseModel),
                         ids=lambda m: m.name)
def test_pose_model_tables_equal(model):
    jmodel = jparams.PoseModel[model.name]
    assert model.value == jmodel.value
    assert model.experimental == jmodel.experimental
    if model.experimental:
        assert model not in params.POSE_MODEL_INFO
        return
    got = dataclasses.asdict(params.POSE_MODEL_INFO[model])
    want = dataclasses.asdict(jparams.POSE_MODEL_INFO[jmodel])
    assert got == want
    for flag in (False, True):
        assert dataclasses.asdict(params.default_connect_params(model, flag)) \
            == dataclasses.asdict(jparams.default_connect_params(jmodel, flag))


def test_params_constants_equal():
    for name in ("POSE_MAX_PEOPLE", "FACE_NUMBER_PARTS", "HAND_NUMBER_PARTS"):
        assert getattr(params, name) == getattr(jparams, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("maximize_positives", [False, True])
def test_connect_body_parts_equal(seed, maximize_positives):
    """Greedy assembly on seeded pair scores and peaks of BODY_25."""
    info = params.POSE_MODEL_INFO[params.PoseModel.BODY_25]
    pairs = np.asarray(info.pairs, np.int32).reshape(-1, 2)
    rng = np.random.RandomState(seed)
    k = 6
    peaks = np.zeros((info.num_parts, k + 1, 3), np.float32)
    for part in range(info.num_parts):
        cnt = rng.randint(0, k + 1)
        peaks[part, 0, 0] = cnt
        peaks[part, 1:cnt + 1, :2] = rng.uniform(0, 200, (cnt, 2))
        peaks[part, 1:cnt + 1, 2] = rng.uniform(0.1, 1.0, cnt)
    scores = np.where(rng.rand(len(pairs), k, k) < 0.4,
                      rng.uniform(0.05, 1.0, (len(pairs), k, k)),
                      -1.0).astype(np.float32)
    args = (scores, peaks, pairs, info.num_parts, 3, 0.4, 1.5,
            maximize_positives)
    got = assembly.connect_body_parts(*args)
    want = jassembly.connect_body_parts(*args)
    assert got[0].shape[0] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("in_wh,net_wh,number,gap", [
    ((80, 64), (80, 64), 1, 0.25), ((80, 64), (-1, 64), 1, 0.25),
    ((200, 120), (160, 96), 4, 0.25), ((1280, 720), (-1, 368), 1, 0.25),
    ((1920, 1080), (1312, 736), 4, 0.25), ((160, 48), (-1, 64), 2, 0.3),
])
def test_scale_plans_equal(in_wh, net_wh, number, gap):
    got = scaler.extract_scales(in_wh, net_wh, number, gap)
    want = jscaler.extract_scales(in_wh, net_wh, number, gap)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert scaler.resize_get_scale_factor(in_wh, got.net_input_sizes[0]) \
        == jscaler.resize_get_scale_factor(in_wh, want.net_input_sizes[0])
    dyn = scaler.extract_scales(in_wh, (-1, 64), 1, gap,
                                net_resolution_dynamic=1.0)
    jdyn = jscaler.extract_scales(in_wh, (-1, 64), 1, gap,
                                  net_resolution_dynamic=1.0)
    assert dataclasses.asdict(dyn) == dataclasses.asdict(jdyn)


PROTOTXT = """
name: "small"
input: "image"
input_dim: 1
input_dim: 3
input_dim: 16
input_dim: 16
layer { name: "conv1" type: "Convolution" bottom: "image" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "net_output"
  convolution_param { num_output: 2 kernel_size: 1 } }
"""


def test_caffe_proto_round_trip_equal():
    """A small net's prototxt and caffemodel through both parsers."""
    got = caffe_proto.parse_prototxt(PROTOTXT)
    want = jproto.parse_prototxt(PROTOTXT)
    assert got.to_json() == want.to_json()
    assert caffe_proto.NetSpec.from_json(got.to_json()).to_json() \
        == got.to_json()
    rng = np.random.RandomState(0)
    layers = {"conv1": [rng.randn(4, 3, 3, 3).astype(np.float32),
                        rng.randn(4).astype(np.float32)],
              "conv2": [rng.randn(2, 4, 1, 1).astype(np.float32),
                        rng.randn(2).astype(np.float32)]}
    blob = caffe_proto.serialize_caffemodel(layers)
    assert blob == jproto.serialize_caffemodel(layers)
    got_blobs = caffe_proto.parse_caffemodel(blob)
    want_blobs = jproto.parse_caffemodel(blob)
    assert got_blobs.keys() == want_blobs.keys() == layers.keys()
    for name, arrays in layers.items():
        for g, w, a in zip(got_blobs[name], want_blobs[name], arrays):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, a)


def test_zoo_finds_weights_under_a_model_folder_like_jax(tmp_path):
    """`model_folder` and `prototxt` of the loaders (what `PoseConfig`
    hands them): the reference's folder layout, an explicit caffemodel
    first, random weights where neither exists."""
    import torch
    from openpose_tpu.models import zoo as jzoo
    from openpose_tpu_torch.models import zoo
    assert {k.name: v for k, v in zoo.CAFFEMODEL_PATHS.items()} \
        == {k.name: v for k, v in jzoo.CAFFEMODEL_PATHS.items()}
    assert zoo.FACE_CAFFEMODEL_PATH == jzoo.FACE_CAFFEMODEL_PATH
    assert zoo.HAND_CAFFEMODEL_PATH == jzoo.HAND_CAFFEMODEL_PATH
    prototxt = tmp_path / "small.prototxt"
    prototxt.write_text(PROTOTXT)
    rng = np.random.RandomState(0)
    layers = {"conv1": [rng.randn(4, 3, 3, 3).astype(np.float32),
                        rng.randn(4).astype(np.float32)],
              "conv2": [rng.randn(2, 4, 1, 1).astype(np.float32),
                        rng.randn(2).astype(np.float32)]}
    weights = tmp_path / zoo.CAFFEMODEL_PATHS[params.PoseModel.BODY_25]
    weights.parent.mkdir(parents=True)
    weights.write_bytes(caffe_proto.serialize_caffemodel(layers))
    for args in ((None, str(tmp_path)), (str(weights), None),
                 (str(weights), str(tmp_path / "nowhere"))):
        assert zoo.resolve_caffemodel(*args, "pose/body_25/pose_iter_584000"
                                      ".caffemodel") \
            == jzoo.resolve_caffemodel(*args, "pose/body_25/pose_iter_584000"
                                       ".caffemodel") == str(weights)
    assert zoo.resolve_caffemodel(None, str(tmp_path), "face/none") is None
    found = zoo.load_pose_model(device="cpu", model_folder=str(tmp_path),
                                prototxt=str(prototxt))
    state = found.net.state_dict()
    got = next(v for k, v in state.items() if v.shape == (4, 3, 3, 3))
    assert torch.equal(got, torch.from_numpy(layers["conv1"][0]))
    assert found.info.name == "BODY_25"
    seeded = zoo.load_pose_model(device="cpu", prototxt=str(prototxt),
                                 model_folder=str(tmp_path / "nowhere"))
    assert not torch.equal(
        next(v for v in seeded.net.state_dict().values()
             if v.shape == (4, 3, 3, 3)), got)


@pytest.mark.parametrize("name", ["body_25", "coco_18", "mpi_15", "mpi_15_4",
                                  "face_70", "hand_21"])
def test_spec_files_equal(name):
    """The six spec JSONs, parsed, equal the JAX package's."""
    mine = json.loads((PORT / "models" / "specs" / f"{name}.json").read_text())
    theirs = json.loads((ROOT / "openpose_tpu" / "models" / "specs"
                         / f"{name}.json").read_text())
    assert mine == theirs
    assert caffe_proto.NetSpec.from_json(mine).to_json() \
        == jproto.NetSpec.from_json(theirs).to_json()


def _seeded_people(seed, n_people=3, hw=(368, 656)):
    return jscenes.random_people(np.random.RandomState(seed), n_people, hw)


def test_people_json_equal():
    people = _seeded_people(4)
    rng = np.random.RandomState(4)
    kwargs = dict(pose_keypoints=people,
                  face_keypoints=rng.rand(3, 70, 3).astype(np.float32),
                  hand_left_keypoints=rng.rand(3, 21, 3).astype(np.float32),
                  hand_right_keypoints=rng.rand(3, 21, 3).astype(np.float32))
    assert json_io.people_json(**kwargs) == jjson.people_json(**kwargs)
    assert json_io.people_json(pose_keypoints=people[:0]) \
        == jjson.people_json(pose_keypoints=people[:0])
    assert json_io.image_id_from_name("COCO_val2014_000000000192.jpg") \
        == jjson.image_id_from_name("COCO_val2014_000000000192.jpg")


@pytest.mark.parametrize("seed", [0, 5])
def test_face_and_hand_rectangles_equal(seed):
    people = _seeded_people(seed)
    people[1, 17, 2] = 0.0        # a profile view: one ear unseen
    people[2, 4, 2] = 0.0         # a missing wrist
    assert face.detect_faces(people, params.PoseModel.BODY_25) \
        == jface.detect_faces(people, jparams.PoseModel.BODY_25)
    assert hand.detect_hands(people, params.PoseModel.BODY_25) \
        == jhand.detect_hands(people, jparams.PoseModel.BODY_25)
    mpi = people[:, :15]
    assert face.detect_faces(mpi, params.PoseModel.MPI_15) \
        == jface.detect_faces(mpi, jparams.PoseModel.MPI_15)


def test_synthetic_scene_helpers_equal():
    """`synthetic.random_people` and its drawing pairs are the port's copy
    of the JAX package's scene helpers: same numbers from the same seed."""
    assert synthetic.BODY25_DRAW_PAIRS == jscenes.BODY25_DRAW_PAIRS
    np.testing.assert_array_equal(synthetic.BODY25_TEMPLATE,
                                  jscenes.BODY25_TEMPLATE)
    for seed, n, hw in ((0, 3, (368, 656)), (7, 5, (720, 1280))):
        got = synthetic.random_people(np.random.RandomState(seed), n, hw,
                                      height_range=(0.4 * hw[0], 0.8 * hw[0]))
        want = jscenes.random_people(np.random.RandomState(seed), n, hw,
                                     height_range=(0.4 * hw[0], 0.8 * hw[0]))
        np.testing.assert_array_equal(got, want)
