"""The port's Python API (`pyopenpose`) and C ABI (`capi` and its C shim)
against the JAX package's (CPU, float32).

The weights and frames are `tests/test_torch_cli.py`'s: the JAX net's
random parameters as a caffemodel under a model folder, scenes of two
drawn people.  `WrapperPython` reads no dtype from its params on either
side (bfloat16, as the reference's default), so both wrappers get a
float32 extractor over their own loaded net after `start()`.  Tolerances
are the wrapper tests': keypoints within 1e-2 px, scores within 1e-3.
"""

import ctypes
import json
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp

from openpose_tpu import capi as jcapi
from openpose_tpu import pyopenpose as jop
from openpose_tpu.pose.extractor import PoseExtractor as JaxPoseExtractor
from openpose_tpu_torch import capi, cli
from openpose_tpu_torch import pyopenpose as op
from openpose_tpu_torch.pose.extractor import PoseExtractor
from openpose_tpu_torch.utils import native_build
from tests.test_torch_cli import (
    NET, assert_keypoints_close, write_frames, write_model_folder)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bindings")
    return {"models": write_model_folder(root / "models"),
            "images": str(root / "images"),
            "frames": write_frames(root / "images", count=3, seed=1)}


def _params(inputs, **over):
    params = {"model_folder": inputs["models"], "net_resolution": NET}
    params.update(over)
    return params


@pytest.fixture(scope="module")
def wrappers(inputs):
    """Started WrapperPython pairs at render_pose 0 and 1 (the port's), and
    the JAX one, all in float32."""
    mine = op.WrapperPython(device="cpu")
    mine.configure(_params(inputs, render_pose=0))
    mine.start()
    drawn = op.WrapperPython(device="cpu")
    drawn.configure(_params(inputs))
    drawn.start()
    theirs = jop.WrapperPython()
    theirs.configure(_params(inputs))
    theirs.start()
    for w in (mine, drawn):
        w._wrapper.pose_extractor = PoseExtractor(
            w._wrapper.pose_extractor.model, compute_dtype=torch.float32,
            device="cpu")
    theirs._wrapper.pose_extractor = JaxPoseExtractor(
        theirs._wrapper.pose_extractor.model, compute_dtype=jnp.float32)
    return mine, drawn, theirs


def _datums(module, frames):
    out = []
    for i, frame in enumerate(frames):
        d = module.Datum()
        d.id, d.name, d.cvInputData = i, f"scene_{i:03d}", frame
        out.append(d)
    return out


def test_module_surface_equals_jax():
    assert op.__all__ == jop.__all__
    for name in op.__all__:
        assert hasattr(op, name), name
    for model in ("BODY_25", "COCO_18", "MPI_15", "MPI_15_4"):
        assert op.getPoseBodyPartMapping(model) \
            == jop.getPoseBodyPartMapping(model)
        assert op.getPoseNumberBodyParts(model) \
            == jop.getPoseNumberBodyParts(model)
        assert op.getPosePartPairs(model) == jop.getPosePartPairs(model)
        assert op.getPoseMapIndex(model) == jop.getPoseMapIndex(model)
    assert op.BODY_25.value == jop.BODY_25.value
    assert vars(op.Datum()).keys() == vars(jop.Datum()).keys()
    assert op.get_gpu_number() == torch.cuda.device_count()


def test_init_argv_and_images_on_directory(inputs):
    assert op.get_images_on_directory(inputs["images"]) \
        == jop.get_images_on_directory(inputs["images"])
    argv = ["--net_resolution", "-1x64", "--face", "--model_pose=COCO_18"]
    saved = dict(op._GLOBAL_PARAMS), dict(jop._GLOBAL_PARAMS)
    try:
        op._GLOBAL_PARAMS.clear()
        jop._GLOBAL_PARAMS.clear()
        op.init_argv(argv)
        jop.init_argv(argv)
        assert op._GLOBAL_PARAMS == jop._GLOBAL_PARAMS
    finally:
        op._GLOBAL_PARAMS.clear()
        op._GLOBAL_PARAMS.update(saved[0])
        jop._GLOBAL_PARAMS.clear()
        jop._GLOBAL_PARAMS.update(saved[1])


def test_emplace_and_pop_equals_jax(wrappers, inputs):
    mine, drawn, theirs = wrappers
    got = _datums(op, inputs["frames"])
    want = _datums(jop, inputs["frames"])
    rendered = _datums(op, inputs["frames"])
    assert mine.emplaceAndPop(op.VectorDatum(got))
    assert theirs.emplaceAndPop(jop.VectorDatum(want))
    assert drawn.emplaceAndPop(op.VectorDatum(rendered))
    people = 0
    for g, w, r in zip(got, want, rendered):
        assert_keypoints_close(g.poseKeypoints, w.poseKeypoints, g.name)
        np.testing.assert_allclose(g.poseScores, w.poseScores, atol=1e-3)
        assert g.poseKeypoints.shape == w.poseKeypoints.shape
        people += len(g.poseKeypoints)
        assert g.scaleInputToNetInputs == pytest.approx(
            w.scaleInputToNetInputs)
        assert g.netInputSizes == w.netInputSizes
        assert g.netOutputSize == w.netOutputSize
        assert g.scaleNetToOutput == pytest.approx(w.scaleNetToOutput)
        assert g.frameNumber == w.frameNumber
        # render_pose 0: the output is the input frame, nothing drawn
        assert g.cvOutputData is g.cvInputData
        assert g.outputData is g.cvInputData
        assert g.elementRendered == (0, "")
        # render_pose 1 (the default): the skeletons of the same people
        np.testing.assert_array_equal(r.poseKeypoints, g.poseKeypoints)
        assert r.cvOutputData.shape == g.cvInputData.shape
        assert r.elementRendered == w.elementRendered == (0, "pose")
        assert (r.cvOutputData != r.cvInputData).any()
        assert (r.cvOutputData != w.cvOutputData).mean() < 1e-3
    assert people > 0


def test_wait_and_emplace_keeps_the_order(wrappers, inputs):
    mine = wrappers[0]
    frames = inputs["frames"]
    direct = _datums(op, frames)
    mine.emplaceAndPop(direct)
    for d in _datums(op, frames):
        assert mine.waitAndEmplace([d])
    popped = []
    for _ in frames:
        out = []
        assert mine.waitAndPop(out)
        popped += out
    assert not mine.waitAndPop([])
    assert [d.name for d in popped] == [d.name for d in direct]
    for p, d in zip(popped, direct):
        np.testing.assert_array_equal(p.poseKeypoints, d.poseKeypoints)


def test_rendering_without_opencv_raises(wrappers, inputs, monkeypatch):
    """At render_pose 1 the datum is drawn, which needs OpenCV: without it
    emplaceAndPop raises ImportError; at 0 it needs none."""
    import openpose_tpu_torch.render
    mine, drawn, _ = wrappers
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.delitem(sys.modules, "openpose_tpu_torch.render.render")
    monkeypatch.delattr(openpose_tpu_torch.render, "render")
    with pytest.raises(ImportError):
        drawn.emplaceAndPop(_datums(op, inputs["frames"][:1]))
    assert mine.emplaceAndPop(_datums(op, inputs["frames"][:1]))


def test_wrapper_python_runs_on_the_card_unless_told(inputs, monkeypatch):
    from openpose_tpu_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = op.WrapperPython()
    w.configure(_params(inputs))
    with pytest.raises(device.NoCudaDeviceError):
        w.start()
    with pytest.raises(device.NoCudaDeviceError):
        capi.create(json.dumps({"net_resolution": NET}))


def test_execute_runs_the_port_cli(inputs, tmp_path):
    """`execute()` is the port's CLI with the configured params as flags,
    on the wrapper's device.  The JAX one passes "-1x64" as a token of its
    own, which argparse takes for a flag."""
    w = op.WrapperPython(device="cpu")
    flags = dict(image_dir=inputs["images"], model_folder=inputs["models"],
                 net_resolution=NET, fp32=True, batch=1, render_pose=0,
                 write_json=str(tmp_path / "execute"))
    w.configure(flags)
    assert w.execute() == 0
    theirs = jop.WrapperPython()
    theirs.configure(flags)
    with pytest.raises(SystemExit):
        theirs.execute()
    assert cli.main(["--image_dir", inputs["images"], "--model_folder",
                     inputs["models"], f"--net_resolution={NET}", "--fp32",
                     "--batch", "1", "--render_pose", "0", "--write_json",
                     str(tmp_path / "cli")], device="cpu") == 0
    got = sorted((tmp_path / "execute").iterdir())
    want = sorted((tmp_path / "cli").iterdir())
    assert [p.name for p in got] == [p.name for p in want]
    assert len(got) == 3
    for g, w_ in zip(got, want):
        assert g.read_text() == w_.read_text()


CAPI_CONFIG = {"net_resolution": NET, "compute_dtype": "float32"}


def test_capi_process_equals_jax(inputs):
    config = dict(CAPI_CONFIG, model_folder=inputs["models"])
    mine = capi.create(json.dumps(dict(config, device="cpu")))
    theirs = jcapi.create(json.dumps(config))
    try:
        people = 0
        for i, frame in enumerate(inputs["frames"]):
            args = (frame.tobytes(), frame.shape[0], frame.shape[1], i)
            got, want = capi.process(mine, *args), jcapi.process(theirs, *args)
            assert got[1:] == want[1:]
            people += got[1]
            if got[1]:
                assert got[2] == 25
                assert_keypoints_close(np.frombuffer(got[0], np.float32),
                                       np.frombuffer(want[0], np.float32),
                                       f"frame {i}")
        assert people > 0
        drawn = capi.render(mine, *args)
        assert len(drawn) == frame.size
    finally:
        capi.destroy(mine)
        jcapi.destroy(theirs)
    with pytest.raises(KeyError):
        capi.process(mine, *args)


@pytest.fixture(scope="module")
def shim():
    """The port's C shim, built with g++ from its source and loaded into
    this interpreter (it reuses the running one through PyGILState)."""
    lib = ctypes.CDLL(str(native_build.build_capi()))
    lib.op_create.restype = ctypes.c_void_p
    lib.op_create.argtypes = [ctypes.c_char_p]
    lib.op_process.restype = ctypes.c_int
    lib.op_process.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.op_render.restype = ctypes.c_int
    lib.op_render.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
    lib.op_last_error.restype = ctypes.c_char_p
    lib.op_destroy.argtypes = [ctypes.c_void_p]
    lib.op_free_floats.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.op_free_bytes.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
    return lib


def test_shim_source_is_the_shared_one_with_the_port_module():
    shared = (native_build.NATIVE_DIR / "c_api.cpp").read_text()
    assert native_build.CAPI_SOURCE.read_text() \
        == shared.replace("openpose_tpu.capi", "openpose_tpu_torch.capi")


def test_shim_process_and_render_equal_jax(shim, inputs):
    config = dict(CAPI_CONFIG, model_folder=inputs["models"])
    handle = shim.op_create(json.dumps(dict(config, device="cpu")).encode())
    assert handle, shim.op_last_error().decode()
    theirs = jcapi.create(json.dumps(config))
    try:
        for i, frame in enumerate(inputs["frames"][:2]):
            image = np.ascontiguousarray(frame)
            kp_ptr = ctypes.POINTER(ctypes.c_float)()
            people, parts = ctypes.c_int(), ctypes.c_int()
            rc = shim.op_process(
                handle, image.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                image.shape[0], image.shape[1], ctypes.byref(kp_ptr),
                ctypes.byref(people), ctypes.byref(parts))
            assert rc == 0, shim.op_last_error().decode()
            want = jcapi.process(theirs, image.tobytes(), *image.shape[:2])
            assert (people.value, parts.value) == want[1:]
            if people.value:
                got = np.ctypeslib.as_array(
                    kp_ptr, shape=(people.value, parts.value, 3)).copy()
                shim.op_free_floats(kp_ptr)
                assert_keypoints_close(got, np.frombuffer(want[0],
                                                          np.float32),
                                       f"frame {i}")
        frame_ptr = ctypes.POINTER(ctypes.c_ubyte)()
        rc = shim.op_render(
            handle, image.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            image.shape[0], image.shape[1], ctypes.byref(frame_ptr))
        assert rc == 0, shim.op_last_error().decode()
        drawn = np.ctypeslib.as_array(frame_ptr, shape=image.shape).copy()
        shim.op_free_bytes(frame_ptr)
        assert drawn.shape == image.shape
    finally:
        shim.op_destroy(handle)
        jcapi.destroy(theirs)


def test_shim_reports_errors(shim):
    kp_ptr = ctypes.POINTER(ctypes.c_float)()
    people, parts = ctypes.c_int(), ctypes.c_int()
    assert shim.op_process(None, None, 0, 0, ctypes.byref(kp_ptr),
                           ctypes.byref(people), ctypes.byref(parts)) != 0
    assert b"bad arguments" in shim.op_last_error()
    assert not shim.op_create(json.dumps(
        {"model_pose": "NOPE", "device": "cpu"}).encode())
    assert b"NOPE" in shim.op_last_error()
