"""The import guard compares whole top-level module names."""

import sys
import types

import pytest

from perfbench import run


@pytest.mark.parametrize("module, caught", [
    ("openpose_tpu", "openpose_tpu"), ("openpose_tpu.ops.nms", "openpose_tpu"),
    ("jax", "jax"), ("jax.numpy", "jax"), ("jaxlib", "jaxlib"),
    ("flax.linen", "flax"), ("openpose_tpu_torch", None),
    ("openpose_tpu_torch.ops", None), ("jaxtyping", None)])
def test_guard_names_whole_top_level_names(monkeypatch, module, caught):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
    assert run.forbidden_modules() == ([caught] if caught else [])


def test_the_harness_and_the_port_load_no_jax():
    import importlib
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            pytest.skip("this process already holds JAX")
    for mod in ("perfbench.loops", "perfbench.check", "perfbench.control"):
        importlib.import_module(mod)
    assert run.forbidden_modules() == []
