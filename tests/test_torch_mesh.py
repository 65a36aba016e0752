"""The port's device mesh and sharded bundle adjustment against the JAX
package's (CPU, two gloo processes).

One module fixture starts two processes through `torch.multiprocessing`
(spawn, a file `init_method` under the test's temporary directory, no
network) that build meshes, take `param_sharding` of a BODY_25 param tree
made by `checkpoint.from_jax_params`, and run the sharded
`bundle_adjust`; each writes what it found to a file that the tests read.
JAX runs in this process on 2 of its 8 virtual CPU devices.  Tolerances:
placements equal leaf by leaf (JAX's HWIO dimension 3 is the port's OIHW
dimension 0); bundle adjustment within 1e-3, the JAX suite's
sharded-vs-single limit.
"""

import pickle
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from openpose_tpu.models import graph as jgraph
from openpose_tpu.parallel import mesh as jmesh
from openpose_tpu.params import POSE_MODEL_INFO as JAX_POSE_MODEL_INFO
from openpose_tpu.params import PoseModel as JaxPoseModel
from openpose_tpu.threed import bundle_adjustment as jba
from openpose_tpu_torch.threed import bundle_adjustment as ba
from tests.test_bundle import _scene

WORLD = 2
ITERATIONS = 5
JOIN_SECONDS = 240


def _ba_inputs(split=False):
    """The JAX suite's sharded-vs-single scene: 16 points, 4 cameras.
    split: the second rank's 8 points observed exactly where the wrong
    start cameras put them, so a camera step raises that rank's own cost
    while it lowers the total: the ranks accept alike only when they
    decide on the summed cost."""
    pts, obs, k, _, ext0 = _scene(n_points=16, cam_err=0.03)
    mask = np.ones(obs.shape[:2], np.float32)
    pts0 = pts + 0.02
    if split:
        homog = np.concatenate([pts0[8:], np.ones((8, 1))], 1)
        proj = np.einsum("vij,vjk,nk->nvi", k, ext0, homog)
        obs = obs.copy()
        obs[8:] = proj[..., :2] / proj[..., 2:3]
    return pts0, obs, mask, k, ext0


def _body25_shapes():
    """{layer: {key: shape}} of BODY_25's JAX params (HWIO weights), from
    the JAX initialiser's shapes alone."""
    spec = jgraph.load_spec(JAX_POSE_MODEL_INFO[JaxPoseModel.BODY_25].spec)
    tree = jax.eval_shape(lambda: jgraph.init_params(
        spec, jax.random.PRNGKey(0)))
    return {layer: {key: tuple(leaf.shape) for key, leaf in sub.items()}
            for layer, sub in tree.items()}


def _names(placements):
    return [f"Shard({p.dim})" if hasattr(p, "dim") else type(p).__name__
            for p in placements]


def _worker(rank, init_file, out_dir, shapes, inputs, split_inputs):
    """One rank: meshes, placements, the sharded bundle adjustment."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from openpose_tpu_torch.models import checkpoint
    from openpose_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=WORLD, rank=rank)
    try:
        out = {}
        data2 = mesh_lib.make_mesh(device_type="cpu")
        model2 = mesh_lib.make_mesh(model=2, device_type="cpu")
        out["shapes"] = [(tuple(m.shape), m.mesh_dim_names, m.device_type)
                         for m in (data2, model2)]
        out["local_ranks"] = [data2.get_local_rank("data"),
                              model2.get_local_rank("model")]
        try:
            mesh_lib.make_mesh(data=3, device_type="cpu")
        except ValueError as e:
            out["value_error"] = str(e)
        params = checkpoint.from_jax_params(
            {layer: {key: np.zeros(shape, np.float32)
                     for key, shape in sub.items()}
             for layer, sub in shapes.items()})
        for tag, m in (("data2", data2), ("model2", model2)):
            out[tag] = {layer: {key: _names(p) for key, p in sub.items()}
                        for layer, sub in mesh_lib.param_sharding(
                            m, params).items()}
        out["batch"] = _names(mesh_lib.batch_sharding(model2))
        out["replicated"] = _names(mesh_lib.replicated(model2))
        # the placements apply: a sharded weight's local shard and a head
        w = params["conv1_1"]["w"]
        local = distribute_tensor(
            w, model2, mesh_lib.param_sharding(model2, params)["conv1_1"]
            ["w"]).to_local()
        out["conv1_1_local"] = (tuple(w.shape), tuple(local.shape))
        out["ba"] = ba.bundle_adjust(*inputs, iterations=ITERATIONS,
                                     mesh=data2)
        out["ba_split"] = ba.bundle_adjust(*split_inputs,
                                           iterations=ITERATIONS, mesh=data2)
        try:
            ba.bundle_adjust(*(a[:15] for a in inputs[:3]), *inputs[3:],
                             iterations=1, mesh=data2)
        except ValueError as e:
            out["ba_value_error"] = str(e)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two gloo ranks found."""
    tmp = tmp_path_factory.mktemp("mesh")
    ctx = mp.start_processes(
        _worker, args=(str(tmp / "init"), str(tmp), _body25_shapes(),
                       _ba_inputs(), _ba_inputs(split=True)),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "gloo ranks did not finish"
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    out = []
    for rank in range(WORLD):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_make_mesh_shapes(ranks):
    for rank, got in enumerate(ranks):
        assert got["shapes"] == [((2, 1), ("data", "model"), "cpu"),
                                 ((1, 2), ("data", "model"), "cpu")]
        assert got["local_ranks"] == [rank, rank]
    jax_meshes = [jmesh.make_mesh(jax.devices()[:2], model=m)
                  for m in (1, 2)]
    assert [tuple(m.devices.shape) for m in jax_meshes] == [(2, 1), (1, 2)]
    assert [m.axis_names for m in jax_meshes] == [("data", "model")] * 2


def test_make_mesh_raises_as_jax_does(ranks):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(jax.devices()[:2], data=3)
    for got in ranks:
        assert got["value_error"] == str(want.value) == "mesh 3x1 != 2 devices"


def _jax_placements(spec, ndim):
    """A JAX PartitionSpec as the port's placements over (data, model),
    HWIO dimensions moved to OIHW."""
    to_oihw = {0: 2, 1: 3, 2: 1, 3: 0} if ndim == 4 else {0: 0}
    names = []
    for axis in ("data", "model"):
        dims = [d for d, name in enumerate(spec) if name == axis]
        names.append(f"Shard({to_oihw[dims[0]]})" if dims else "Replicate")
    return names


@pytest.mark.parametrize("tag,model", [("data2", 1), ("model2", 2)])
def test_param_sharding_equals_jax_leaf_by_leaf(ranks, tag, model):
    shapes = _body25_shapes()
    tree = jax.eval_shape(lambda: {
        layer: {key: jax.ShapeDtypeStruct(shape, np.float32)
                for key, shape in sub.items()}
        for layer, sub in shapes.items()})
    want = jmesh.param_sharding(jmesh.make_mesh(jax.devices()[:2],
                                                model=model), tree)
    sharded = 0
    for got in ranks:
        assert got[tag].keys() == want.keys()
        for layer, sub in want.items():
            assert got[tag][layer].keys() == sub.keys(), layer
            for key, sharding in sub.items():
                ndim = len(shapes[layer][key])
                assert got[tag][layer][key] == _jax_placements(
                    sharding.spec, ndim), (layer, key)
                sharded += got[tag][layer][key][1] != "Replicate"
    assert sharded > 0


def test_batch_and_replicated_placements(ranks):
    for got in ranks:
        assert got["batch"] == ["Shard(0)", "Replicate"]
        assert got["replicated"] == ["Replicate", "Replicate"]
        full, local = got["conv1_1_local"]
        assert local == (full[0] // 2,) + full[1:]


@pytest.mark.parametrize("split", [False, True], ids=["scene", "split"])
def test_sharded_bundle_adjust_equals_unsharded_and_jax(ranks, split):
    inputs = _ba_inputs(split)
    key = "ba_split" if split else "ba"
    single = ba.bundle_adjust(*inputs, iterations=ITERATIONS, device="cpu")
    mesh = jmesh.make_mesh(jax.devices()[:2], model=1)
    jax_sharded = jba.bundle_adjust(*inputs, iterations=ITERATIONS,
                                    mesh=mesh)
    for got in ranks:
        for g, s, w in zip(got[key], single, jax_sharded):
            assert g.shape == s.shape == w.shape
            np.testing.assert_allclose(g, s, atol=1e-3)
            np.testing.assert_allclose(g, w, atol=1e-3)
    # every rank returns the whole answer, the same on both
    for a, b in zip(ranks[0][key], ranks[1][key]):
        np.testing.assert_array_equal(a, b)


def test_sharded_bundle_adjust_raises_when_points_do_not_divide(ranks):
    for got in ranks:
        assert got["ba_value_error"] \
            == "15 points do not divide over the mesh's 2 data shards"
