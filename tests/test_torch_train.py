"""The port's trainer vs the JAX package's (CPU, float32).

The same inputs, made from a numpy seed, go through `openpose_tpu.train` /
`train_loop` / `models.checkpoint` and their counterparts in
`openpose_tpu_torch`; weights cross through `checkpoint.from_jax_params`
and gradients come back through `checkpoint.to_jax_params`.

Tolerances: rendered targets 1e-6 (the same float32 formulas; `exp` and the
division may differ in the last bit); one step's loss 1e-5 relative and its
gradients 1e-3 of each tensor's largest entry (dozens of layers of float32
sums taken in another order); five Adam steps' losses 1e-3 relative, step
by step; schedules 1e-6 of the peak rate (optax computes them in float32);
forward passes on exchanged checkpoints 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openpose_tpu import train as jtrain
from openpose_tpu import train_loop as jtrain_loop
from openpose_tpu.models import checkpoint as jcheckpoint
from openpose_tpu.models import graph as jgraph
from openpose_tpu.ops import paf as jpaf
from openpose_tpu.params import POSE_MODEL_INFO as JAX_INFO
from openpose_tpu.params import PoseModel as JaxPoseModel
from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch import synthetic, train, train_loop
from openpose_tpu_torch.models import checkpoint, graph, zoo
from openpose_tpu_torch.ops import paf
from openpose_tpu_torch.parallel.inference import PoseInference
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
from openpose_tpu_torch.pose.extractor import PoseExtractor

SPECS = ["body_25", "coco_18", "mpi_15", "mpi_15_4", "face_70", "hand_21"]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once: two threads per worker keep
    torch's thread pool from fighting the others for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tables(model):
    info = POSE_MODEL_INFO[model]
    pairs, map_idx = paf.pair_tables(info)
    return info, pairs, map_idx


def _scene_keypoints(model, hw, seed):
    """[2, 3, parts, 3]: random people, two of them laid over each other so
    that both cover the same PAF cells, one keypoint invalid, one slot
    empty."""
    info = POSE_MODEL_INFO[model]
    rng = np.random.RandomState(seed)
    kp = np.zeros((2, 3, info.num_parts, 3), np.float32)
    for b in range(2):
        people = synthetic.random_people(rng, 2, hw, height_range=(
            0.5 * hw[0], 0.9 * hw[0]))[:, :info.num_parts]
        kp[b, :2] = people
    kp[0, 1] = kp[0, 0]                 # a second person on the same limbs,
    kp[0, 1, :, 0] += 1.5               # 1.5 px beside the first
    kp[1, 0, 3, 2] = 0.0                # an invalid keypoint
    return kp


@pytest.mark.parametrize("model", [PoseModel.BODY_25, PoseModel.MPI_15_4],
                         ids=lambda m: m.name)
def test_make_targets_equals_jax(model):
    hw = (96, 128)
    info, pairs, map_idx = _tables(model)
    kp = _scene_keypoints(model, hw, seed=3)
    want = np.asarray(jtrain.make_targets(
        jnp.asarray(kp), jnp.asarray(pairs), jnp.asarray(map_idx), hw,
        info.num_parts, info.heatmap_channels))
    got = train.make_targets(
        torch.from_numpy(kp), torch.from_numpy(pairs),
        torch.from_numpy(map_idx), hw, info.num_parts,
        info.heatmap_channels)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the scene does what it says: a cell that two people cover, averaged
    off = info.num_parts + 1
    assert np.abs(want[0, :, :, off:]).max() > 0.5
    twin = synthetic.make_targets(kp, pairs, map_idx, hw, info.num_parts,
                                  info.heatmap_channels)
    np.testing.assert_allclose(got.numpy(), twin, rtol=0, atol=1e-6)
    sharp = train.make_targets(
        torch.from_numpy(kp), torch.from_numpy(pairs),
        torch.from_numpy(map_idx), hw, info.num_parts,
        info.heatmap_channels, sigma=3.0)
    want_sharp = np.asarray(jtrain.make_targets(
        jnp.asarray(kp), jnp.asarray(pairs), jnp.asarray(map_idx), hw,
        info.num_parts, info.heatmap_channels, sigma=3.0))
    np.testing.assert_allclose(sharp.numpy(), want_sharp, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model", [m for m in PoseModel
                                   if m in POSE_MODEL_INFO],
                         ids=lambda m: m.name)
def test_pairs_share_no_paf_channel(model):
    """`make_targets` assigns all x and y planes at once: right only while
    no two pairs write one channel."""
    info, _, map_idx = _tables(model)
    slots = map_idx.reshape(-1) - (info.num_parts + 1)
    assert len(set(slots.tolist())) == slots.size
    assert slots.min() >= 0
    assert slots.max() < info.heatmap_channels - info.num_parts - 1


@pytest.fixture(autouse=True)
def _quiet(recwarn):
    """numpy arrays made by JAX are read-only; torch warns when it wraps
    one, and nothing here writes to them."""
    yield


def _mpi_problem(batch=2):
    """MPI_15_4 at 48x48 (the size of the JAX suite's training test): JAX's
    initial weights, the same in the port, random images, one person's
    targets."""
    info = JAX_INFO[JaxPoseModel.MPI_15_4]
    spec = jgraph.load_spec(info.spec)
    params = jgraph.init_params(spec, jax.random.PRNGKey(0))
    pairs, map_idx = jpaf.pair_tables(info)
    kp = np.zeros((batch, 1, info.num_parts, 3), np.float32)
    kp[:, 0, :, 0] = 20.0
    kp[:, 0, :, 1] = 20.0
    kp[:, 0, :, 2] = 1.0
    targets = np.asarray(jtrain.make_targets(
        jnp.asarray(kp), jnp.asarray(pairs), jnp.asarray(map_idx), (48, 48),
        info.num_parts, info.heatmap_channels))
    rng = np.random.RandomState(0)
    images = rng.uniform(-0.5, 0.5, (batch, 48, 48, 3)).astype(np.float32)
    return spec, params, images, targets


def _port_params(jax_params):
    return checkpoint.from_jax_params(
        {k: {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in jax_params.items()})


def test_one_step_loss_and_gradients_equal_jax():
    spec, params, images, targets = _mpi_problem()
    want_loss, want_grads = jax.value_and_grad(jtrain.loss_fn)(
        params, spec, jnp.asarray(images), jnp.asarray(targets), jnp.float32)
    net = graph.PoseNet(graph.load_spec("mpi_15_4"), _port_params(params),
                        trainable=True)
    # PyTorch's own CPU convolutions: oneDNN's float32 sums leave an error
    # of 1e-6 of a data gradient's largest entry, and the early stages'
    # share of the concatenated gradients is a thousand times smaller than
    # that entry (their gradients then differ from a float64 run by up to
    # 1e-2, where JAX's and PyTorch's own stay within 1e-6)
    with torch.backends.mkldnn.flags(enabled=False):
        loss = train.loss_fn(net, torch.from_numpy(images),
                             torch.from_numpy(targets))
        loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    grads = {}
    for name, p in net.weights.items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        layer, key = name.rsplit("__", 1)
        grads.setdefault(layer, {})[key] = p.grad
    got_grads = checkpoint.to_jax_params(grads)
    assert got_grads.keys() == want_grads.keys()
    for layer, sub in want_grads.items():
        for key, want in sub.items():
            want = np.asarray(want)
            got = got_grads[layer][key]
            assert got.shape == want.shape, (layer, key)
            tol = 1e-3 * max(float(np.abs(want).max()), 1e-12)
            assert np.abs(got - want).max() <= tol, (layer, key)


def test_five_adam_steps_equal_jax():
    # on random images, not the JAX suite's zero ones: there every
    # activation is exactly 0 at step 0, where `jnp.maximum(x, 0)` hands
    # half the gradient on and `F.relu` none, and the runs part ways
    spec, params, images, targets = _mpi_problem()
    optimizer = optax.adam(1e-3)
    jstate = jtrain.TrainState(params, optimizer.init(params),
                               jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrain.make_train_step(spec, optimizer, jnp.float32))
    state = train.init_train_state(
        graph.load_spec("mpi_15_4"), torch.Generator().manual_seed(0), 1e-3,
        device="cpu", params=_port_params(params))
    step = train.make_train_step(torch.float32)
    assert state.step == 0
    want, got = [], []
    for _ in range(5):
        jstate, jloss = jstep(jstate, jnp.asarray(images),
                              jnp.asarray(targets))
        want.append(float(jloss))
        state, loss = step(state, torch.from_numpy(images),
                           torch.from_numpy(targets))
        got.append(float(loss))
    assert state.step == 5 and int(jstate.step) == 5
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert all(bool(torch.isfinite(p).all()) for p in state.net.parameters())


def test_adam_is_optax_adam():
    """`torch.optim.Adam` with the port's settings against `optax.adam` on
    the same gradients: eps outside the square root, bias-corrected."""
    rng = np.random.RandomState(1)
    x0 = rng.randn(7).astype(np.float32)
    grads = (rng.randn(6, 7) * [[1e-6], [1.0], [1e3], [1e-9], [0.0], [2.0]]
             ).astype(np.float32)
    optimizer = optax.adam(1e-2)
    opt_state, x = optimizer.init(jnp.asarray(x0)), jnp.asarray(x0)
    p = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    adam = torch.optim.Adam([p], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        updates, opt_state = optimizer.update(jnp.asarray(g), opt_state, x)
        x = optax.apply_updates(x, updates)
        p.grad = torch.from_numpy(g.copy())
        adam.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(x),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,steps", [("cosine", 50), ("constant", 50),
                                        ("cosine", 7)])
def test_schedule_equals_optax(name, steps):
    """Every step of a run, and a few past its end; the warm-up is cut to a
    tenth of the run as in the JAX trainer."""
    config = train_loop.TrainConfig(steps=steps, lr_schedule=name,
                                    learning_rate=3e-4)
    got = train_loop.learning_rate_of(config)
    if name == "cosine":
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=config.learning_rate,
            warmup_steps=min(config.warmup_steps, max(1, steps // 10)),
            decay_steps=steps, end_value=config.learning_rate * 0.01)
    else:
        want = lambda step: config.learning_rate
        got = (lambda rate: lambda step: rate)(got)
    for step in range(steps + 3):
        assert got(step) == pytest.approx(float(want(step)), rel=0,
                                          abs=1e-6 * config.learning_rate)
    state = train.init_train_state(
        graph.load_spec("mpi_15_4"), torch.Generator().manual_seed(0),
        train_loop.learning_rate_of(config), device="cpu")
    assert state.schedule(steps // 2) == pytest.approx(
        float(want(steps // 2)), rel=1e-5)


@pytest.mark.parametrize("name", SPECS)
def test_count_flops_equals_jax(name):
    for hw in ((368, 656), (184, 328), (100, 75)):
        got = graph.count_flops(graph.load_spec(name), hw)
        want = jgraph.count_flops(jgraph.load_spec(name), hw)
        assert got == want
    if name == "body_25":
        assert 280e9 < sum(graph.count_flops(graph.load_spec(name),
                                             (368, 656)).values()) < 295e9


@pytest.mark.parametrize("model", [PoseModel.BODY_25, PoseModel.COCO_18,
                                   PoseModel.MPI_15_4], ids=lambda m: m.name)
def test_coco_to_model_keypoints_equals_jax(model):
    rng = np.random.RandomState(4)
    kp17 = rng.uniform(0, 200, (3, 17, 3)).astype(np.float32)
    kp17[..., 2] = rng.randint(0, 3, (3, 17))
    kp17[0, 5, 2] = 0                       # no neck for person 0
    for max_people in (2, 5):
        got = train_loop.coco_to_model_keypoints(kp17, model, max_people)
        want = jtrain_loop.coco_to_model_keypoints(
            kp17, JaxPoseModel[model.name], max_people)
        np.testing.assert_array_equal(got, want)
    assert dict(train_loop._COCO17_TO_BODY25) \
        == dict(jtrain_loop._COCO17_TO_BODY25)


def test_train_config_equals_jax():
    got = {f.name: f.default for f in
           train_loop.TrainConfig.__dataclass_fields__.values()}
    want = {f.name: f.default for f in
            jtrain_loop.TrainConfig.__dataclass_fields__.values()}
    assert {k: getattr(v, "name", v) for k, v in got.items()} \
        == {k: getattr(v, "name", v) for k, v in want.items()}


def test_params_round_trip_is_bit_exact():
    """JAX layout -> port -> a net with channels-last storage -> JAX layout:
    the same bits, in logical HWIO order and not in memory order."""
    spec = jgraph.load_spec("mpi_15_4")
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in jgraph.init_params(
                  spec, jax.random.PRNGKey(2)).items()}
    net = graph.PoseNet(graph.load_spec("mpi_15_4"),
                        checkpoint.from_jax_params(params))
    w = net.param("conv1_1", "w")
    assert w.is_contiguous(memory_format=torch.channels_last)
    back = checkpoint.to_jax_params(net.params())
    assert back.keys() == params.keys()
    for layer, sub in params.items():
        assert back[layer].keys() == sub.keys()
        for key, want in sub.items():
            got = back[layer][key]
            assert got.dtype == np.float32 and got.flags.c_contiguous
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_of_one_package_loads_in_the_other(tmp_path, writer):
    spec = jgraph.load_spec("mpi_15_4")
    x = np.random.RandomState(5).uniform(-0.5, 0.5, (1, 48, 64, 3)) \
        .astype(np.float32)
    path = str(tmp_path / "sub" / "weights.npz")
    if writer == "port":
        model = zoo.load_pose_model(PoseModel.MPI_15_4, seed=3, device="cpu")
        checkpoint.save(path, model.net.params())
        with torch.inference_mode():
            wrote = model.forward(torch.from_numpy(x)).numpy()
        read = np.asarray(jgraph.forward(jcheckpoint.load(path), spec,
                                         jnp.asarray(x), jnp.float32))
    else:
        params = jgraph.init_params(spec, jax.random.PRNGKey(3))
        jcheckpoint.save(path, params)
        wrote = np.asarray(jgraph.forward(params, spec, jnp.asarray(x),
                                          jnp.float32))
        net = graph.PoseNet(graph.load_spec("mpi_15_4"),
                            checkpoint.load_npz(path))
        with torch.inference_mode():
            read = net(torch.from_numpy(x)).numpy()
    assert np.abs(wrote).max() > 1e-3
    np.testing.assert_allclose(read, wrote, rtol=0, atol=1e-4)
    # and the file is the other package's own, key for key
    with np.load(path) as data:
        keys = set(data.files)
        shapes = {k: data[k].shape for k in keys}
    other = str(tmp_path / "other.npz")
    if writer == "port":
        jcheckpoint.save(other, jgraph.init_params(spec,
                                                   jax.random.PRNGKey(0)))
    else:
        checkpoint.save(other, graph.init_params(
            graph.load_spec("mpi_15_4"), torch.Generator().manual_seed(0)))
    with np.load(other) as data:
        assert set(data.files) == keys
        assert {k: data[k].shape for k in keys} == shapes


def test_wrapper_serves_a_checkpoint_by_its_constructor(tmp_path):
    """A `.npz` checkpoint named where a caffemodel would be reaches
    `zoo.load_pose_model` and, through `PoseConfig.caffemodel`, `Wrapper`:
    the weights served are the file's, bit for bit."""
    from openpose_tpu_torch.wrapper import PoseConfig, Wrapper
    trained = zoo.load_pose_model(PoseModel.MPI_15_4, seed=7, device="cpu")
    path = str(tmp_path / "MPI_15_4_step3.npz")
    checkpoint.save(path, trained.net.params())
    loaded = zoo.load_pose_model(PoseModel.MPI_15_4, caffemodel=path,
                                 device="cpu")
    wrapper = Wrapper(PoseConfig(model=PoseModel.MPI_15_4, caffemodel=path,
                                 net_resolution=(64, 48),
                                 compute_dtype="float32"), device="cpu")
    for net in (loaded.net, wrapper.pose_extractor.model.net):
        got = net.params()
        for layer, sub in trained.net.params().items():
            for key, want in sub.items():
                assert torch.equal(got[layer][key], want), (layer, key)
                assert not got[layer][key].requires_grad
    frame = np.random.RandomState(1).randint(0, 255, (48, 64, 3)) \
        .astype(np.uint8)
    assert wrapper.process(frame).pose_keypoints.shape[1:] == (15, 3)


@pytest.mark.parametrize("n_parts,hw,n_people", [
    (25, (184, 328), 3), (25, (96, 160), 2), (15, (120, 200), 3)])
def test_device_renderer_equals_numpy_renderer(n_parts, hw, n_people):
    """`render_scene_batch` against `render_scene_image` on the same people
    and the same background draws.  The two run the same float32
    arithmetic, so they are expected to agree pixel for pixel; at most 0.1%
    of the pixels may differ (a distance within rounding of a stroke's
    radius)."""
    rng = np.random.RandomState(6)
    batch = 3
    kps = np.zeros((batch, 4, n_parts, 3), np.float32)
    background = np.zeros((batch, *hw, 3), np.uint8)
    want = []
    for b in range(batch):
        people = synthetic.random_people(
            rng, n_people, hw, height_range=(0.45 * hw[0], 0.9 * hw[0]),
            min_spacing=60.0)[:, :n_parts]
        if b == 1:
            people[0, 4, 2] = 0.0      # an unseen joint and its limbs
        if b == 2:
            people = people[:1]
        kps[b, :len(people)] = people
        state = rng.get_state()
        want.append(synthetic.render_scene_image(people, hw, rng))
        rng.set_state(state)
        background[b] = synthetic.scene_background(hw, rng)
    got = synthetic.render_scene_batch(kps, torch.from_numpy(background))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (batch, *hw, 3)
    differ = (got.numpy() != np.stack(want)).any(axis=-1)
    assert differ.mean() <= 1e-3, differ.mean()
    assert np.stack(want).max() > 100          # skeletons drawn
    # no people: the background comes back
    empty = synthetic.render_scene_batch(np.zeros_like(kps),
                                         torch.from_numpy(background))
    np.testing.assert_array_equal(empty.numpy(), background)


def test_scene_iterator_keeps_the_jax_iterators_seeds():
    """The same keypoints, batch after batch, as the JAX iterator from the
    same seed (so the host's random stream is the same, the background
    draws included), and images that are the numpy renderer's."""
    config = train_loop.TrainConfig(image_size=(96, 160), batch_size=2,
                                    max_people=4)
    jconfig = jtrain_loop.TrainConfig(image_size=(96, 160), batch_size=2,
                                      max_people=4)
    it = train_loop.synthetic_scene_iterator(config, seed=7, device="cpu")
    jit = jtrain_loop.synthetic_scene_iterator(jconfig, seed=7)
    rng = np.random.RandomState(7)
    for _ in range(2):
        imgs, kps = next(it)
        _, jkps = next(jit)
        assert imgs.dtype == torch.uint8 and imgs.device.type == "cpu"
        assert tuple(imgs.shape) == (2, 96, 160, 3)
        assert kps.shape == (2, 4, 25, 3) and kps[..., 2].max() == 1.0
        np.testing.assert_array_equal(kps, jkps)
        for b in range(2):
            people = synthetic.random_people(
                rng, rng.randint(1, 4), (96, 160),
                height_range=(80.0, 96 * 0.9), min_spacing=60.0)
            want = synthetic.render_scene_image(people, (96, 160), rng)
            assert (imgs[b].numpy() != want).any(axis=-1).mean() <= 1e-3


def test_scene_iterator_prefetch_threads_stop():
    config = train_loop.TrainConfig(model=PoseModel.MPI_15_4,
                                    image_size=(48, 64), batch_size=2,
                                    max_people=3)
    it = train_loop.synthetic_scene_iterator(config, seed=0,
                                             prefetch_workers=2, device="cpu")
    imgs, kps = next(it)
    assert tuple(imgs.shape) == (2, 48, 64, 3) and kps.shape == (2, 3, 15, 3)
    import threading
    before = threading.active_count()
    it.close()
    import time
    deadline = time.time() + 10
    while threading.active_count() > before - 2 and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before - 2


def test_coco_data_iterator_equals_jax(tmp_path):
    """On images and annotations that the test writes itself."""
    import cv2
    rng = np.random.RandomState(8)
    images, annotations = [], []
    for image_id, (h, w) in enumerate([(60, 80), (90, 70), (50, 50)], 1):
        name = f"{image_id:06d}.png"
        cv2.imwrite(str(tmp_path / name),
                    rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        images.append({"id": image_id, "file_name": name})
        for _ in range(image_id):
            kp = rng.uniform(0, min(h, w), (17, 3))
            kp[:, 2] = rng.randint(0, 3, 17)
            annotations.append({"image_id": image_id, "num_keypoints": 5,
                                "keypoints": kp.reshape(-1).tolist()})
    annotations.append({"image_id": 1, "num_keypoints": 0,
                        "keypoints": [0.0] * 51})
    path = tmp_path / "annotations.json"
    path.write_text(json.dumps({"images": images,
                                "annotations": annotations}))
    config = train_loop.TrainConfig(image_size=(48, 64), batch_size=3,
                                    max_people=2)
    jconfig = jtrain_loop.TrainConfig(image_size=(48, 64), batch_size=3,
                                      max_people=2)
    it = train_loop.coco_data_iterator(str(tmp_path), str(path), config, 2)
    jit = jtrain_loop.coco_data_iterator(str(tmp_path), str(path), jconfig, 2)
    for _ in range(2):
        (imgs, kps), (jimgs, jkps) = next(it), next(jit)
        assert imgs.shape == (3, 48, 64, 3) and imgs.max() > 100
        np.testing.assert_array_equal(imgs, jimgs)
        np.testing.assert_array_equal(kps, jkps)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`train_loop.train` for 3 steps of MPI_15_4 at 48x64."""
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    config = train_loop.TrainConfig(
        model=PoseModel.MPI_15_4, image_size=(48, 64), batch_size=2,
        max_people=3, steps=3, checkpoint_every=2,
        checkpoint_dir=str(ckpt_dir))
    stats = {}
    state = train_loop.train(
        config, train_loop.synthetic_scene_iterator(config, device="cpu"),
        verbose=False, stats_out=stats, device="cpu")
    return config, state, stats, ckpt_dir


def test_train_writes_the_jax_trainers_checkpoints(trained, tmp_path):
    config, state, stats, ckpt_dir = trained
    assert state.step == 3
    assert sorted(p.name for p in ckpt_dir.iterdir()) \
        == ["MPI_15_4_step2.npz", "MPI_15_4_step3.npz"]
    assert set(stats["losses"]) == {0, 2}
    assert all(np.isfinite(v) for v in stats["losses"].values())
    assert all(bool(torch.isfinite(p).all()) for p in state.net.parameters())
    for key in ("img_s", "step_ms", "train_tflops", "fwd_gflops_img"):
        assert np.isfinite(stats[key]) and stats[key] > 0, key
    # a CPU run is held against no card's peak
    assert stats["train_mfu"] is None and stats["peak_tflops"] is None
    assert stats["fwd_gflops_img"] == pytest.approx(sum(jgraph.count_flops(
        jgraph.load_spec("mpi_15_4"), (48, 64)).values()) / 1e9)
    # the JAX trainer's file: the same keys and shapes, and JAX loads it
    reference = str(tmp_path / "jax.npz")
    jspec = jgraph.load_spec("mpi_15_4")
    jcheckpoint.save(reference, jgraph.init_params(jspec,
                                                   jax.random.PRNGKey(0)))
    with np.load(reference) as want, \
            np.load(ckpt_dir / "MPI_15_4_step3.npz") as got:
        assert set(got.files) == set(want.files)
        assert all(got[k].shape == want[k].shape
                   and got[k].dtype == want[k].dtype for k in want.files)
    x = np.random.RandomState(9).uniform(-0.5, 0.5, (1, 48, 64, 3)) \
        .astype(np.float32)
    loaded = jcheckpoint.load(str(ckpt_dir / "MPI_15_4_step3.npz"))
    with torch.inference_mode():
        want = state.net.serving_view()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        np.asarray(jgraph.forward(loaded, jspec, jnp.asarray(x),
                                  jnp.float32)), want, rtol=0, atol=1e-4)
    # the last checkpoint is the final state, the earlier one is not
    final = checkpoint.load_npz(str(ckpt_dir / "MPI_15_4_step3.npz"))
    early = checkpoint.load_npz(str(ckpt_dir / "MPI_15_4_step2.npz"))
    w = state.params["conv1_1"]["w"]
    assert torch.equal(final["conv1_1"]["w"], w)
    assert not torch.equal(early["conv1_1"]["w"], w)


def test_serving_a_trained_net_records_no_graph(trained):
    """Training did not change what serving does: the trainer's weights
    take gradients, the serving view over the same storage does not, and
    neither `PoseInference` nor `PoseExtractor` hands out a tensor with a
    graph, given the serving view or even the trainer's own net."""
    config, state, _, _ = trained
    info = POSE_MODEL_INFO[PoseModel.MPI_15_4]
    assert all(p.requires_grad for p in state.net.parameters())
    serving = state.net.serving_view()
    assert not any(p.requires_grad for p in serving.parameters())
    assert serving.param("conv1_1", "w").data_ptr() \
        == state.net.param("conv1_1", "w").data_ptr()
    loaded = zoo.load_pose_model(PoseModel.MPI_15_4, device="cpu")
    assert not any(p.requires_grad for p in loaded.net.parameters())
    frames = np.random.RandomState(10).randint(
        0, 255, (2, 48, 64, 3)).astype(np.uint8)
    for net in (serving, state.net):
        model = zoo.Model(spec=net.spec, net=net, info=info)
        inference = PoseInference(model, net_hw=(48, 64), device="cpu",
                                  compute_dtype=torch.float32)
        outputs = list(inference.net_outputs(frames)) \
            + list(inference(frames))
        extractor = PoseExtractor(model, compute_dtype=torch.float32,
                                  device="cpu")
        plan_outputs = extractor.decode(extractor.net_outputs(
            torch.from_numpy(frames[:1]).to(torch.float32),
            inference.plan), inference.plan, 0.5)
        for t in outputs + list(plan_outputs):
            assert not t.requires_grad and t.grad_fn is None
        pred = extractor.forward(frames[0], net_resolution=(64, 48))
        assert isinstance(pred.keypoints, np.ndarray)
    # a step after the view was made shows in it: one storage
    before = serving.param("conv1_1", "w").clone()
    step = train.make_train_step()
    images = torch.zeros((1, 48, 64, 3))
    step(state, images, torch.zeros((1, 6, 8, info.heatmap_channels)) + 0.5)
    assert not torch.equal(serving.param("conv1_1", "w"), before)


def test_train_rounds_float_images_like_jax(monkeypatch):
    """Float images are rounded to uint8, not truncated: 10.6 trains as 11."""
    config = train_loop.TrainConfig(
        model=PoseModel.MPI_15_4, image_size=(48, 64), batch_size=1,
        max_people=1, steps=1, checkpoint_dir="unused")
    seen = []

    class Trainer(train_loop.Trainer):
        def step(self, images, keypoints):
            seen.append(images)
            return torch.zeros(())

    kps = np.zeros((1, 1, 15, 3), np.float32)
    data = iter([(np.full((1, 48, 64, 3), 10.6, np.float32), kps)])
    monkeypatch.setattr(train_loop, "Trainer", Trainer)
    monkeypatch.setattr(checkpoint, "save", lambda path, params: None)
    train_loop.train(config, data, verbose=False, device="cpu")
    assert seen[0].dtype == torch.uint8 and int(seen[0].max()) == 11 \
        and int(seen[0].min()) == 11


def test_bf16_step_differentiates():
    """bfloat16 operands over float32 master weights: a finite loss, finite
    float32 gradients for every parameter, and a step that moves them."""
    spec, params, images, targets = _mpi_problem(batch=1)
    state = train.init_train_state(
        graph.load_spec("mpi_15_4"), torch.Generator().manual_seed(0), 1e-3,
        device="cpu", params=_port_params(params))
    before = state.net.param("conv1_1", "w").detach().clone()
    state, loss = train.make_train_step(torch.bfloat16)(
        state, torch.from_numpy(images), torch.from_numpy(targets))
    assert np.isfinite(float(loss))
    for p in state.net.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert bool(torch.isfinite(p.grad).all())
    assert not torch.equal(state.net.param("conv1_1", "w"), before)
    want = float(train.loss_fn(state.net, torch.from_numpy(images),
                               torch.from_numpy(targets)).detach())
    # bfloat16 keeps 8 bits: within 5% of the float32 loss after the step
    got = float(train.loss_fn(state.net, torch.from_numpy(images),
                              torch.from_numpy(targets),
                              torch.bfloat16).detach())
    assert got == pytest.approx(want, rel=5e-2)


def test_model_parallel_is_refused():
    """Without a process group there is no mesh to shard the model over:
    model_parallel other than 1 is refused, naming what it needs (the
    meshed trainer is held in tests/test_torch_sharded.py)."""
    config = train_loop.TrainConfig(model=PoseModel.MPI_15_4,
                                    model_parallel=2, steps=1)
    match = "model_parallel=2 needs a process group of a multiple of 2 ranks"
    with pytest.raises(ValueError, match=match):
        train_loop.train(config, iter([]), device="cpu")
    with pytest.raises(ValueError, match=match):
        train_loop.device_step_probe(config, device="cpu")


def test_device_step_probe_times_real_steps():
    config = train_loop.TrainConfig(model=PoseModel.MPI_15_4,
                                    image_size=(48, 64), batch_size=1)
    out = train_loop.device_step_probe(config, n=2, warmup=1, device="cpu")
    assert set(out) == {"device_step_ms", "device_img_s",
                        "device_train_tflops", "device_train_mfu"}
    assert out["device_step_ms"] > 0
    assert out["device_img_s"] == pytest.approx(1e3 / out["device_step_ms"])
    assert out["device_train_mfu"] is None      # no card, no share of a peak


@pytest.mark.parametrize("entry", [
    lambda: train.init_train_state(graph.load_spec("mpi_15_4"),
                                   torch.Generator().manual_seed(0)),
    lambda: train_loop.train(train_loop.TrainConfig(steps=1), iter([])),
    lambda: train_loop.device_step_probe(train_loop.TrainConfig()),
    lambda: next(train_loop.synthetic_scene_iterator(
        train_loop.TrainConfig())),
], ids=["init_train_state", "train", "device_step_probe", "scene_iterator"])
def test_training_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(device_rule.NoCudaDeviceError):
        entry()
