"""Training loop: keypoint data -> train steps -> checkpoints.

Counterpart of `openpose_tpu/train_loop.py` around `train.py` (the CPM/PAF
objective): data pipelines that turn COCO person-keypoint annotations or
rendered synthetic scenes into (image, keypoint) batches, the loop, and
periodic `.npz` checkpoints in the format both packages read
(`models/checkpoint.py`).

One device, or every rank of an initialised process group: then
`make_mesh(model=TrainConfig.model_parallel)` spans the group, as the
original's mesh spans all devices.  Every rank draws the same global batch
from its (seeded) iterator and keeps its own rows, so the loss stream is the
one-process run's; the host's cost of the draw is paid on every rank.  Rank
0 alone writes the checkpoints, after the model shards are gathered.

Throughput figures use the 3x-forward convention (forward, gradient of the
parameters, gradient of the activations: three times the forward's
multiply-adds) against the datasheet peak of the card the trainer runs on,
for its operands' type (`utils/benchmark.py`; none for a card the table
does not hold).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import queue as queue_mod
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch import synthetic
from openpose_tpu_torch import train as train_mod
from openpose_tpu_torch.models import checkpoint, graph
from openpose_tpu_torch.ops import paf as paf_ops
from openpose_tpu_torch.ops.resize import normalize_vgg
from openpose_tpu_torch.parallel import mesh as mesh_lib
from openpose_tpu_torch.utils import benchmark
from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel

# COCO 17 -> model part index (BODY_25/COCO_18 share the mapping below for
# the COCO-subset joints; neck is synthesized as the shoulder midpoint, the
# standard CPM training recipe).
_COCO17_TO_BODY25 = {
    0: 0, 1: 16, 2: 15, 3: 18, 4: 17, 5: 5, 6: 2, 7: 6, 8: 3, 9: 7, 10: 4,
    11: 12, 12: 9, 13: 13, 14: 10, 15: 14, 16: 11}


def coco_to_model_keypoints(coco_kp: np.ndarray, model: PoseModel,
                            max_people: int) -> np.ndarray:
    """coco_kp [people, 17, 3] -> [max_people, parts, 3] model layout."""
    info = POSE_MODEL_INFO[model]
    out = np.zeros((max_people, info.num_parts, 3), np.float32)
    n = min(coco_kp.shape[0], max_people)
    for person in range(n):
        kp = coco_kp[person]
        for ci, mi in _COCO17_TO_BODY25.items():
            if mi < info.num_parts and kp[ci, 2] > 0:
                out[person, mi] = (kp[ci, 0], kp[ci, 1], 1.0)
        # neck = shoulder midpoint (parts 2 and 5)
        if info.num_parts > 1 and kp[5, 2] > 0 and kp[6, 2] > 0:
            out[person, 1] = ((kp[5, 0] + kp[6, 0]) / 2,
                              (kp[5, 1] + kp[6, 1]) / 2, 1.0)
        # midhip for BODY_25 (part 8) from hips 11/12
        if info.num_parts >= 25 and kp[11, 2] > 0 and kp[12, 2] > 0:
            out[person, 8] = ((kp[11, 0] + kp[12, 0]) / 2,
                              (kp[11, 1] + kp[12, 1]) / 2, 1.0)
    return out


@dataclasses.dataclass
class TrainConfig:
    model: PoseModel = PoseModel.BODY_25
    image_size: Tuple[int, int] = (368, 368)   # (h, w)
    batch_size: int = 8
    max_people: int = 8
    learning_rate: float = 1e-4
    steps: int = 1000
    checkpoint_every: int = 500
    checkpoint_dir: str = "checkpoints"
    model_parallel: int = 1
    # "constant" or "cosine" (linear warmup then cosine decay to 1% of
    # peak — the standard large-batch recipe; constant-LR Adam plateaus
    # with residual localization error on the sub-pixel refinement scale).
    lr_schedule: str = "constant"
    warmup_steps: int = 100
    # Confidence-map Gaussian stddev in input px (CMU openpose_train's
    # sigma; sharper targets sharpen the learned peaks and cut the
    # decoded localization error).
    target_sigma: float = 7.0


def coco_data_iterator(images_dir: str, annotations_json: str,
                       config: TrainConfig, seed: int = 0
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (images [B,H,W,3] f32 BGR 0..255, keypoints
    [B,people,parts,3] in resized-image coords), on the host."""
    import cv2
    with open(annotations_json) as f:
        coco = json.load(f)
    by_image: Dict[int, List[dict]] = {}
    for ann in coco["annotations"]:
        if ann.get("num_keypoints", 0) > 0:
            by_image.setdefault(ann["image_id"], []).append(ann)
    id_to_file = {img["id"]: img["file_name"] for img in coco["images"]}
    image_ids = [i for i in by_image if i in id_to_file]
    rng = np.random.RandomState(seed)
    h, w = config.image_size
    while True:
        batch_imgs = np.zeros((config.batch_size, h, w, 3), np.float32)
        batch_kps = np.zeros(
            (config.batch_size, config.max_people,
             POSE_MODEL_INFO[config.model].num_parts, 3), np.float32)
        for b in range(config.batch_size):
            image_id = image_ids[rng.randint(len(image_ids))]
            img = cv2.imread(str(pathlib.Path(images_dir)
                                 / id_to_file[image_id]))
            if img is None:
                continue
            sy, sx = h / img.shape[0], w / img.shape[1]
            batch_imgs[b] = cv2.resize(img, (w, h)).astype(np.float32)
            kp17 = np.stack([
                np.asarray(a["keypoints"], np.float32).reshape(17, 3)
                for a in by_image[image_id]])
            kp = coco_to_model_keypoints(kp17, config.model,
                                         config.max_people)
            kp[..., 0] *= sx
            kp[..., 1] *= sy
            batch_kps[b] = kp
        yield batch_imgs, batch_kps


def synthetic_scene_iterator(config: TrainConfig, seed: int = 0,
                             people_range: Tuple[int, int] = (1, 3),
                             prefetch_workers: int = 0,
                             device: Union[str, torch.device, None] = None
                             ) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """Yield rendered synthetic scenes endlessly: (images [B,H,W,3] uint8 on
    `device`, the card when None; keypoints [B,people,parts,3] float32 on
    the host).

    The synthetic-domain counterpart of coco_data_iterator: skeletons drawn
    as color-coded joints and limbs with matching keypoint annotations,
    enough to show that training produces a net the full pipeline can
    decode to AP (`accuracy.train_to_ap`).

    The people and the background noise of each scene come from the host's
    `RandomState` in the order `synthetic.render_scene_image` draws them;
    the strokes are painted on the device (`synthetic.render_scene_batch`,
    pixel-equal to the numpy renderer, whose Python loop over 49 strokes a
    person is slower than a train step on a card).

    prefetch_workers > 0: the host's share of each batch (people, noise) is
    made in that many background threads with per-worker seeds and handed
    over a bounded queue.  Batch ORDER becomes interleave-dependent; content
    is still seed-derived."""
    device = device_rule.resolve(device)
    h, w = config.image_size
    n_parts = POSE_MODEL_INFO[config.model].num_parts
    hr = (max(80.0, h * 0.45), h * 0.9)

    def gen(worker_seed: int):
        rng = np.random.RandomState(worker_seed)
        while True:
            background = np.zeros((config.batch_size, h, w, 3), np.uint8)
            kps = np.zeros(
                (config.batch_size, config.max_people, n_parts, 3),
                np.float32)
            for b in range(config.batch_size):
                people = synthetic.random_people(
                    rng, rng.randint(people_range[0], people_range[1] + 1),
                    (h, w), height_range=hr, min_spacing=60.0)
                if n_parts < 25:
                    people = people[:, :n_parts]
                kps[b, :people.shape[0]] = people
                background[b] = synthetic.scene_background((h, w), rng)
            yield background, kps

    def render(host_batch):
        background, kps = host_batch
        return synthetic.render_scene_batch(
            kps, torch.from_numpy(background).to(device)), kps

    if prefetch_workers <= 0:
        for host_batch in gen(seed):
            yield render(host_batch)
        return

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2 * prefetch_workers)
    stop = threading.Event()

    def worker(worker_seed: int):
        it = gen(worker_seed)
        item = next(it)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
            except queue_mod.Full:
                continue
            item = next(it)

    threads = [threading.Thread(target=worker, args=(seed + 1000 * i,),
                                daemon=True)
               for i in range(prefetch_workers)]
    for t in threads:
        t.start()
    try:
        while True:
            yield render(q.get())
    finally:
        stop.set()


def learning_rate_of(config: TrainConfig):
    """The config's learning rate: a constant, or the warm-up and cosine
    schedule as a function of the step (`train.warmup_cosine_schedule`; the
    warm-up is cut to a tenth of the run)."""
    if config.lr_schedule == "cosine":
        return train_mod.warmup_cosine_schedule(
            config.learning_rate,
            min(config.warmup_steps, max(1, config.steps // 10)),
            config.steps, config.learning_rate * 0.01)
    return config.learning_rate


def group_mesh(config: TrainConfig, device: torch.device):
    """The mesh a run trains over: the initialised process group's ranks
    as (data, model=config.model_parallel); None without a group, where
    model_parallel must be 1."""
    if dist.is_initialized():
        return mesh_lib.make_mesh(model=config.model_parallel,
                                  device_type=device.type)
    if config.model_parallel != 1:
        raise ValueError(
            f"model_parallel={config.model_parallel} needs a process group "
            f"of a multiple of {config.model_parallel} ranks (parallel.mesh."
            "process_group); this process has none")
    return None


class Trainer:
    """What `train` and `device_step_probe` share: the state on the device
    and the whole step from a uint8 batch (targets rendered and images
    normalized on the device, then loss, gradients and the Adam update).
    Over a mesh, `step` takes this rank's rows of the global batch
    (`rows`)."""

    def __init__(self, config: TrainConfig, device: torch.device,
                 compute_dtype: torch.dtype, mesh=None):
        self.config = config
        self.device = device
        self.mesh = mesh
        self.rows = mesh_lib.local_rows(mesh, config.batch_size)
        self.info = POSE_MODEL_INFO[config.model]
        self.spec = graph.load_spec(self.info.spec)
        self.state = train_mod.init_train_state(
            self.spec, torch.Generator().manual_seed(0), learning_rate_of(config),
            device, mesh=mesh)
        pairs, map_idx = paf_ops.pair_tables(self.info)
        self.pairs = torch.from_numpy(pairs).to(device)
        self.map_idx = torch.from_numpy(map_idx).to(device)
        self.base_step = train_mod.make_train_step(compute_dtype, mesh)
        self.fwd_gflops = sum(graph.count_flops(
            self.spec, config.image_size).values()) / 1e9
        # the yardstick of a run on a card the datasheet table holds
        self.peak_tflops = benchmark.peak_tflops(
            compute_dtype, benchmark.device_name(device)) or None

    def step(self, images: torch.Tensor, keypoints: torch.Tensor):
        """images [B,H,W,3] uint8 and keypoints on the device -> loss."""
        targets = train_mod.make_targets(
            keypoints, self.pairs, self.map_idx, self.config.image_size,
            self.info.num_parts, self.info.heatmap_channels,
            sigma=self.config.target_sigma)
        _, loss = self.base_step(
            self.state, normalize_vgg(images.to(torch.float32)), targets)
        return loss

    def full_params(self):
        """The weights as full tensors (the model shards gathered: every
        rank calls this)."""
        return mesh_lib.gather_params(self.state.params)

    def rates(self, seconds_per_step: float, prefix: str = "") -> dict:
        """Throughput of a step time by the 3x-forward convention, of the
        global batch."""
        img_s = self.config.batch_size / seconds_per_step
        tflops = 3.0 * self.fwd_gflops * img_s / 1e3
        return {f"{prefix}img_s": img_s,
                f"{prefix}step_ms": 1e3 * seconds_per_step,
                f"{prefix}train_tflops": tflops,
                f"{prefix}train_mfu": tflops / self.peak_tflops
                if self.peak_tflops else None}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_step_probe(config: TrainConfig, n: int = 10, warmup: int = 3,
                      device: Union[str, torch.device, None] = None,
                      compute_dtype: torch.dtype = torch.float32) -> dict:
    """The time of one whole train step with its inputs already on the
    device: `n` real optimizer steps (targets rendered, images normalized,
    loss, gradients, Adam) between two CUDA events, after `warmup` steps.
    On a CPU device the host's clock takes the events' place.

    Returns {device_step_ms, device_img_s, device_train_tflops,
    device_train_mfu}: the 3x-forward FLOPs convention, the share of the
    card's datasheet peak for `compute_dtype`'s operands (None on a CPU
    or a card the table does not hold).
    Over an initialised process group it times the meshed step (`train`'s
    rule), each rank on its rows of the global batch."""
    device = device_rule.resolve(device)
    trainer = Trainer(config, device, compute_dtype,
                      group_mesh(config, device))
    h, w = config.image_size
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(
        0, 255, (config.batch_size, h, w, 3)).astype(np.uint8))
    kp = np.zeros((config.batch_size, 3, trainer.info.num_parts, 3),
                  np.float32)
    kp[..., 0] = rng.uniform(40, w - 40, kp.shape[:-1])
    kp[..., 1] = rng.uniform(40, h - 40, kp.shape[:-1])
    kp[..., 2] = 1.0
    images = images[trainer.rows].to(device)
    keypoints = torch.from_numpy(kp[trainer.rows]).to(device)

    for _ in range(warmup):
        trainer.step(images, keypoints)
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        loss = trainer.step(images, keypoints)
    if device.type == "cuda":
        end.record()
        _sync(device)
        seconds = start.elapsed_time(end) / 1e3 / n
    else:
        seconds = (time.perf_counter() - t0) / n
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"the probe's loss is {float(loss)}")
    return trainer.rates(seconds, prefix="device_")


def train(config: TrainConfig, data: Iterator, verbose: bool = True,
          stats_out: Optional[dict] = None,
          device: Union[str, torch.device, None] = None,
          compute_dtype: torch.dtype = torch.float32
          ) -> train_mod.TrainState:
    """Run the training loop on `device` (the card when None); returns the
    final state.

    data yields (images [B,H,W,3], keypoints [B,people,parts,3]) as numpy
    arrays or tensors; float images are rounded to uint8.  A checkpoint is
    written every `checkpoint_every` steps and at the end, as
    `{model}_step{n}.npz`.

    stats_out: if given, filled with steady-state throughput numbers
    ({img_s, step_ms, train_tflops, train_mfu, fwd_gflops_img,
    peak_tflops}, of the global batch) measured from step 1 onward (step 0
    pays cuDNN's algorithm search), and `losses`, {step: loss} of the
    first, every 50th and the last step.

    Over an initialised process group every rank calls this with the same
    config and an iterator of the same seed (`group_mesh`): each steps on
    its own rows, the losses are the global batch's, rank 0 alone prints
    and writes checkpoints, and every rank returns its own state (the
    rank's shards where `model_parallel` > 1; `Trainer.full_params`)."""
    device = device_rule.resolve(device)
    mesh = group_mesh(config, device)
    trainer = Trainer(config, device, compute_dtype, mesh)
    state, info = trainer.state, trainer.info
    lead = mesh is None or dist.get_rank() == 0
    verbose = verbose and lead
    ckpt_dir = pathlib.Path(config.checkpoint_dir)
    losses: Dict[int, float] = {}
    t0 = time.time()
    t_steady = None                   # set once step 0 has retired
    for step in range(config.steps):
        images, keypoints = next(data)
        images = torch.as_tensor(images)
        if images.dtype != torch.uint8:
            # rint, not truncation: renderers emit fractional pixels and a
            # plain cast would add a ~-0.5 intensity bias
            images = torch.clamp(torch.round(images), 0, 255).to(torch.uint8)
        loss = trainer.step(
            images[trainer.rows].to(device, non_blocking=True),
            torch.as_tensor(keypoints, dtype=torch.float32)[trainer.rows]
            .to(device))
        if step == 0:
            _sync(device)
            t_steady = time.time()
        if step % 50 == 0 or step == config.steps - 1:
            losses[step] = float(loss)
            if verbose:
                rate = (step + 1) * config.batch_size / (time.time() - t0)
                print(f"step {step}: loss {losses[step]:.6f} "
                      f"({rate:.1f} img/s)")
        if (step + 1) % config.checkpoint_every == 0 \
                or step == config.steps - 1:
            path = ckpt_dir / f"{info.name}_step{step + 1}.npz"
            params = trainer.full_params()
            if lead:
                checkpoint.save(str(path), params)
            if verbose:
                print(f"saved {path}")
    _sync(device)
    if hasattr(data, "close"):
        # stop the prefetch threads: they are daemons, but left running
        # they burn CPU through whatever follows (train_to_ap's evaluation)
        data.close()
    if stats_out is not None:
        stats_out["losses"] = losses
        if config.steps > 1 and t_steady is not None:
            dt = time.time() - t_steady
            stats_out.update(trainer.rates(dt / (config.steps - 1)),
                             fwd_gflops_img=trainer.fwd_gflops,
                             peak_tflops=trainer.peak_tflops)
    return state
