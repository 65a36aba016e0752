"""Scaling analysis: the collectives of the port's sharded programs.

Counterpart of the repository's `scripts/analyze_scaling.py`, with its
report: `inference` and `train`, each with its `mesh`, the `collectives`
one call ran (by the original's names: `all-reduce`, `all-gather`, ...)
and what that means for `scaling`.  Data-parallel inference that runs no
collective is embarrassingly parallel: each card runs its own rows and
throughput scales with the cards up to the input feed.  The train step
reduces the gradient once a step and, on a ``model`` dimension of 2,
gathers the weight shards (DTensor) where it uses them.

A world of `--ranks` processes (8 by default, the original's 8 devices)
joins one process group: one card a rank (NCCL; with fewer cards than
ranks it raises `NoCudaDeviceError`), or with `--cpu` gloo ranks on the
CPU.  Every rank runs
(1) MPI_15_4 at 64x64 in float32 through `PoseInference` on a data mesh
of all ranks, and (2) one float32 train step of MPI_15_4 at 32x32 on a
(data = ranks / 2, model = 2) mesh (model 1 for an odd world);
`parallel/dryrun.py::collective_census` counts what the process groups
ran in each, and rank 0 reports.

Usage:
  python -m openpose_tpu_torch.scripts.analyze_scaling [--ranks 8] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile

import torch

from openpose_tpu_torch.scripts.scaling_bench import (
    JOIN_SECONDS, rank_device, require_cards, run_world)


def _dims(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _rank(rank, world, init_file, device_type, out_file):
    from openpose_tpu_torch import train
    from openpose_tpu_torch.models import graph, zoo
    from openpose_tpu_torch.ops import paf as paf_ops
    from openpose_tpu_torch.ops.resize import normalize_vgg
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    from openpose_tpu_torch.parallel.dryrun import collective_census
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.params import POSE_MODEL_INFO, PoseModel
    device = rank_device(rank, world, device_type)
    with mesh_lib.process_group(init_file, world, rank, device) as device:
        # 1. data-parallel inference: no collective expected
        mesh = mesh_lib.make_mesh(device_type=device.type)
        model = zoo.load_pose_model(PoseModel.MPI_15_4, seed=0,
                                    device=device)
        inference = PoseInference(model, net_hw=(64, 64),
                                  compute_dtype=torch.float32, mesh=mesh)
        frames = torch.zeros((world, 64, 64, 3))[inference.local_rows(world)]
        inference.fetch(*inference(frames))              # warm
        _, inf_coll = collective_census(
            lambda: inference.fetch(*inference(frames)))

        # 2. the sharded train step: the gradient all-reduce expected
        tmesh = mesh_lib.make_mesh(model=2 if world % 2 == 0 else 1,
                                   device_type=device.type)
        info = POSE_MODEL_INFO[PoseModel.MPI_15_4]
        state = train.init_train_state(
            graph.load_spec(info.spec), torch.Generator().manual_seed(0),
            1e-4, device, mesh=tmesh)
        data = mesh_lib.size(tmesh, "data")
        rows = mesh_lib.local_rows(tmesh, 8 if 8 % data == 0 else data)
        n = rows.stop - rows.start
        pairs, map_idx = (torch.from_numpy(t).to(device)
                          for t in paf_ops.pair_tables(info))
        targets = train.make_targets(
            torch.zeros((n, 1, info.num_parts, 3), device=device), pairs,
            map_idx, (32, 32), info.num_parts, info.heatmap_channels)
        images = normalize_vgg(torch.zeros((n, 32, 32, 3), device=device))
        step = train.make_train_step(torch.float32, tmesh)
        _, tr_coll = collective_census(
            lambda: float(step(state, images, targets)[1]))
    if rank == 0:
        pathlib.Path(out_file).write_text(json.dumps({
            "inference": {
                "mesh": _dims(mesh), "collectives": inf_coll,
                "scaling": ("embarrassingly parallel: no cross-device "
                            "communication; throughput scales linearly "
                            "with cards up to input-feed bandwidth"
                            if not inf_coll else "has collectives"),
            },
            "train": {
                "mesh": _dims(tmesh), "collectives": tr_coll,
                "scaling": "the gradient all-reduce runs once a step "
                           + ("over NVLink between cards"
                              if device.type == "cuda" else
                              "between the gloo processes")
                           + (", after the weight shards' all-gathers"
                              if _dims(tmesh)["model"] > 1 else ""),
            },
        }))


def main(argv=None, timeout: float = JOIN_SECONDS) -> dict:
    """Runs the world (for at most `timeout` seconds), prints the report
    and returns it."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    device_type = "cpu" if args.cpu else "cuda"
    if device_type == "cuda":
        require_cards(args.ranks)
    with tempfile.TemporaryDirectory(prefix="analyze_scaling_") as tmp:
        out = pathlib.Path(tmp) / "report.json"
        run_world(_rank, args.ranks, (args.ranks, str(pathlib.Path(tmp)
                                                      / "init"),
                                      device_type, str(out)), timeout)
        report = json.loads(out.read_text())
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
