"""Entry points: the flagship device pipeline and the multi-device
dry run.

Counterpart of the repository's `__graft_entry__.py`.  `entry()` returns
`(fn, example_args)`: `fn(net, images)` is the BODY_25 pipeline on the
device, VGG normalisation -> CNN forward -> Catmull-Rom resize of the 25
part maps to the net's input size -> NMS (threshold 0.05, 127 peaks) ->
PAF pair scores (the fused kernel at this budget): the serving paths'
decode, `pose/extractor.py::BodyDecoder`.  It returns `(peaks [N,
25, 128, 3], scores [N, 26, 127, 127])`; `example_args` are the seeded
random BODY_25 net and one black 368x656 image, both on the device.
`dryrun_multichip` is `parallel/dryrun.py`'s, re-exported.

Usage:
  python -m openpose_tpu_torch.entry [n] [--cpu]
runs `dryrun_multichip(n)` (8 by default) on a world of n ranks, one card
each (NCCL; it raises `NoCudaDeviceError` with fewer cards than ranks),
or with `--cpu` n gloo ranks on the CPU, and prints rank 0's findings.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
from typing import Tuple, Union

import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.models import zoo
from openpose_tpu_torch.ops import resize
from openpose_tpu_torch.parallel import mesh as mesh_lib
from openpose_tpu_torch.parallel.dryrun import dryrun_multichip
from openpose_tpu_torch.params import PoseModel, default_connect_params
from openpose_tpu_torch.pose.extractor import BodyDecoder
from openpose_tpu_torch.scripts.scaling_bench import (
    rank_device, require_cards, run_world)

__all__ = ["entry", "dryrun_multichip", "main"]

# the benchmark geometry of the reference's headline (BASELINE.md)
NET_HW = (368, 656)


def entry(device: Union[str, torch.device, None] = None,
          net_hw: Tuple[int, int] = NET_HW,
          compute_dtype: torch.dtype = torch.bfloat16):
    """(fn, example_args) on `device`, the card when None (raises
    `NoCudaDeviceError` where there is none).  `net_hw` and
    `compute_dtype` (the CNN's; the heatmap path is float32 either way)
    exist so that a test can run the same pipeline small and in float32;
    their defaults are the original's."""
    device = device_rule.resolve(device)
    model = zoo.load_pose_model(PoseModel.BODY_25, seed=0, device=device)
    # BODY_25's default limits: NMS 0.05, PAF 0.05 and 0.95
    decoder = BodyDecoder(model.info, 127,
                          default_connect_params(PoseModel.BODY_25), False,
                          device)

    @torch.inference_mode()
    def fn(net, images):
        out = net(resize.normalize_vgg(images), compute_dtype)
        return decoder.decode([out], [1.0], net_hw, 0.5)

    example_args = (model.net, torch.zeros((1, *net_hw, 3),
                                           dtype=torch.float32, device=device))
    return fn, example_args


def _rank(rank, world, init_file, device_type, out_file):
    device = rank_device(rank, world, device_type)
    with mesh_lib.process_group(init_file, world, rank, device) as device:
        found = dryrun_multichip(world, device)
        if rank == 0:
            pathlib.Path(out_file).write_text(json.dumps(found))


def main(argv=None) -> dict:
    """Runs the dry run on a world of ranks, prints rank 0's findings and
    returns them."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="ranks (one card each)")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    device_type = "cpu" if args.cpu else "cuda"
    if device_type == "cuda":
        require_cards(args.n)
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        out = pathlib.Path(tmp) / "rank0.json"
        run_world(_rank, args.n, (args.n, str(pathlib.Path(tmp) / "init"),
                                  device_type, str(out)))
        found = json.loads(out.read_text())
    print(json.dumps(found))
    return found


if __name__ == "__main__":
    main()
