"""Device-only train-step timing.

Counterpart of the repository's `scripts/profile_train_step.py`, over
`train_loop.device_step_probe`: BODY_25 (seeded weights) takes `n` real
optimizer steps (targets rendered, images normalized, loss, gradients,
Adam) on a batch that is already on the device, timed between two CUDA
events after 3 warm-up steps, so that no upload from the host is in the
figure.  Prints one JSON line: the step's ms, images/s, TFLOP/s by the
3x-forward convention and share of the card's datasheet peak (null where
the table has none, as on the CPU), with `image_size`, `batch` and the
device's name (`device_kind`).

Usage:
  python -m openpose_tpu_torch.scripts.profile_train_step
      [--image_size 368x656] [--batch 8]
Runs on the card; `--cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.utils import benchmark


def main(argv=None, device=None) -> dict:
    """Returns the printed record."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image_size", default="368x656", help="HxW")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    device = torch.device("cpu") if args.cpu else device_rule.resolve(device)
    from openpose_tpu_torch.params import PoseModel
    from openpose_tpu_torch.train_loop import TrainConfig, device_step_probe

    h, w = (int(v) for v in args.image_size.split("x"))
    config = TrainConfig(model=PoseModel.BODY_25, image_size=(h, w),
                         batch_size=args.batch)
    out = device_step_probe(config, device=device)
    out.update(image_size=f"{h}x{w}", batch=args.batch,
               device_kind=benchmark.device_name(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
