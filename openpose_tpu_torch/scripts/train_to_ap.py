"""Train-to-AP demo on the port: BODY_25 from scratch on synthetic scenes
-> pipeline AP.

Counterpart of the repository's `scripts/train_to_ap.py`, over
`openpose_tpu_torch.accuracy.train_to_ap`: trains with
`train_loop.train` on rendered skeleton scenes, then measures COCO AP
through the real user path on held-out scenes.  Writes the metrics to
`--out`, by default `TRAIN2AP_torch.json` in the working directory (the
JAX script's `TRAIN2AP.json` stays the JAX package's record).  The port's
scenes are drawn by its own numpy renderer, so its stream differs from the
JAX script's, which draws with OpenCV.

Usage: python -m openpose_tpu_torch.scripts.train_to_ap --steps 1500 \\
    --schedule cosine [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from openpose_tpu_torch import device as device_rule


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--image_size", default="184x328", help="HxW")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--eval_images", type=int, default=16)
    ap.add_argument("--schedule", default="constant",
                    choices=("constant", "cosine"))
    ap.add_argument("--sigma", type=float, default=7.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default="TRAIN2AP_torch.json")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu \
        else device_rule.default_device()
    from openpose_tpu_torch.accuracy import train_to_ap

    h, w = (int(v) for v in args.image_size.split("x"))
    m = train_to_ap(steps=args.steps, image_size=(h, w), batch=args.batch,
                    learning_rate=args.lr, n_eval=args.eval_images,
                    lr_schedule=args.schedule, target_sigma=args.sigma,
                    device=device)
    print(json.dumps(m))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(m, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
