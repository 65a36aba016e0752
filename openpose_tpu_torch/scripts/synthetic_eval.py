"""Closed-loop synthetic COCO AP through the real user path, on the port.

Counterpart of the repository's `scripts/synthetic_eval.py`, over
`openpose_tpu_torch.accuracy`: synthetic multi-person scenes are rendered
to net-output tensors on the device, injected into `PoseInference` in
place of the CNN (the reference's Datum::poseNetOutput hook), decoded by
the standard post chain (NMS -> PAF scoring -> greedy assembly ->
CocoJsonSaver) and scored with the built-in pycocotools-exact evaluator.
At the default 127-peak budget every batch goes through the fused PAF
kernel once.

Usage:
  python -m openpose_tpu_torch.scripts.synthetic_eval          # clean AP
  python -m openpose_tpu_torch.scripts.synthetic_eval --sweep  # sweeps
  python -m openpose_tpu_torch.scripts.synthetic_eval --images 128 \\
      --out results.json
Runs on the card; `--cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from openpose_tpu_torch import device as device_rule


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--net_resolution", default="656x368",
                    help="WxH (reference flag convention)")
    ap.add_argument("--people", default="1-4", help="people per image range")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="correlated map-noise stddev")
    ap.add_argument("--kp_jitter", type=float, default=0.0,
                    help="rendered-keypoint jitter stddev (px)")
    ap.add_argument("--sweep", action="store_true",
                    help="run the full noise + jitter sweeps")
    ap.add_argument("--topdown", choices=("face", "hand"), default="",
                    help="instead of body AP, run the closed-loop face/"
                         "hand localization eval (accuracy."
                         "synthetic_topdown_eval)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default="", help="write results JSON here")
    args = ap.parse_args(argv)

    device = torch.device("cpu") if args.cpu \
        else device_rule.default_device()
    from openpose_tpu_torch import accuracy

    w, h = (int(v) for v in args.net_resolution.split("x"))
    lo, _, hi = args.people.partition("-")
    people = (int(lo), int(hi or lo))
    kw = dict(n_images=args.images, net_hw=(h, w), people_range=people,
              batch=args.batch, seed=args.seed, device=device)

    if args.topdown:
        results = accuracy.synthetic_topdown_eval(
            args.topdown, n_frames=args.images, frame_hw=(h, w),
            people_range=people, batch=args.batch, seed=args.seed,
            device=device)
        print(json.dumps(results))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
        return 0

    if args.sweep:
        results = {"noise_sweep": accuracy.noise_sweep(**kw),
                   "jitter_sweep": accuracy.jitter_sweep(**kw)}
        for name, rows in results.items():
            print(f"# {name}")
            for m in rows:
                level = m["noise"] if name == "noise_sweep" else m["kp_jitter"]
                print(f"  level={level:<5} AP={m['AP']:.4f} "
                      f"AP50={m['AP50']:.4f} AP75={m['AP75']:.4f} "
                      f"AR={m['AR']:.4f}")
    else:
        results = accuracy.synthetic_coco_eval(
            noise=args.noise, kp_jitter=args.kp_jitter, **kw)
        print(json.dumps(results))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
