"""COCO val AP harness on the port (pose_accuracy_coco_val.sh equivalent,
self-contained).

Counterpart of the repository's `scripts/coco_val.py`: every image of the
annotation file through the port's `Wrapper` (maximize_positives, as the
reference's accuracy script runs it), the people into
`json_io.CocoJsonSaver`, then `io/coco_eval.evaluate_files` on the
detections file.  Reading the images needs OpenCV.

Usage: python -m openpose_tpu_torch.scripts.coco_val --images val2017/ \\
           --annotations person_keypoints_val2017.json \\
           [--caffemodel body25.caffemodel] [--scale_number 4] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch


def main(argv=None, device=None) -> int:
    """Run the harness on argv (sys.argv when None).  device: where the net
    runs (a keyword for callers and tests; the card when None and no
    --cpu)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True)
    p.add_argument("--annotations", required=True)
    p.add_argument("--caffemodel", default=None)
    p.add_argument("--net_resolution", default="-1x368")
    p.add_argument("--scale_number", type=int, default=1)
    p.add_argument("--scale_gap", type=float, default=0.25)
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--out", default="coco_detections.json")
    p.add_argument("--variants", type=int, default=1,
                   help="CocoJsonSaver bitmask (2 adds the foot stream for "
                        "the foot-AP half of pose_accuracy_coco_val.sh)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")

    import cv2
    from openpose_tpu_torch.io import coco_eval, json_io
    from openpose_tpu_torch.wrapper import PoseConfig, Wrapper

    with open(args.annotations) as f:
        coco = json.load(f)
    images = coco["images"]
    if args.max_images > 0:
        images = images[:args.max_images]

    w, h = args.net_resolution.lower().split("x")
    wrapper = Wrapper(pose=PoseConfig(
        net_resolution=(int(w), int(h)), scale_number=args.scale_number,
        scale_gap=args.scale_gap, maximize_positives=True,
        caffemodel=args.caffemodel), device=device)
    saver = json_io.CocoJsonSaver(args.variants)
    for i, img_info in enumerate(images):
        img = cv2.imread(str(pathlib.Path(args.images)
                             / img_info["file_name"]))
        if img is None:
            continue
        d = wrapper.process(img)
        if d.pose_keypoints is not None and d.pose_keypoints.size:
            saver.record(d.pose_keypoints, d.pose_scores, img_info["id"])
        if i % 50 == 0:
            print(f"{i}/{len(images)}")
    saver.save(args.out)
    metrics = coco_eval.evaluate_files(args.out, args.annotations)
    print(json.dumps(metrics, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
