"""Per-stage device timing of the main path (the reference's
`scripts/tests/speed_test.sh`).

Counterpart of the repository's `scripts/speed_test.py`: BODY_25 with seeded
random weights (seed 0) on one random image at 368x656, stage by stage: the
net, the Catmull-Rom resize of the 25 part channels to the net's input
size, NMS (threshold 0.05, 127 peaks) and the PAF pair scores, each timed
over `--iters` calls after one (between CUDA events on the card).  At the
127-peak budget the PAF stage is one launch of the fused kernel.  Prints
one `name: X ms` line a stage.

Usage:
  python -m openpose_tpu_torch.scripts.speed_test
  python -m openpose_tpu_torch.scripts.speed_test --batch 8 --dtype float32
Runs on the card; `--cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.utils import benchmark


def _launches():
    from openpose_tpu_torch.ops import paf_cuda
    return {"paf_scores_fused": paf_cuda.paf_scores_fused.launches,
            "sample_bicubic_scales": paf_cuda.sample_bicubic_scales.launches}


def main(argv=None, device=None) -> dict:
    """Returns {"device", "ms": {stage: ms}, "launches": {stage: the
    hand kernels' launches of the stage's first call}, "outputs": {"image",
    "net", "merged", "peaks", "scores"}} (the stages' tensors on the
    device)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--net_resolution", default="656x368",
                    help="WxH (reference flag convention)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the net's compute type; the heatmap path is "
                         "float32 either way")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    device = torch.device("cpu") if args.cpu else device_rule.resolve(device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    from openpose_tpu_torch.models import zoo
    from openpose_tpu_torch.ops import nms, paf, resize
    from openpose_tpu_torch.params import PoseModel

    model = zoo.load_pose_model(PoseModel.BODY_25, seed=0, device=device)
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf.pair_tables(model.info))
    num_parts = model.info.num_parts
    net_w, net_h = (int(v) for v in args.net_resolution.split("x"))
    dtype = getattr(torch, args.dtype)
    image = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 255, (args.batch, net_h, net_w, 3)).astype(np.float32)).to(device)

    stages = (
        (f"net forward ({args.dtype})", "net",
         lambda: model.forward(resize.normalize_vgg(image), dtype)),
        ("resize 8x (parts)", "merged",
         lambda: resize.resize_bicubic(outputs["net"][..., :num_parts],
                                       (net_h, net_w))),
        ("nms", "peaks", lambda: nms.nms(outputs["merged"], 0.05, 127)),
        ("paf scores (multiscale)", "scores",
         lambda: paf.paf_scores_multiscale(
             (outputs["net"],), (1.0,), (net_h, net_w), outputs["peaks"],
             pairs, map_idx, 0.05, 0.95, 0.05)))
    outputs = {"image": image}
    ms, launches = {}, {}
    with torch.inference_mode():
        for name, key, fn in stages:
            before = _launches()
            outputs[key] = fn()
            launches[name] = {k: v - before[k]
                              for k, v in _launches().items()}
            ms[name] = benchmark.timed(fn, 0, args.iters, device)
            print(f"{name}: {ms[name]:.2f} ms", flush=True)
    return {"device": benchmark.device_name(device), "ms": ms,
            "launches": launches, "outputs": outputs}


if __name__ == "__main__":
    main()
