"""Tutorial 09: keypoints from externally supplied heatmaps (net bypass).

Mirrors the reference's examples/tutorial_api_cpp/09_keypoints_from_heatmaps
(Datum::poseNetOutput injection, include/openpose/core/datum.hpp:212-217):
run ONLY the post-processing (resize-merge -> NMS -> PAF scoring -> greedy
assembly) on a heatmap tensor you provide — e.g. produced by another model,
loaded from disk, or synthesized.  At the default 127-peak budget the PAF
scoring is one launch of the fused kernel.

    python -m openpose_tpu_torch.examples.09_keypoints_from_heatmaps [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from openpose_tpu_torch import train
from openpose_tpu_torch.models import zoo
from openpose_tpu_torch.ops import paf
from openpose_tpu_torch.params import PoseModel
from openpose_tpu_torch.pose.extractor import PoseExtractor

FRAME_HW = (368, 656)
INJECTED_X = (180.0, 450.0)


def two_person_net_output(info, device=None):
    """A synthesized 2-person net output [h/8, w/8, C] at FRAME_HW
    (normally you would load one), rendered on `device`."""
    h, w = FRAME_HW
    rng = np.random.RandomState(0)
    kp = np.zeros((1, 2, info.num_parts, 3), np.float32)
    for p, cx in enumerate(INJECTED_X):
        kp[0, p, :, 0] = cx + rng.uniform(-35, 35, info.num_parts)
        kp[0, p, :, 1] = 180 + rng.uniform(-70, 70, info.num_parts)
        kp[0, p, :, 2] = 1.0
    pairs, map_idx = (torch.from_numpy(t).to(device)
                      for t in paf.pair_tables(info))
    return train.make_targets(
        torch.from_numpy(kp).to(device), pairs, map_idx, (h, w),
        info.num_parts, info.heatmap_channels)[0].cpu().numpy()


def keypoints_from_heatmaps(device=None, model=None):
    """The people of the synthesized net output: (the prediction, each
    person's mean x in ascending order).  model: the BODY_25 model whose
    post-processing runs (its weights are not used)."""
    model = model or zoo.load_pose_model(PoseModel.BODY_25, device=device)
    h, w = FRAME_HW
    net_output = two_person_net_output(model.info, device)
    extractor = PoseExtractor(model, compute_dtype=torch.float32,
                              device=device)
    image = np.zeros((h, w, 3), np.float32)       # only sets the geometry
    pred = extractor.forward(image, net_resolution=(w, h),
                             net_output=net_output)
    print(f"people found: {pred.keypoints.shape[0]}")
    means = sorted(
        float(pred.keypoints[p, pred.keypoints[p, :, 2] > 0, 0].mean())
        for p in range(pred.keypoints.shape[0]))
    for mean_x, cx in zip(means, INJECTED_X):
        print(f"  detected person at mean x = {mean_x:.1f} "
              f"(injected at {cx:.0f})")
    return pred, means


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    keypoints_from_heatmaps(
        device="cpu" if ap.parse_args().cpu else None)
