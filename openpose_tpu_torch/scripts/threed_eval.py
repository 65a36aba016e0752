"""3-D accuracy benchmark on the port: synthetic rig -> triangulation + BA
-> RMSE.

Counterpart of the repository's `scripts/threed_eval.py`, over
`openpose_tpu_torch/accuracy3d.py` (its docstring has the method);
reference gates: src/openpose/3d/poseTriangulation.cpp:98-120
(reprojection threshold 25*sqrt(area/1310720) px).  Prints the table and
writes the JSON to `--out`, by default `BENCH3D_torch.json` in the working
directory: the JAX script's `BENCH3D.json` stays the JAX package's record.

Usage: python -m openpose_tpu_torch.scripts.threed_eval [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from openpose_tpu_torch import device as device_rule


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--people", type=int, default=8)
    ap.add_argument("--cams", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--out", default="BENCH3D_torch.json")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu \
        else device_rule.default_device()
    from openpose_tpu_torch import accuracy3d

    sweep = accuracy3d.noise_sweep(n_people=args.people, n_cams=args.cams,
                                   seed=args.seed, device=device)
    print(f"# triangulation (DLT + GN Huber), {args.cams}-camera rig")
    for r in sweep:
        print(f"  noise={r['pixel_noise']:<4} px  RMSE={r['rmse_mm']:7.2f} mm"
              f"  reproj={r['reprojection_px']:5.2f} px"
              f"  (gate {r['reference_gate_px']:.1f} px)"
              f"  valid={r['valid_fraction']:.2f}")
    ba = accuracy3d.bundle_eval(n_people=args.people, n_cams=args.cams,
                                seed=args.seed, device=device)
    print("# bundle adjustment (perturbed cameras)")
    print(f"  in:  rot {ba['cam_rot_err_deg_in']} deg, "
          f"t {ba['cam_t_err_mm_in']:.0f} mm, pixel noise "
          f"{ba['pixel_noise']} px")
    print(f"  out: rot {ba['cam_rot_err_deg_out']:.3f} deg, "
          f"t {ba['cam_t_err_mm_out']:.1f} mm; point RMSE "
          f"{ba['rmse_mm_before_ba']:.1f} -> {ba['rmse_mm_after_ba']:.1f} mm")
    result = {"triangulation_sweep": sweep, "bundle_adjustment": ba}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
