"""Per-stage CNN timing and share of peak (BODY_25, 368x656 by default).

Counterpart of the repository's `scripts/profile_net.py`: times cumulative
prefixes of the layer graph, cut at the architectural points of `CUTS`
(the VGG trunk's pools, its head, each CPM stage's last convolution) and
at the last layer, with the chained method (`utils/benchmark.chain_ms`),
in bf16; differences them into per-stage ms a frame; and reports each
stage's GFLOP a frame (`graph.count_flops`), its TFLOP/s and its share of
the card's bf16 datasheet peak (`n/a` where the table has none, as on the
CPU).  A prefix is the spec's first layers up to the cut, by layer index,
its output the cut layer's top: BODY_25's stages concatenate earlier tops,
and every one of them lies before the cut.

Usage:
  python -m openpose_tpu_torch.scripts.profile_net [--batch 8]
      [--net_resolution 656x368]
Runs on the card; `--cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from openpose_tpu_torch import device as device_rule
from openpose_tpu_torch.utils import benchmark

CUTS = ["pool1_stage1", "pool2_stage1", "pool3_stage1", "conv4_2",
        "prelu4_2", "Mconv7_stage0_L2", "Mconv7_stage1_L2",
        "Mconv7_stage0_L1"]


def cut_names(spec) -> list:
    """The cuts of `CUTS` that the spec has, then its last layer."""
    names = [layer.name for layer in spec.layers]
    return [c for c in CUTS if c in names] + [spec.layers[-1].name]


def prefix_net(model, upto: str):
    """A `PoseNet` of the spec's layers up to and including `upto`, its
    output that layer's first top, over the model's own weights."""
    from openpose_tpu_torch.models import graph
    spec = model.spec
    idx = [layer.name for layer in spec.layers].index(upto) + 1
    sub = dataclasses.replace(spec, output=spec.layers[idx - 1].tops[0],
                              layers=spec.layers[:idx])
    return graph.PoseNet(sub, model.net.params())


def main(argv=None, device=None, chain=(2, 22, 3)) -> list:
    """Returns one row a cut: {"cut", "ms_per_frame", "gflop",
    "tflop_per_s", "share_of_peak" (None without a datasheet peak),
    "cumulative_ms_per_frame"}.  chain: `chain_ms`'s (n_lo, n_hi, reps)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--net_resolution", default="656x368")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    device = torch.device("cpu") if args.cpu else device_rule.resolve(device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    from openpose_tpu_torch.models import graph, zoo
    from openpose_tpu_torch.ops import resize
    from openpose_tpu_torch.params import PoseModel

    w, h = (int(v) for v in args.net_resolution.split("x"))
    model = zoo.load_pose_model(PoseModel.BODY_25, seed=0, device=device)
    spec = model.spec
    names = [layer.name for layer in spec.layers]
    flops = graph.count_flops(spec, (h, w))
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 255, (args.batch, h, w, 3)).astype(np.float32)).to(device)

    def prefix_step(net):
        def step(c):
            with torch.inference_mode():
                return benchmark.fold(c, net(
                    resize.normalize_vgg(images + c * 1e-12), torch.bfloat16))
        return step

    kind = benchmark.device_name(device)
    peak = benchmark.bf16_peak_tflops(kind)
    print(f"# device {kind}, bf16 peak {peak or 'n/a'} TFLOP/s, "
          f"batch {args.batch}", flush=True)
    n_lo, n_hi, reps = chain
    prev_ms, prev_fl = 0.0, 0
    rows = []
    for cut in cut_names(spec):
        t0 = time.time()
        ms = benchmark.chain_ms(prefix_step(prefix_net(model, cut)), n_lo,
                                n_hi, reps, device)
        fl = sum(flops[name] for name in names[:names.index(cut) + 1])
        d_ms = (ms - prev_ms) / args.batch
        d_fl = (fl - prev_fl) / 1e9
        tf = d_fl / d_ms if d_ms > 1e-6 else float("inf")
        share = tf / peak if peak else None
        rows.append({"cut": cut, "ms_per_frame": d_ms, "gflop": d_fl,
                     "tflop_per_s": tf, "share_of_peak": share,
                     "cumulative_ms_per_frame": ms / args.batch})
        shown = f"{share:5.1%}" if share is not None else "n/a"
        print(f"  ..{cut:<20} stage {d_ms:6.3f} ms/frame  {d_fl:6.1f} GFLOP "
              f"-> {tf:6.1f} TFLOP/s ({shown} of peak)  "
              f"[cumulative {ms / args.batch:.3f} ms; wall "
              f"{time.time() - t0:.0f}s]", flush=True)
        prev_ms, prev_fl = ms, fl
    return rows


if __name__ == "__main__":
    main()
