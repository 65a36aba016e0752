"""The control: the reference, computed one precision below what the
configuration states, put in the program's place and judged by the same
comparison as a run.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 [--cpu]

The CNNs (bf16 in the configuration) run in fp8, the heatmap path (float32
with TF32 off) in TF32.  For each seed it makes the cell's inputs as a run
does, answers every batch of the pool with the control, compares the CNN
outputs of every batch of the pool (each distinct output a run's sample
can hold), and prints one JSON line: each
number beside its limit, and `correct` as a run would decide it, which has
to be false.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from perfbench import cells, check, inputs, run
from perfbench.reference import cnn


def control_numbers(workload: str, seed: int, device: torch.device,
                    cpu: bool) -> dict:
    cell, cfg, traffic = cells.load_cell(workload)
    cfg, traffic = run.sized(cfg, traffic, cpu)
    rows = slice(0, traffic["batch"] // cell["chips"])
    params = {"body": inputs.make_params(cfg["spec"], seed, device)}
    for key in ("face", "hand"):
        if key in cfg:
            params[key] = inputs.make_params(cfg[key]["spec"], seed, device)
    pool = inputs.Pool(cfg, traffic, seed, rows, device)
    ref = check.Reference(cfg, pool, params, device)
    ctl = check.Reference(cfg, pool, params, device, control=True)
    answers = [(b, ctl.as_answers(b)) for b in range(len(pool))]
    numbers = check.judge(ref, answers, rows.stop - rows.start)
    spec = cnn.load_spec(cfg["spec"])
    samples = [(b, cnn.forward(spec, params["body"],
                               pool.frames[b].to(device), "fp8"))
               for b in range(len(pool))]
    numbers["cnn_rel_err"] = check.cnn_rel_err(
        cfg["spec"], params["body"], samples, lambda b: pool.frames[b])
    people = [len(a[0]) for _, frames in answers for a in frames]
    limits = cfg["limits"]
    split = {}
    if "face" in cfg:
        # the face and hand nets in fp8 over the float32 body decode: the
        # top-down number's reading when the body's people are the same
        nets = check.Reference(cfg, pool, params, device, control=True,
                                   tf32=False)
        split["topdown_gap_fp8_nets_alone"] = check.judge(
            ref, [(b, nets.as_answers(b)) for b in range(len(pool))],
            rows.stop - rows.start)["topdown_gap"]
    return {"workload": workload, "seed": seed,
            "correct": all(numbers[k] <= limits[k] for k in numbers),
            "checks": {k: {"value": numbers[k], "limit": limits[k]}
                       for k in sorted(numbers)},
            "people_per_frame": float(np.mean(people)), **split}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_numbers(args.workload, seed, device,
                                         args.cpu)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
