"""Measured weak scaling of data-parallel inference over N processes.

Counterpart of the repository's `scripts/scaling_bench.py`, with its
report's keys.  N ranks of `PoseInference` over a data mesh
(`parallel/mesh.py`) each feed the same local batch; the world processes
N x local batch an iteration.  Each rank times its own iteration loop;
the world's frames/s divides the global frames by the slowest rank, and

    efficiency(n) = fps_global(n) / (n * fps_global(1))

Each rank takes a card of its own (NCCL); with fewer cards than the
largest world (4, or 2 with `four_host=False`) it raises
`NoCudaDeviceError`.  `--cpu` runs the ranks as gloo processes instead,
each pinned to a core of its own (`sched_setaffinity`) with one torch
thread: the original's emulation of single-device hosts.  Every rank
waits at a barrier before each timed repetition, so repetition k of all
ranks covers the same span.  `--reps` paired (1-rank, 2-rank) launches
run back to back so that both sample the same background load, and the
report gives the median efficiency with its spread, per-rank times and
the load average; on cards each rank also traces 10 calls at once with
the others (`device_busy`: busy share, device and wall ms a call), to
tell a slower card from a slower host.  A 4-rank point follows; with
fewer cores than 4 it is oversubscribed by construction, so the report
also gives it normalised by min(4, cores).
`collectives_inference` is rank 0's census of one 2-rank call
(`parallel/dryrun.py::collective_census`): {} for a data-parallel program.

The default configuration is the original's (MPI_15_4, 64x64, 16 peaks,
float32); `--model BODY_25 --net_hw 368x656 --dtype bfloat16` gives the
card's main-path shape.

Usage:
  python -m openpose_tpu_torch.scripts.scaling_bench [--cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from openpose_tpu_torch.device import NoCudaDeviceError

JOIN_SECONDS = 1800


def run_world(fn, world: int, args: tuple, timeout: float = JOIN_SECONDS):
    """Start `world` spawned processes of fn(rank, *args) and wait for them,
    at most `timeout` seconds: a rank that raises or exits badly raises
    here, one that is still running then is killed, and so are the others,
    and the call raises TimeoutError."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()


def require_cards(ranks: int) -> None:
    """Raises `NoCudaDeviceError` unless there is a card for each of
    `ranks` ranks."""
    cards = torch.cuda.device_count()
    if cards < ranks:
        raise NoCudaDeviceError(
            f"{ranks} ranks run on one CUDA device each and {cards} are "
            "visible; pass --cpu (device_type=\"cpu\") to run them as gloo "
            "ranks on the CPU")


def rank_device(rank: int, world: int, device_type: str) -> torch.device:
    """A rank's device: card `rank` for NCCL ranks (TF32 off, cuDNN's
    algorithm search on, as on the main path; the ranks share the host's
    cores, each with its share of torch threads); for gloo ranks the CPU,
    one core of its own (where the system lets it pin) and one torch
    thread."""
    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        return torch.device("cuda", rank)
    try:
        os.sched_setaffinity(0, {rank % (os.cpu_count() or 1)})
    except (AttributeError, OSError):
        pass
    torch.set_num_threads(1)
    return torch.device("cpu")


def _rank(rank, world, init_file, device_type, config, out_dir):
    """One rank of `run_config`: warm up, count the collectives of one
    call, then time `inner` loops of `iters` calls, each after a barrier,
    and on a card trace 10 calls; writes its result as `rank<r>.json` into
    out_dir."""
    import torch.distributed as dist
    from openpose_tpu_torch.models import zoo
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    from openpose_tpu_torch.parallel.dryrun import collective_census
    from openpose_tpu_torch.parallel.inference import PoseInference
    from openpose_tpu_torch.params import PoseModel
    from openpose_tpu_torch.utils.benchmark import device_busy
    device = rank_device(rank, world, device_type)
    with mesh_lib.process_group(init_file, world, rank, device) as device:
        mesh = mesh_lib.make_mesh(device_type=device.type)   # data only
        model = zoo.load_pose_model(PoseModel[config["model"]], seed=0,
                                    device=device)
        h, w = config["net_hw"]
        inference = PoseInference(
            model, net_hw=(h, w), max_peaks=config["max_peaks"],
            compute_dtype=getattr(torch, config["dtype"]), mesh=mesh)
        local = torch.from_numpy(np.random.RandomState(rank).randint(
            0, 255, (config["batch"], h, w, 3)).astype(np.uint8))

        def call():
            return inference.fetch(*inference(local))
        for _ in range(3):
            call()
        _, census = collective_census(call)
        dts = []
        for _ in range(config["inner"]):
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(config["iters"]):
                call()
            dts.append(time.perf_counter() - t0)
        trace = None
        if device.type == "cuda":
            dist.barrier()
            busy = device_busy(call, 10)
            trace = {k: busy[k] for k in ("busy_share", "wall_ms_per_call",
                                          "device_ms_per_call")}
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps({
        "proc": rank, "dts": dts,
        "local_frames": config["batch"] * config["iters"],
        "collectives": census, "trace": trace}))


def run_config(n_proc: int, config: dict, device_type: str,
               workdir: pathlib.Path, timeout: float = JOIN_SECONDS) -> dict:
    """One launch of n_proc ranks, `config["inner"]` timed repetitions
    each.  Repetition i of every rank, started together at a barrier, is
    paired into one global frames/s."""
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix=f"world{n_proc}_",
                                            dir=workdir))
    run_world(_rank, n_proc, (n_proc, str(out_dir / "init"), device_type,
                              config, str(out_dir)), timeout)
    results = [json.loads((out_dir / f"rank{r}.json").read_text())
               for r in range(n_proc)]
    global_frames = sum(r["local_frames"] for r in results)
    rep_fps = [global_frames / max(r["dts"][k] for r in results)
               for k in range(len(results[0]["dts"]))]
    return {"n_hosts": n_proc,
            "global_fps_best": max(rep_fps),
            "global_fps_median": statistics.median(rep_fps),
            "rep_fps": [round(f, 2) for f in rep_fps],
            "per_proc_dts": {r["proc"]: [round(d, 3) for d in r["dts"]]
                             for r in results},
            "per_proc_trace": {r["proc"]: r["trace"] for r in results},
            "collectives": results[0]["collectives"]}


def measure(batch: int = 8, iters: int = 10, reps: int = 5, inner: int = 2,
            workdir=None, four_host: bool = True, model: str = "MPI_15_4",
            net_hw=(64, 64), dtype: str = "float32", max_peaks: int = 16,
            device_type: str = "cuda",
            timeout: float = JOIN_SECONDS) -> dict:
    """The scaling report (the original's keys); workdir: where the ranks
    meet and write (a temporary folder when None); device_type: "cuda" (a
    card a rank; raises `NoCudaDeviceError` with fewer cards than ranks)
    or "cpu" (gloo ranks, a core each); timeout: the most seconds one
    launch may take."""
    if device_type == "cuda":
        require_cards(4 if four_host else 2)
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="scaling_") as tmp:
            return measure(batch, iters, reps, inner, pathlib.Path(tmp),
                           four_host, model, net_hw, dtype, max_peaks,
                           device_type, timeout)
    workdir = pathlib.Path(workdir)
    config = {"model": model, "net_hw": tuple(net_hw), "dtype": dtype,
              "max_peaks": max_peaks, "batch": batch, "iters": iters,
              "inner": inner}
    n_cores = os.cpu_count() or 1
    units = torch.cuda.device_count() if device_type == "cuda" else n_cores
    load_start = os.getloadavg()
    pair_effs = []
    pair_detail = []
    for rep in range(reps):
        one = run_config(1, config, device_type, workdir, timeout)
        two = run_config(2, config, device_type, workdir, timeout)
        eff = two["global_fps_median"] / (2 * one["global_fps_median"])
        eff_best = two["global_fps_best"] / (2 * one["global_fps_best"])
        pair_effs.append(eff)
        pair_detail.append({"pair": rep, "efficiency_median": round(eff, 4),
                            "efficiency_best": round(eff_best, 4),
                            "one_host": one, "two_hosts": two})
        print(f"pair {rep}: eff(median)={eff:.4f} eff(best)={eff_best:.4f}",
              file=sys.stderr, flush=True)
    one_fps = statistics.median(
        p["one_host"]["global_fps_median"] for p in pair_detail)
    if four_host:
        four = run_config(4, config, device_type, workdir, timeout)
        eff4_raw = four["global_fps_median"] / (4 * one_fps)
        eff4_norm = four["global_fps_median"] / (min(4, units) * one_fps)
    else:
        four, eff4_raw, eff4_norm = None, 0.0, 0.0
    load_end = os.getloadavg()
    h, w = net_hw
    unit = "card (NCCL)" if device_type == "cuda" else "CPU core (gloo)"
    return {
        "config": f"{model} {h}x{w} {dtype}, {max_peaks} peaks, 1 {unit}"
                  f"/rank, local batch {batch}, {iters} iters x {inner} "
                  f"reps, {reps} paired launches",
        "n_physical_cores": n_cores,
        "efficiency_2_hosts_median": round(statistics.median(pair_effs), 4),
        "efficiency_2_hosts_min": round(min(pair_effs), 4),
        "efficiency_2_hosts_max": round(max(pair_effs), 4),
        "pairs": pair_detail,
        "four_hosts": four,
        "efficiency_4_hosts_raw": round(eff4_raw, 4),
        "efficiency_4_hosts_core_normalized": round(eff4_norm, 4),
        "four_host_note": (
            f"4 ranks share {units} {unit.split(' (')[0]}s "
            f"({max(1, 4 // max(units, 1))}x oversubscribed): the raw "
            f"efficiency is bounded near {min(4, units) / 4:.2f} by the "
            "machine; the normalized number isolates the cost of the "
            "processes' coordination"),
        "loadavg_start": load_start, "loadavg_end": load_end,
        "collectives_inference": pair_detail[0]["two_hosts"]["collectives"],
    }


def main(argv=None) -> dict:
    """Runs `measure` with the flags, prints the report and writes it to
    `--out` (none with an empty `--out`); returns it."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--inner", type=int, default=2)
    ap.add_argument("--model", default="MPI_15_4")
    ap.add_argument("--net_hw", default="64x64", help="HxW")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--max_peaks", type=int, default=16)
    ap.add_argument("--out", default="SCALING_torch.json")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU, a core each")
    args = ap.parse_args(argv)
    h, w = (int(v) for v in args.net_hw.split("x"))
    report = measure(args.batch, args.iters, args.reps, args.inner,
                     model=args.model, net_hw=(h, w), dtype=args.dtype,
                     max_peaks=args.max_peaks,
                     device_type="cpu" if args.cpu else "cuda")
    print(json.dumps(report, indent=2))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
