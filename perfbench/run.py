"""Run one cell of the benchmark of `openpose_tpu_torch` once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--cpu]

Set-up makes the weights and the inputs from --seed, builds the program,
and runs every batch of the cell's pool once (every shape the window
uses); then the window measures for --seconds (with --trace 1, the first
`TRACE_SECONDS` of it under torch.profiler).  After the window the
program's state is freed and the reference judges what the window
produced (`check.py`).  The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error).

A cell on several cards runs one process a card, joined in a NCCL group
through a file under the temporary directory; each rank serves its rows
of the global batch through the program's mesh, and the parent process
merges what they measured.  --cpu rehearses a cell on the CPU at the tiny
sizes of the files' `cpu_rehearsal` entries (gloo ranks for several
cards); without it a run needs as many cards as the cell asks for.
"""

from __future__ import annotations

import time

START_WALL = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "openpose_tpu")
TRACE_SECONDS = 3.0
CNN_SAMPLE_EVERY = 32  # the check compares the CNN outputs of 1 step in 32
RANK_TIMEOUT_S = 1500


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the port, `openpose_tpu_torch`, is another name)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _guard(when: str) -> None:
    found = forbidden_modules()
    if found:
        print(f"perfbench: {when}, loaded: {', '.join(found)}; the "
              "benchmark runs the port alone", file=sys.stderr)
        sys.exit(3)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at the tiny sizes")
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    return args


def sized(cfg: dict, traffic: dict, cpu: bool):
    """The configuration and traffic as run: on the CPU with their
    `cpu_rehearsal` entries laid over them."""
    if cpu:
        cfg = {**cfg, **cfg.get("cpu_rehearsal", {})}
        traffic = {**traffic, **traffic.get("cpu_rehearsal", {})}
    return cfg, traffic


def run_rank(args: argparse.Namespace, rank: int, world: int,
             init_file: Optional[str]) -> dict:
    """One rank's set-up, window and check; a plain dict of what it
    measured."""
    import torch
    from perfbench import cells
    from openpose_tpu_torch.parallel import mesh as mesh_lib
    cell, cfg, traffic = cells.load_cell(args.workload)
    cfg, traffic = sized(cfg, traffic, args.cpu)
    # on a card the host's threads are torch's default, as the program's
    # CLI leaves them (`cli._rank_main` sets a count for CPU ranks only);
    # a CPU rehearsal keeps to two, since it shares its host
    if args.cpu:
        torch.set_num_threads(2)
    device = torch.device("cpu") if args.cpu else torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1:
        with mesh_lib.process_group(init_file, world, rank, device):
            mesh = mesh_lib.make_mesh(device_type=device.type)
            return _serve(args, cfg, traffic, device, mesh)
    return _serve(args, cfg, traffic, device, None)


def _serve(args, cfg: dict, traffic: dict, device, mesh) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from perfbench import check, inputs, loops, trace
    from openpose_tpu_torch.parallel import mesh as mesh_lib

    batch = traffic["batch"]
    rows = mesh_lib.local_rows(mesh, batch)
    n_rows = rows.stop - rows.start
    log(f"imports and the device, {time.time() - START_WALL:.2f} s; "
        f"{torch.get_num_threads()} host threads, "
        f"{len(os.sched_getaffinity(0))} cores")
    params = {"body": inputs.make_params(cfg["spec"], args.seed, device)}
    for key in ("face", "hand"):
        if key in cfg:
            params[key] = inputs.make_params(cfg[key]["spec"], args.seed,
                                             device)
    pool = inputs.Pool(cfg, traffic, args.seed, rows, device)
    log(f"weights and inputs, {time.time() - START_WALL:.2f} s")
    prog = loops.Program(cfg, params, device, mesh)
    rng = np.random.default_rng(inputs.stream(args.seed, "order"))
    order = [int(b) for b in rng.permutation(len(pool))]
    loop = loops.LOOPS[traffic["loop"]]

    # warm-up: every batch of the pool once, every shape the window uses
    loop(prog, pool, order, lambda i, _: i >= len(order), trace.Spans(),
         loops.Record(loops.Sample(0, rng)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if mesh is not None:
        dist.barrier()
    # set-up's garbage is collected once; the window runs the collector
    # as the program does
    gc.collect()
    window_start_wall = time.time()

    log(f"set-up done in {window_start_wall - START_WALL:.2f} s")
    # the window; with --trace 1 a traced one of TRACE_SECONDS follows
    # (the profiler's own cost slows the host, so what the host clock
    # reads -- mfu, assembly -- comes from the untraced one)
    spans = trace.Spans()
    rng_sample = np.random.default_rng(inputs.stream(args.seed, "sample"))
    rec = loops.Record(loops.Sample(CNN_SAMPLE_EVERY, rng_sample))
    loop(prog, pool, order, lambda _, t: t >= args.seconds, spans, rec)
    traced, tspans = None, trace.Spans(profiling=True)
    if args.trace:
        traced = loops.Record(loops.Sample(0, rng_sample))
        fd, trace_path = tempfile.mkstemp(suffix=".json",
                                          prefix="perfbench_")
        os.close(fd)
        try:
            with trace.Profiled(trace_path) as prof:
                with torch.profiler.record_function(trace.WINDOW):
                    loop(prog, pool, order,
                         lambda _, t: t >= TRACE_SECONDS, tspans, traced)
        finally:
            os.unlink(trace_path)
    if rec.latencies:
        deciles = np.quantile(rec.latencies, np.linspace(0.1, 0.9, 9)) * 1e3
        log("frame latency deciles, ms: "
            + " ".join(f"{d:.2f}" for d in deciles))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    # the check, with the program's state freed
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.Reference(cfg, pool, params, device)
    answers = rec.answers + (traced.answers if traced else [])
    numbers = check.judge(ref, answers, n_rows)
    numbers["cnn_rel_err"] = check.cnn_rel_err(
        cfg["spec"], params["body"], rec.cnn.items,
        lambda b: pool.frames[b])
    log(f"check done, {time.time() - START_WALL:.2f} s from start")

    def people(r):
        return sum(int((pool.people[b][i, :, 0, 2] > 0).sum())
                   for b, answer in r.answers for i in range(len(answer)))
    out = {"frames": rec.frames, "window_s": rec.t1 - rec.t0,
           "attempted": rec.frames + (traced.frames if traced else 0),
           "window_start_wall": window_start_wall,
           "latencies": rec.latencies, "rows": n_rows, "people": people(rec),
           "span_seconds": dict(spans.seconds),
           "span_calls": dict(spans.calls), "trace": None,
           "memory_peak_bytes": int(peak), "numbers": numbers,
           "limits": {k: cfg["limits"][k] for k in numbers},
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "forbidden": forbidden_modules()}
    if traced:
        out["trace"] = prof.summary
        out["traced"] = {"frames": traced.frames, "rows": n_rows,
                         "span_calls": dict(tspans.calls)}
    return out


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def _rank_entry(args, rank, world, init_file, queue) -> None:
    try:
        queue.put((rank, run_rank(args, rank, world, init_file)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def run_ranks(args, world: int) -> List[dict]:
    """One process a rank; their records in rank order."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="perfbench_group_")
    init_file = os.path.join(workdir, "rendezvous")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(args, r, world, init_file, queue))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        records = {}
        deadline = time.time() + RANK_TIMEOUT_S
        while len(records) < world:
            rank, rec = queue.get(timeout=max(1.0, deadline - time.time()))
            if "error" in rec:
                raise RuntimeError(f"rank {rank} failed:\n{rec['error']}")
            records[rank] = rec
        return [records[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)


def result(args, cell: dict, cfg: dict, traffic: dict,
           ranks: List[dict]) -> dict:
    from perfbench import cells, trace
    run = Run(cell, cfg, traffic, ranks, START_WALL)
    names = cell["per_layer"] if args.trace else cell["end_to_end"]
    metrics = {}
    for name in names:
        reader = cells.load_metric(name)
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    numbers, limits = {}, {}
    for r in ranks:
        for k, v in r["numbers"].items():
            if v is not None:
                numbers[k] = max(numbers.get(k, v), v)
            limits[k] = r["limits"][k]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in sorted(limits)}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    attempted = sum(r["attempted"] for r in ranks)
    failed = 0 if correct else attempted
    device = {"platform": "cpu" if args.cpu else "gpu",
              "kind": ranks[0]["kind"], "count": len(ranks),
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in ranks)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    summaries = [r["trace"] for r in ranks if r["trace"]]
    if args.trace and summaries:
        device["busy_s"] = sum(s["busy_s"] for s in summaries) / len(
            summaries)
        device["window_s"] = sum(s["window_s"] for s in summaries) / len(
            summaries)
        out["breakdown"] = {
            "device_ops": trace.mean_over_ranks(summaries, "top_ops"),
            "idle_gaps": trace.mean_over_ranks(summaries, "idle_gaps")}
    out["checks"] = checks
    return out


class Run:
    """What the metric readers see: the cell's files and every rank's
    record."""

    def __init__(self, cell, cfg, traffic, ranks, start_wall):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.ranks = ranks
        self.start_wall = start_wall

    def traced(self) -> List[dict]:
        """The ranks' trace summaries; empty where none has device ops."""
        return [r["trace"] for r in self.ranks
                if r["trace"] and r["trace"]["device_ops"]]


def main(argv=None) -> int:
    args = parse(argv)
    _guard("at start")
    import torch
    log(f"torch imported, {time.time() - START_WALL:.2f} s")
    from perfbench import cells
    cell, cfg, traffic = cells.load_cell(args.workload)
    cfg, traffic = sized(cfg, traffic, args.cpu)
    world = cell["chips"]
    if not args.cpu:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            print(f"perfbench: {args.workload} needs {world} card(s), "
                  f"found {have}", file=sys.stderr)
            return 2
    if world == 1:
        ranks = [run_rank(args, 0, 1, None)]
    else:
        ranks = run_ranks(args, world)
    bad = sorted({m for r in ranks for m in r["forbidden"]}
                 | set(forbidden_modules()))
    if bad:
        print(f"perfbench: after the window, loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    out = result(args, cell, cfg, traffic, ranks)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
