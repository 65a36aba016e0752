"""The arithmetic of the metric readers (`metrics/<name>.py`), from the
ranks' records (`run.Run`).  Each returns None where a run has nothing to
read (no device trace, no peak for the device, no span), and the harness
then leaves the metric out of the line."""

from __future__ import annotations

import statistics
from typing import Optional

from perfbench import flops


def _mean(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def setup_s(run) -> float:
    """From the process's start to the last rank's window start."""
    return max(r["window_start_wall"] for r in run.ranks) - run.start_wall


def frames_per_s(run) -> float:
    """Frames answered on the host over each rank's window, summed."""
    return sum(r["frames"] / r["window_s"] for r in run.ranks)


def latency_ms(run, q: int) -> Optional[float]:
    """The q-th percentile (1..99) of every frame's latency, in ms."""
    lat = [x for r in run.ranks for x in r["latencies"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100)[q - 1] * 1e3


def _peak(run) -> Optional[float]:
    return flops.bf16_peak(run.ranks[0]["kind"])


def cnn_roofline(run) -> Optional[float]:
    """The body CNN's FLOPs over the device time of the operations
    launched in the `net_outputs` span of the traced window, against the
    bf16 peak, in %."""
    peak = _peak(run)
    if peak is None:
        return None
    per_frame = flops.net_flops(run.cfg["spec"], tuple(run.cfg["net_hw"]))
    shares = []
    for r in run.ranks:
        s = r["trace"]
        if not s or not s["span_device_s"].get("net_outputs"):
            continue
        work = per_frame * r["traced"]["span_calls"]["net_outputs"] \
            * r["rows"]
        shares.append(100.0 * work / peak / s["span_device_s"]["net_outputs"])
    return _mean(shares)


def span_device_ms(run, span: str) -> Optional[float]:
    """Device ms a frame of the operations launched in `span`."""
    out = []
    for r in run.ranks:
        s = r["trace"]
        calls = r["traced"]["span_calls"].get(span) if s else None
        if calls and s["span_device_s"].get(span):
            out.append(1e3 * s["span_device_s"][span] / (calls * r["rows"]))
    return _mean(out)


def host_ms_per_frame(run, span: str) -> Optional[float]:
    """Host ms a frame inside `span`, in the untraced window."""
    out = [1e3 * r["span_seconds"][span] / r["frames"]
           for r in run.ranks if r["frames"] and span in r["span_seconds"]]
    return _mean(out)


def launches_per_frame(run) -> Optional[float]:
    out = [r["trace"]["device_ops"] / r["traced"]["frames"]
           for r in run.ranks
           if r["trace"] and r["trace"]["device_ops"]
           and r["traced"]["frames"]]
    return _mean(out)


def useful_flops(run, r) -> int:
    """What the answered frames' people need: the body CNN a frame, and,
    for a whole-body configuration, a face and two hands a person present
    (not the padded crops)."""
    cfg = run.cfg
    total = flops.net_flops(cfg["spec"], tuple(cfg["net_hw"])) * r["frames"]
    if "face" in cfg:
        side = cfg["face"]["net_size"], cfg["hand"]["net_size"]
        total += r["people"] * (
            flops.net_flops(cfg["face"]["spec"], (side[0], side[0]))
            + 2 * flops.net_flops(cfg["hand"]["spec"], (side[1], side[1])))
    return total


def mfu(run) -> Optional[float]:
    """Useful FLOPs over each rank's untraced window against its bf16
    peak, in %, the ranks' mean."""
    peak = _peak(run)
    if peak is None or not run.traced():
        return None
    return _mean(100.0 * useful_flops(run, r) / r["window_s"] / peak
                 for r in run.ranks)


def device_idle_share(run) -> Optional[float]:
    """The share of the traced window with no device operation, in %."""
    traced = run.traced()
    return _mean(100.0 * (1.0 - s["busy_s"] / s["window_s"])
                 for s in traced) if traced else None


def rank_spread(run) -> Optional[float]:
    """(max - min) / mean of the ranks' frames a second, in %."""
    if len(run.ranks) < 2:
        return None
    rates = [r["frames"] / r["window_s"] for r in run.ranks]
    return 100.0 * (max(rates) - min(rates)) / (sum(rates) / len(rates))
