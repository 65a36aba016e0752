"""Device timing helpers and the card's datasheet rates.

Counterpart of `openpose_tpu/utils/benchmark.py` (`bf16_peak_tflops`,
`fold`, `chain_ms`), and the one home of the port's timing code: `timed`
(CUDA events), `host_ms`, `device_busy` (torch.profiler) and
`roofline_ms` (a kernel's least time on the card) are used by
`chip_smoke.py`, the trainer and the timing scripts alike.

`chain_ms` keeps the original's method: n data-dependent applications of
a step, one scalar read back at the end, and the difference of two chain
lengths, so that the constant cost of starting and ending a run cancels.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Union

import torch

from openpose_tpu_torch import device as device_rule


@dataclasses.dataclass(frozen=True)
class Rates:
    """A card's dense datasheet rates."""
    bf16_tflops: float
    f32_tflops: float
    hbm_bytes_per_s: float


# NVIDIA H100 SXM5 datasheet, dense (no sparsity), at its 700 W limit: bf16
# on the tensor cores, float32 outside them (no TF32), HBM3.
H100_SXM = Rates(bf16_tflops=989.4, f32_tflops=67.0, hbm_bytes_per_s=3.35e12)

# (substrings that must all be in the lower-cased device name, its rates).
# "NVIDIA H100 80GB HBM3" is the SXM card; the PCIe and NVL parts have other
# clocks and memory and are not listed.
DATASHEET = ((("h100", "hbm3"), H100_SXM),)


def device_name(device: Union[str, torch.device, None] = None) -> str:
    """`torch.cuda.get_device_name` of a card ("cpu" for a CPU device; the
    current card when None, "cpu" where there is none)."""
    if device is None:
        return torch.cuda.get_device_name() if torch.cuda.is_available() \
            else "cpu"
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def card_rates(device_kind: Optional[str] = None) -> Optional[Rates]:
    """The datasheet rates of a device by its name (the current card's when
    None); None for a name the table does not hold, and for the CPU."""
    kind = (device_name() if device_kind is None else device_kind).lower()
    for keys, rates in DATASHEET:
        if all(key in kind for key in keys):
            return rates
    return None


def bf16_peak_tflops(device_kind: Optional[str] = None) -> float:
    """Dense bf16 peak (TFLOP/s) of a device by name; 0.0 when unknown
    (the CPU included)."""
    return peak_tflops(torch.bfloat16, device_kind)


def peak_tflops(dtype: torch.dtype, device_kind: Optional[str] = None
                ) -> float:
    """Dense peak (TFLOP/s) for operands of `dtype` (bfloat16 or float32);
    0.0 for a device the table does not hold."""
    rates = card_rates(device_kind)
    if rates is None:
        return 0.0
    if dtype == torch.bfloat16:
        return rates.bf16_tflops
    if dtype == torch.float32:
        return rates.f32_tflops
    raise ValueError(f"no datasheet rate for {dtype}")


def hbm_bytes_per_s(device_kind: Optional[str] = None) -> float:
    """Device-memory rate (bytes/s); 0.0 for a device the table does not
    hold."""
    rates = card_rates(device_kind)
    return 0.0 if rates is None else rates.hbm_bytes_per_s


def roofline_ms(n_bytes: float, n_ops: float, rates: Rates
                ) -> Tuple[float, str]:
    """(bound_ms, bound_by) of a kernel: the least time a card of `rates`
    takes to move n_bytes through its memory and to do n_ops float32
    operations outside the tensor cores, the larger of the two, and which
    of "bytes" and "operations" it is."""
    by_bytes = n_bytes / rates.hbm_bytes_per_s * 1e3
    by_ops = n_ops / (rates.f32_tflops * 1e12) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def fold(carry: torch.Tensor, *outputs: torch.Tensor) -> torch.Tensor:
    """Fold a full float32 sum of every output into the chain's carry, so
    that every element of every output feeds the next application."""
    for out in outputs:
        carry = carry + torch.sum(out, dtype=torch.float32) * 1e-12
    return carry


def chain_ms(step_fn: Callable[[torch.Tensor], torch.Tensor],
             n_lo: int = 2, n_hi: int = 22, reps: int = 3,
             device: Union[str, torch.device, None] = None) -> float:
    """Milliseconds per application of step_fn (carry -> carry, a float32
    scalar on `device`, the current card when None).

    step_fn must thread its carry into the workload's inputs (e.g. `inputs
    + carry * 1e-12`) and fold every output back into the carry it returns
    (`fold`), so that each application waits for the one before.  A run
    of n applications ends in one scalar read back to the host; the
    result is (best of `reps` runs of n_hi - best of n_lo) / (n_hi - n_lo),
    after one warm-up run of n_hi.  Unlike the original's one compiled
    loop, each application here is dispatched by the host, so the figure
    includes the host's launch time where the host is slower than the
    card: that is what the port's callers pay."""
    device = device_rule.resolve(device)

    def run(n: int) -> float:
        carry = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n):
            carry = step_fn(carry)
        return float(carry)                 # the one sync of the run

    run(n_hi)

    def best(n: int) -> float:
        fastest = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run(n)
            fastest = min(fastest, time.perf_counter() - t0)
        return fastest

    t_lo = best(n_lo)
    t_hi = best(n_hi)
    return max(t_hi - t_lo, 0.0) / (n_hi - n_lo) * 1000.0


def timed(fn: Callable[[], object], warmup: int, iters: int,
          device: Union[str, torch.device]) -> float:
    """Mean milliseconds of fn() over iters calls, after warmup calls:
    between two CUDA events on a card, by the host's clock on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def host_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean host milliseconds of fn() (work that ends in a device->host
    copy, so it is synchronised) over iters calls, after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_busy(fn: Callable[[], object], iters: int) -> Optional[dict]:
    """torch.profiler trace of iters calls of fn: the share of the host's
    wall time in which the card ran kernels or copies, their number and
    device time per call, and the five kernels with the most device time
    per call.  None where the trace holds no device events (on the CPU).
    The profiler's own cost lengthens the wall time, so the share is a
    lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    fn()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if cuda:
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
            launches += 1
    if not by_name:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_share": sum(by_name.values()) / wall_us,
            "wall_ms_per_call": wall_us / iters / 1e3,
            "device_ms_per_call": sum(by_name.values()) / iters / 1e3,
            "device_launches_per_call": launches / iters,
            "top_kernels_ms_per_call": [(name[:80], us / iters / 1e3)
                                        for name, us in top]}
