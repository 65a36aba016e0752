"""Keyed timers + averaged reports (reference Profiler,
include/openpose/utilities/profiler.hpp:66-100).

Counterpart of `openpose_tpu/utils/profiler.py`.  CUDA launches are
asynchronous: `timer_end` waits for the streams of the tensors it is given
before it reads the clock, mirroring the reference's
cudaDeviceSynchronize-bracketed OP_CUDA_PROFILE macros (profiler.hpp:31-65).
A stage that ends in a device->host copy is already synchronised.
`speed_of_light_ms` is the original's roofline helper, its default rates
those of the card in use (`utils/benchmark.py`'s datasheet table).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Iterable, Optional

import torch

from openpose_tpu_torch.utils import benchmark


class Profiler:
    enabled: bool = True

    def __init__(self, report_every: int = 1000):
        self.report_every = report_every
        self._acc: Dict[str, float] = collections.defaultdict(float)
        self._count: Dict[str, int] = collections.defaultdict(int)
        self._open: Dict[str, float] = {}

    def timer_init(self, key: str) -> None:
        if self.enabled:
            self._open[key] = time.perf_counter()

    def timer_end(self, key: str,
                  device_tensors: Optional[Iterable[torch.Tensor]] = None
                  ) -> float:
        if not self.enabled or key not in self._open:
            return 0.0
        for device in {t.device for t in device_tensors or () if t.is_cuda}:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._open.pop(key)
        self._acc[key] += dt
        self._count[key] += 1
        if self._count[key] % self.report_every == 0:
            print(self.report_line(key))
        return dt

    def report_line(self, key: str) -> str:
        avg = self._acc[key] / max(self._count[key], 1) * 1000.0
        return f"[profiler] {key}: {avg:.2f} ms avg over {self._count[key]}"

    def report(self) -> str:
        return "\n".join(self.report_line(k) for k in sorted(self._acc))

    def averages_ms(self) -> Dict[str, float]:
        return {k: self._acc[k] / max(self._count[k], 1) * 1000.0
                for k in self._acc}



def speed_of_light_ms(flops: float, bytes_moved: float,
                      peak_tflops: Optional[float] = None,
                      hbm_gbps: Optional[float] = None) -> float:
    """Roofline lower bound in ms: the larger of flops over the peak rate
    and bytes_moved over the memory rate.  Defaults: the bf16 peak and the
    HBM rate of the card in use; raises ValueError where the datasheet
    table does not hold that device (the CPU included) and no rate was
    given."""
    if peak_tflops is None:
        peak_tflops = benchmark.bf16_peak_tflops()
    if hbm_gbps is None:
        hbm_gbps = benchmark.hbm_bytes_per_s() / 1e9
    if not peak_tflops or not hbm_gbps:
        raise ValueError(f"no datasheet rates for {benchmark.device_name()!r}"
                         ": pass peak_tflops and hbm_gbps")
    compute_ms = flops / (peak_tflops * 1e12) * 1e3
    memory_ms = bytes_moved / (hbm_gbps * 1e9) * 1e3
    return max(compute_ms, memory_ms)
