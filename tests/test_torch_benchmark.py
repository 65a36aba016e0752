"""The port's measuring layer (`openpose_tpu_torch/utils/benchmark.py`,
`utils/profiler.speed_of_light_ms`) against the JAX package's
(`openpose_tpu/utils/benchmark.py`, `utils/profiler.py`), on the CPU.

Tolerances: `fold` rtol 1e-6 (float32 sums of the same outputs, taken in
another order); `speed_of_light_ms` rtol 1e-12 (the same double-precision
formula).  The datasheet table is held to NVIDIA's H100 SXM5 figures.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_tpu.utils import benchmark as jbenchmark
from openpose_tpu.utils import profiler as jprofiler
from openpose_tpu_torch.utils import benchmark, profiler

H100 = "NVIDIA H100 80GB HBM3"


def test_fold_matches_jax():
    """Three outputs of other shapes and types folded into a carry: the
    same scalar as JAX's `fold` within 1e-6."""
    rng = np.random.RandomState(0)
    outputs = [rng.uniform(-3, 7, (4, 46, 82, 78)).astype(np.float32),
               rng.uniform(0, 1e3, (2, 26, 127, 127)).astype(np.float32),
               rng.randint(0, 255, (8, 5)).astype(np.int32)]
    carry = np.float32(0.25)
    got = benchmark.fold(torch.tensor(carry),
                         *(torch.from_numpy(o) for o in outputs))
    want = jbenchmark.fold(jnp.float32(carry),
                           *(jnp.asarray(o) for o in outputs))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_fold_keeps_bf16_outputs_in_float32():
    x = torch.full((1000,), 1.0 + 2 ** -7, dtype=torch.bfloat16)
    got = benchmark.fold(torch.zeros(()), x)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(1000 * (1.0 + 2 ** -7) * 1e-12,
                                       rel=1e-6)


def test_bf16_peak_of_the_cpu_is_zero_as_in_jax():
    assert benchmark.bf16_peak_tflops("cpu") == 0.0
    assert jbenchmark.bf16_peak_tflops("cpu") == 0.0
    # no card here: the default device is the CPU
    assert benchmark.bf16_peak_tflops() == 0.0
    assert benchmark.card_rates() is None


def test_datasheet_rates_of_the_h100_sxm():
    assert benchmark.bf16_peak_tflops(H100) == 989.4
    assert benchmark.peak_tflops(torch.bfloat16, H100) == 989.4
    assert benchmark.peak_tflops(torch.float32, H100) == 67.0
    assert benchmark.hbm_bytes_per_s(H100) == 3.35e12
    assert benchmark.card_rates(H100) is benchmark.H100_SXM


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB", "TPU v5 lite",
                                  "cpu"])
def test_a_device_the_table_does_not_hold_has_no_rate(name):
    """Other cards and the TPUs have no entry: the port states no figure
    of theirs."""
    assert benchmark.peak_tflops(torch.bfloat16, name) == 0.0
    assert benchmark.peak_tflops(torch.float32, name) == 0.0
    assert benchmark.hbm_bytes_per_s(name) == 0.0


def test_peak_of_another_type_raises():
    with pytest.raises(ValueError, match="float16"):
        benchmark.peak_tflops(torch.float16, H100)


@pytest.mark.parametrize("flops,bytes_moved,peak,gbps", [
    (3.869e12, 11.2e9, 67.0, 3350.0),        # compute-bound
    (1.0e9, 193e6, 989.4, 3350.0),           # memory-bound
    (5.0e12, 2.0e9, 197.0, 819.0),           # JAX's own defaults
])
def test_speed_of_light_matches_jax(flops, bytes_moved, peak, gbps):
    got = profiler.speed_of_light_ms(flops, bytes_moved, peak, gbps)
    want = jprofiler.speed_of_light_ms(flops, bytes_moved, peak, gbps)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_speed_of_light_defaults_to_the_card_and_raises_without_one():
    with pytest.raises(ValueError, match="no datasheet rates"):
        profiler.speed_of_light_ms(1e12, 1e9)
    assert profiler.speed_of_light_ms(1e12, 1e9, peak_tflops=989.4,
                                      hbm_gbps=3350.0) \
        == pytest.approx(max(1e12 / 989.4e12, 1e9 / 3.35e12) * 1e3)


def test_roofline_names_its_bound():
    rates = benchmark.H100_SXM
    ms, by = benchmark.roofline_ms(20.0e6, 11.48e9, rates)
    assert by == "operations" and ms == pytest.approx(11.48e9 / 67e12 * 1e3)
    ms, by = benchmark.roofline_ms(2.019e9, 10.4e9, rates)
    assert by == "bytes" and ms == pytest.approx(2.019e9 / 3.35e12 * 1e3)


def test_chain_ms_on_the_cpu_calls_the_step_as_the_method_says():
    """Finite and > 0, and step_fn runs n_hi times to warm up, then n_lo +
    n_hi times a repetition; every application sees the carry."""
    calls = []
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))

    def step(carry):
        calls.append(float(carry))
        return benchmark.fold(carry, x @ (x + carry * 1e-12))

    n_lo, n_hi, reps = 2, 7, 3
    ms = benchmark.chain_ms(step, n_lo, n_hi, reps, device="cpu")
    assert math.isfinite(ms) and ms > 0
    assert len(calls) == n_hi + reps * (n_lo + n_hi)
    # each run starts from a zero carry and threads it on
    assert calls[0] == 0.0 and calls[1] != 0.0


def test_chain_ms_without_a_device_asks_for_the_card():
    from openpose_tpu_torch.device import NoCudaDeviceError
    with pytest.raises(NoCudaDeviceError):
        benchmark.chain_ms(lambda c: c)


def test_timed_and_host_ms_on_the_cpu():
    calls = []
    assert benchmark.timed(lambda: calls.append(1), 2, 5, "cpu") >= 0
    assert len(calls) == 7
    assert benchmark.host_ms(lambda: calls.append(1), 3) >= 0
    assert len(calls) == 11


def test_device_busy_has_no_device_events_on_the_cpu():
    """A trace without a card holds no device time: None, not a share."""
    x = torch.ones(256, 256)
    assert benchmark.device_busy(lambda: x @ x, 2) is None


def test_device_name_of_the_cpu():
    assert benchmark.device_name() == "cpu"
    assert benchmark.device_name("cpu") == "cpu"
