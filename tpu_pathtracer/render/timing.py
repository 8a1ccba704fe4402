"""Per-pass timing utilities.

The reference wraps every GPU pass in timestamp queries and smooths the
readback over a 30-sample rolling window (reference: src/timing.ts:1-20,
28-146, surfaced per-pass in the UI via pass.timingAverage, src/passes/
pass.ts:22-26).  Here a pass is a jitted program: on an accelerator its
time is the device busy time of one profiler trace of it
(utils/devtime.device_time); on the CPU backend, which has no device
trace, it is wall time up to `jax.block_until_ready`.  Both are smoothed
by the same rolling average.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class RollingAverage:
    """30-sample ring-buffer mean (reference: src/timing.ts:1-20)."""

    def __init__(self, num_samples: int = 30) -> None:
        self._num_samples = num_samples
        self._samples: list[float] = []
        self._cursor = 0

    def add_sample(self, value: float) -> None:
        if len(self._samples) < self._num_samples:
            self._samples.append(value)
        else:
            self._samples[self._cursor] = value
        self._cursor = (self._cursor + 1) % self._num_samples

    @property
    def value(self) -> float:
        if not self._samples:
            return 0.0
        return sum(self._samples) / len(self._samples)


class PassTimer:
    """Times one named pass; `value` is the rolling mean in microseconds."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.average = RollingAverage()

    @contextmanager
    def measure(self, result_to_block=None):
        import jax

        start = time.perf_counter()
        yield
        if result_to_block is not None:
            jax.block_until_ready(result_to_block)
        self.average.add_sample((time.perf_counter() - start) * 1e6)

    def time_blocked(self, fn, *args, **kwargs):
        """Run fn, wait for its output, record elapsed; returns the output."""
        import jax

        start = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        self.average.add_sample((time.perf_counter() - start) * 1e6)
        return out

    def time_device(self, fn, *args, **kwargs):
        """Run fn and record its device busy time from a profiler trace
        (works for sharded programs, where wall time would fold in
        cross-device dispatch skew).  The CPU backend has no device trace
        and records wall time (`time_blocked`); on an accelerator a trace
        without device operations is an error, not a fallback."""
        import jax

        from ..utils.devtime import device_time

        if jax.default_backend() == "cpu":
            return self.time_blocked(fn, *args, **kwargs)
        dt = device_time(lambda: fn(*args, **kwargs))
        if not dt["ok"]:
            raise RuntimeError(
                f"pass {self.name!r}: the profiler trace holds no device "
                "operations")
        self.average.add_sample(dt["busy_s"] * 1e6)
        return dt["out"]

    @property
    def value(self) -> float:
        return self.average.value
