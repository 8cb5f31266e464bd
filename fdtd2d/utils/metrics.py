"""Benchmark/observability primitives: timers, throughput counters, traces.

The reference has no profiling or metrics at all — only tqdm progress bars
and wall-clock claims in README prose (SURVEY.md section 5). Here:

- :class:`Timer` — wall-clock context with device synchronization,
- :func:`throughput_gcells` — the GCells/s counter used by the benchmark
  harness and bench.py,
- :func:`trace_profile` — ``jax.profiler`` trace capture around any block
  (view with TensorBoard or xprof).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


class Timer:
    """``with Timer() as t: ...`` — synchronizes the device on exit."""

    def __init__(self, sync_on=None):
        self._sync_on = sync_on
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync_on is not None:
            jax.block_until_ready(self._sync_on)
        self.seconds = time.perf_counter() - self._t0
        return False


def throughput_gcells(cells: int, steps: int, fn: Callable, *,
                      repeats: int = 3) -> float:
    """Best-of-N GCell-updates/s for ``fn()`` advancing ``steps`` steps."""
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        dt = time.perf_counter() - t0
        best = max(best, cells * steps / dt / 1e9)
    return best


@contextlib.contextmanager
def trace_profile(log_dir: str = "/tmp/fdtd2d_trace"):
    """Capture a jax.profiler trace for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
