"""Lightweight profiling helpers: wall timers with device sync and
jax.profiler trace capture.
"""

from __future__ import annotations

import contextlib
import time

import jax


def sync(x):
    """Wait for everything ``x`` depends on; returns ``x``."""
    return jax.block_until_ready(x)


@contextlib.contextmanager
def wall_timer(label: str = "", sink=None):
    """``with wall_timer("solve") as t: ...`` then ``t()`` gives seconds."""
    t0 = time.time()
    result = {}
    yield lambda: result.get("dt", time.time() - t0)
    result["dt"] = time.time() - t0
    if sink is not None:
        sink(label, result["dt"])


def nnz_per_second(nnz: int, seconds: float) -> float:
    return nnz / seconds


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
