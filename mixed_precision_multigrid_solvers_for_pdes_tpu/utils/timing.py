"""Timers and benchmarking helpers, device-aware.

Counterpart of reference utils/performance.py:14-344 (Timer,
PerformanceProfiler, benchmark_function), with the JAX-specific care the
reference's CUDA version took with cudaDeviceSynchronize: every measured
region ends with ``jax.block_until_ready`` so async dispatch cannot fake a
fast time, and the first (compile) call is excluded unless asked for.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import jax
import numpy as np


class Timer:
    """Context-managed wall timer with optional device sync
    (reference utils/performance.py:55-91)."""

    def __init__(self, name: str = "", sync: Any = None):
        self.name = name
        self.sync = sync  # value/pytree to block on at exit
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            jax.block_until_ready(self.sync)
        self.elapsed = time.perf_counter() - self.t0
        return False


@dataclasses.dataclass
class OpStats:
    count: int = 0
    total: float = 0.0
    best: float = float("inf")
    worst: float = 0.0

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class PerformanceProfiler:
    """Named-region accumulator (reference utils/performance.py:92-222)."""

    def __init__(self):
        self._stats: Dict[str, OpStats] = defaultdict(OpStats)
        self._open: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def end(self, name: str, sync: Any = None) -> float:
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - self._open.pop(name)
        s = self._stats[name]
        s.count += 1
        s.total += dt
        s.best = min(s.best, dt)
        s.worst = max(s.worst, dt)
        return dt

    def region(self, name: str):
        profiler = self

        class _Region:
            def __enter__(self):
                profiler.start(name)
                return self

            def __exit__(self, *exc):
                profiler.end(name)
                return False

        return _Region()

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"count": s.count, "total_s": s.total, "mean_s": s.mean,
                "best_s": s.best, "worst_s": s.worst}
            for k, s in sorted(self._stats.items(), key=lambda kv: -kv[1].total)
        }


def benchmark_function(
    fn: Callable,
    *args,
    warmup: int = 1,
    runs: int = 5,
    **kwargs,
) -> Dict[str, float]:
    """Time ``fn(*args)`` with compile excluded and device sync included
    (reference utils/performance.py:297-344)."""
    for _ in range(max(warmup, 0)):
        jax.block_until_ready(fn(*args, **kwargs))
    times: List[float] = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "mean_s": float(arr.mean()),
        "std_s": float(arr.std()),
        "min_s": float(arr.min()),
        "max_s": float(arr.max()),
        "runs": runs,
    }


def trace_profile(path: str = "/tmp/jax_trace"):
    """jax.profiler trace context for xprof/tensorboard inspection — the
    counterpart of the reference's CUDA-event GPU profiler
    (reference gpu/gpu_profiler.py:103-209)."""
    return jax.profiler.trace(path)
