"""Profiling and timing in torch terms (port of
``coarsegrainingvae_tpu.utils.profiling``).

``trace`` records a ``torch.profiler`` window (CPU and, with a card, CUDA
activity) and writes it as a Chrome trace; ``StepTimer`` keeps per-step
wall-clock statistics, its ``tick`` synchronising the device first (the JAX
package's caller blocks on each step); ``time_compile`` sets a callable's
first call (lazy nvcc builds, CUDA-graph capture, caches) against a steady
call; ``save_runtime`` writes a wall-clock figure as JSON.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace.json"):
    """Profile the block and write ``logdir/name``, a Chrome trace (open it
    in Perfetto or chrome://tracing). Usage: ``with trace("./tb"): run()``.
    Yields the profiler (``key_averages()`` for tables)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, name))


class StepTimer:
    """Wall-clock per-step statistics with warm-up exclusion.

    Call ``start()`` once and ``tick()`` after each step; ``tick`` waits for
    the card first, so a step's time is its device time plus the host's.
    ``summary()`` reports mean/p50/p95 step time and throughput.
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._t: List[float] = []
        self._last: Optional[float] = None

    def start(self) -> None:
        _sync()
        self._last = time.perf_counter()

    def tick(self) -> None:
        _sync()
        now = time.perf_counter()
        if self._last is not None:
            self._t.append(now - self._last)
        self._last = now

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        t = np.asarray(self._t[self.warmup:])
        if t.size == 0:
            return {}
        return {
            "steps": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "items_per_s": float(items_per_step / t.mean()),
        }


def time_compile(fn, *args) -> Dict[str, float]:
    """(first call, steady call) of ``fn(*args)``, each ending in a device
    sync: the first pays for lazy kernel builds, CUDA-graph capture and
    caches, whose cost is approximately their difference."""
    _sync()
    t0 = time.perf_counter()
    fn(*args)
    _sync()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn(*args)
    _sync()
    steady = time.perf_counter() - t0
    return {"first_call_s": first, "steady_s": steady,
            "compile_s_approx": max(first - steady, 0.0)}


def save_runtime(seconds: float, path: str) -> None:
    """Write a wall-clock figure as JSON ({"wall_clock_s": seconds})."""
    with open(path, "w") as f:
        json.dump({"wall_clock_s": seconds}, f)
