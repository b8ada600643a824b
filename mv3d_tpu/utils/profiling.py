"""Profiling helpers: device traces and per-step timing.

Equivalent of the reference's TF ``RunOptions(FULL_TRACE)`` +
``RunMetadata`` TensorBoard timelines (src/mv3d.py:1211-1213, 1366-1384):
``jax.profiler`` traces plus a simple step-time aggregator.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str = "log/profile"):
    """Capture a jax profiler trace (view with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Aggregates wall-clock step times; blocks on the step output."""

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self, result=None):
        t0 = time.time()
        yield
        if result is not None:
            jax.block_until_ready(result)
        self.times.append(time.time() - t0)

    def record(self, seconds: float):
        self.times.append(seconds)

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        ts = np.asarray(self.times[skip_warmup:] or self.times)
        return {"mean_s": float(ts.mean()), "median_s": float(np.median(ts)),
                "p90_s": float(np.percentile(ts, 90)), "n": len(ts)}
