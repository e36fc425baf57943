"""Tracing and step-timing instrumentation.

Counterpart of ``laplace_inducing_points_tpu/utils/profiling.py``:

* ``trace(dir)``: a context manager around ``torch.profiler`` that writes a
  TensorBoard-loadable ``*.pt.trace.json`` of the host and, on a GPU, the
  device (every kernel with its name and duration) into ``dir``;
* ``annotate(name)``: a named region (``torch.profiler.record_function``)
  that shows up in the trace;
* ``StepTimer``: wall-clock EMA/percentile step metrics with JSONL export.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, sync: bool = True):
    """Capture a trace: ``with trace("traces/run"): step()``; yields the
    directory. Default: ``lipt_trace`` under the temporary directory.

    CPU activity always, CUDA activity where a GPU is available. ``sync=True``
    (the default) calls ``torch.cuda.synchronize()`` before the profiler
    stops, so kernels launched inside the region and still running are on
    the trace even when the caller never waited for them.
    """
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "lipt_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield log_dir
    finally:
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step metrics with EMA and summary percentiles.

    Usage::

        timer = StepTimer("inducing_step")
        with timer:
            loss = optimize_step(...)
            torch.cuda.synchronize()
        print(timer.summary())
    """

    def __init__(self, name: str, ema: float = 0.9):
        self.name = name
        self.ema_coef = ema
        self.ema: Optional[float] = None
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        self.ema = dt if self.ema is None else \
            self.ema_coef * self.ema + (1 - self.ema_coef) * dt
        return False

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"name": self.name, "steps": 0}
        xs = sorted(self.samples)
        n = len(xs)
        return {
            "name": self.name,
            "steps": n,
            "mean_s": sum(xs) / n,
            "p50_s": xs[n // 2],
            "p90_s": xs[min(int(0.9 * n), n - 1)],
            "last_s": self.samples[-1],
            "ema_s": self.ema,
        }

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(self.summary()) + "\n")
