"""Tracing and phase spans.

Counterpart of ``laplace_inducing_points_tpu/utils/profiling.py``:

* ``trace(dir)``: a context manager around ``torch.profiler`` that writes a
  TensorBoard-loadable ``*.pt.trace.json`` of the host and, on a GPU, the
  device (every kernel with its name and duration) into ``dir``; every
  ``span`` opened inside it shows as a region of the same name;
* ``span(name)``: a named phase of the program (a Z step, a row build, one
  request). It costs one flag check unless a ``recording`` or a ``trace`` is
  open;
* ``recording()``: records every span opened inside it, with its clock and
  process CPU times (``SpanRecord``), into a list it yields.

Spans are stamped with ``time.time_ns()``, the clock of ``torch.profiler``'s
raw events (``start_ns()``, ``end_ns()``), so a recording taken under a
profiler lines up with its events. CPU time is the whole process's
(``time.process_time_ns()``): autograd runs the backward of CUDA operations
on a thread of its own, and the caller's thread would miss that work.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(slots=True)
class SpanRecord:
    """One span: ``unit`` is shared by a top-level span and everything
    nested in it; ``parent`` is the index of the enclosing span in the
    recording (-1 at top level); times in ns, ``end_ns``/``cpu_end_ns`` 0
    while the span is open."""
    name: str
    unit: int
    parent: int
    start_ns: int
    cpu_start_ns: int
    end_ns: int = 0
    cpu_end_ns: int = 0


class _Recording:
    def __init__(self):
        self.spans: list[SpanRecord] = []
        self.units = 0
        self.local = threading.local()      # each thread's stack of open spans

    def stack(self) -> list[int]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_recording: Optional[_Recording] = None
_tracing = 0            # open ``trace`` contexts
_on = False             # either of them: the one check a span makes


def _update() -> None:
    global _on
    _on = _recording is not None or _tracing > 0


class _Span:
    __slots__ = ("name", "recording", "index", "region")

    def __init__(self, name: str):
        self.name = name
        self.recording = _recording
        self.region = torch.profiler.record_function(name) if _tracing else None

    def __enter__(self):
        if self.region is not None:
            self.region.__enter__()
        rec = self.recording
        if rec is not None:
            stack = rec.stack()
            if stack:
                parent = stack[-1]
                unit = rec.spans[parent].unit
            else:
                parent, unit = -1, rec.units
                rec.units += 1
            self.index = len(rec.spans)
            stack.append(self.index)
            rec.spans.append(SpanRecord(self.name, unit, parent, time.time_ns(),
                                        time.process_time_ns()))
        return self

    def __exit__(self, *exc):
        rec = self.recording
        if rec is not None:
            record = rec.spans[self.index]
            record.cpu_end_ns = time.process_time_ns()
            record.end_ns = time.time_ns()
            rec.stack().pop()
        if self.region is not None:
            self.region.__exit__(*exc)
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """A named phase: ``with span("rows"): ...``. Off (no ``recording``, no
    ``trace``) it returns one shared null context."""
    if not _on:
        return _NULL
    return _Span(name)


@contextlib.contextmanager
def recording():
    """``with recording() as spans:``: every span opened inside, on any
    thread, is appended to ``spans`` as a ``SpanRecord`` when it opens and
    completed when it closes. One recording at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a span recording is open already")
    _recording = _Recording()
    _update()
    try:
        yield _recording.spans
    finally:
        _recording = None
        _update()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, sync: bool = True):
    """Capture a trace: ``with trace("traces/run"): step()``; yields the
    directory. Default: ``lipt_trace`` under the temporary directory.

    CPU activity always, CUDA activity where a GPU is available. ``sync=True``
    (the default) calls ``torch.cuda.synchronize()`` before the profiler
    stops, so kernels launched inside the region and still running are on
    the trace even when the caller never waited for them.
    """
    global _tracing
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "lipt_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    _tracing += 1
    _update()
    try:
        yield log_dir
    finally:
        _tracing -= 1
        _update()
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
