"""The port's tracing and step timing (``utils/profiling.py``): the trace file
and its annotated regions on the CPU, and ``StepTimer`` against the JAX
package's on the same samples."""

import glob
import json
import os
import time

import pytest
import torch

from laplace_inducing_points_tpu.utils.profiling import StepTimer as JaxStepTimer
from laplace_inducing_points_tpu_torch.utils.profiling import StepTimer, annotate, trace


def test_trace_writes_a_loadable_file_with_the_annotated_regions(tmp_path):
    with trace(str(tmp_path / "t")) as log_dir:
        with annotate("lipt_region_outer"):
            a = torch.randn(64, 64) @ torch.randn(64, 64)
            with annotate("lipt_region_inner"):
                a = torch.tanh(a)
    assert log_dir == str(tmp_path / "t")
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"lipt_region_outer", "lipt_region_inner", "aten::mm", "aten::tanh"} <= names
    outer = next(e for e in events if e.get("name") == "lipt_region_outer")
    inner = next(e for e in events if e.get("name") == "lipt_region_inner")
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("samples", [[], [0.5], [0.3, 0.1, 0.2, 0.9, 0.4, 0.05, 0.7]])
def test_step_timer_summary_matches_jax(monkeypatch, samples):
    """Both timers time the same steps on one fake clock."""
    ticks = []
    for i, dt in enumerate(samples):
        ticks += [10.0 * i, 10.0 * i + dt] * 2          # ours, then the reference
    clock = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    ours, ref = StepTimer("unit"), JaxStepTimer("unit")
    for _ in samples:
        with ours:
            pass
        with ref:
            pass
    assert ours.summary() == ref.summary()
    assert ours.samples == pytest.approx(samples, abs=1e-12)


def test_step_timer_dump_appends_jsonl(tmp_path):
    timer = StepTimer("unit")
    with timer:
        pass
    path = tmp_path / "sub" / "timer.jsonl"
    timer.dump(str(path))
    timer.dump(str(path))
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows == [timer.summary()] * 2
