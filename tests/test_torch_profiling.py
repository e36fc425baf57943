"""The port's tracing and phase spans (``utils/profiling.py``): the trace file
and its span regions, the span recorder (off, nesting, units, its clock and
CPU time), and the spans of a Z step and of a predictor request, on the
CPU."""

import glob
import json
import os
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
from laplace_inducing_points_tpu_torch.training import inducing
from laplace_inducing_points_tpu_torch.utils.profiling import recording, span, trace

from torch_twins import inputs, make_twins


def _trace_events(log_dir: str) -> list:
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    return json.load(open(files[0]))["traceEvents"]


def _gram_step(example_block=None) -> None:
    """One gram Z step of the toy classifier: M = 6 points, 9 data points."""
    _, state, _ = make_twins("classifier")
    Z = torch.from_numpy(inputs("classifier", 6, seed=5))
    X = torch.from_numpy(inputs("classifier", 9, seed=6))
    inducing.optimize_step(Z, X, state, 0.5, inducing.make_optimizer(Z, 1e-2),
                           objective="gram", full_set_size=100, example_block=example_block)


def test_trace_writes_a_loadable_file_with_the_span_regions(tmp_path):
    with trace(str(tmp_path / "t")) as log_dir:
        with span("lipt_region_outer"):
            a = torch.randn(64, 64) @ torch.randn(64, 64)
            with span("lipt_region_inner"):
                a = torch.tanh(a)
    assert log_dir == str(tmp_path / "t")
    events = _trace_events(log_dir)
    names = {e.get("name") for e in events}
    assert {"lipt_region_outer", "lipt_region_inner", "aten::mm", "aten::tanh"} <= names
    outer = next(e for e in events if e.get("name") == "lipt_region_outer")
    inner = next(e for e in events if e.get("name") == "lipt_region_inner")
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert span("after") is span("the trace")         # off again


def test_a_traced_z_step_shows_its_phases(tmp_path):
    """What ``--profile`` writes: the Z step's spans as regions of the trace."""
    with trace(str(tmp_path / "t")) as log_dir:
        _gram_step()
    names = {e.get("name") for e in _trace_events(log_dir)}
    assert {"z_step", "rows", "objective.forward", "objective.backward", "pullback"} <= names


def test_off_a_span_is_the_shared_null_context_and_records_nothing():
    first, second = span("a"), span("b")
    assert first is second
    with first:
        pass
    with recording() as spans:
        pass
    assert spans == []
    with span("c"):
        with recording() as spans:
            pass
    assert spans == []


def test_nesting_sets_each_spans_parent():
    with recording() as spans:
        with span("outer"):
            with span("middle"):
                with span("inner"):
                    pass
            with span("sibling"):
                pass
    assert [(s.name, s.parent) for s in spans] == [
        ("outer", -1), ("middle", 0), ("inner", 1), ("sibling", 0)]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_top_level_spans_take_fresh_units_and_children_inherit_them():
    def on_a_thread():
        with span("worker"):
            with span("worker.child"):
                pass

    with recording() as spans:
        for _ in range(3):
            with span("step"):
                with span("phase"):
                    with span("part"):
                        pass
        with span("request"):
            worker = threading.Thread(target=on_a_thread)
            worker.start()
            worker.join(timeout=60)
        assert not worker.is_alive()
    units = {(s.name, s.unit) for s in spans}
    assert [s.unit for s in spans if s.name == "step"] == [0, 1, 2]
    assert [s.unit for s in spans if s.name == "part"] == [0, 1, 2]
    assert ("request", 3) in units
    # a span opened on another thread nests in that thread's spans alone
    worker_unit = next(s.unit for s in spans if s.name == "worker")
    assert worker_unit == 4 and ("worker.child", 4) in units


@pytest.mark.parametrize("raises", [False, True])
def test_recording_stops_when_its_context_ends(raises):
    try:
        with recording() as spans:
            with span("inside"):
                if raises:
                    raise KeyError("a failing step")
    except KeyError:
        assert raises
    assert [s.name for s in spans] == ["inside"] and spans[0].end_ns >= spans[0].start_ns
    assert span("after") is span("again")
    with span("after"):
        pass
    assert len(spans) == 1
    with recording() as fresh:           # a new recording starts empty, at unit 0
        with span("next"):
            pass
    assert [(s.name, s.unit) for s in fresh] == [("next", 0)]


def test_one_recording_at_a_time():
    with recording():
        with pytest.raises(RuntimeError, match="open already"):
            with recording():
                pass


def test_the_spans_clock_is_the_profilers():
    """A ``record_function`` event of the profiler lies inside the interval
    that the recorder stamped around it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as spans:
            for i in range(5):
                with span(f"lipt_span_{i}"):
                    with record_function(f"lipt_event_{i}"):
                        torch.randn(256, 256).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for i, s in enumerate(spans):
        e = events[f"lipt_event_{i}"]
        assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns, (s, e.start_ns())


def test_cpu_time_is_the_processes_and_counts_another_threads_work():
    burned = []

    def burn():
        t0 = time.thread_time_ns()
        x = 0
        while time.thread_time_ns() - t0 < 50_000_000:     # 50 ms of this thread's CPU
            x += 1
        burned.append(time.thread_time_ns() - t0)

    with recording() as spans:
        with span("waits"):
            worker = threading.Thread(target=burn)
            worker.start()
            worker.join(timeout=60)
    assert not worker.is_alive()
    (s,) = spans
    assert s.cpu_start_ns <= s.cpu_end_ns and s.start_ns <= s.end_ns
    assert s.cpu_end_ns - s.cpu_start_ns >= 0.9 * burned[0]


@pytest.mark.parametrize("example_block", [None, 4])
def test_a_gram_z_step_records_its_phases_in_order(example_block):
    with recording() as spans:
        _gram_step(example_block)
    assert [(s.name, s.parent) for s in spans] == [
        ("z_step", -1), ("rows", 0), ("rows", 0), ("objective.forward", 0),
        ("objective.backward", 0), ("pullback", 0)]
    assert {s.unit for s in spans} == {0}
    assert all(s.end_ns >= s.start_ns > 0 and s.cpu_end_ns >= s.cpu_start_ns for s in spans)


@pytest.mark.parametrize("sample_block, blocks", [(None, 1), (2, 3)])
def test_a_weight_predictor_request_records_one_contract_and_pushforward_a_block(
        sample_block, blocks):
    _, state, _ = make_twins("classifier")
    Z = torch.from_numpy(inputs("classifier", 4, seed=5))
    x = torch.from_numpy(inputs("classifier", 3, seed=7))
    pred = ScalableLLAPredictor(state, Z, full_set_size=100, method="weight",
                                sample_block=sample_block)
    g = torch.Generator().manual_seed(0)
    with recording() as spans:
        out = pred.logit_samples(x, 0.5, g, 5)
        pred.logit_samples(x, 0.5, g, 5)
    assert out.shape == (5, 3, 3)
    one = [("predict", -1)] + [("contract", 0), ("pushforward", 0)] * blocks
    n = len(one)
    assert [(s.name, s.parent) for s in spans[:n]] == one
    assert [(s.name, s.unit) for s in spans[n:]] == [(name, 1) for name, _ in one]
    # the draws are the ones made without spans
    expect = pred.logit_samples(x, 0.5, torch.Generator().manual_seed(0), 5)
    assert torch.equal(out, expect)

