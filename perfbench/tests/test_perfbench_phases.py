"""``phases.py`` on the CPU: the attribution of device operations to the
program's spans on synthetic profiler events, the clock alignment, the span
table, and the readers of the span metrics, which find nothing to read in a
run without spans or without a device trace."""

from __future__ import annotations

import json
import time

import pytest
import torch
from torch.autograd import DeviceType

from laplace_inducing_points_tpu_torch.utils.profiling import SpanRecord
from perfbench import harness, phases

from perfbench_tiny import ROOT, TINY


class Event:
    """A stand-in for a raw profiler event (``_KinetoEvent``)."""

    def __init__(self, name, start, end, corr=0, device=DeviceType.CUDA, linked=0):
        self._name, self._start, self._end = name, start, end
        self._corr, self._device, self._linked = corr, device, linked

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def duration_ns(self):
        return self._end - self._start

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return False


def _span(name, unit, parent, start, end, cpu=0):
    return SpanRecord(name, unit, parent, start, cpu, end, cpu + (end - start) // 2)


def _spans(shift=0):
    """Two Z steps: [1000, 2000) and [3000, 4000) with their phases."""
    out = []
    for unit, t in ((0, 1000), (1, 3000)):
        top = len(out)
        out.append(_span("z_step", unit, -1, t + shift, t + 1000 + shift))
        for name, a, b in (("rows", 10, 200), ("objective.backward", 300, 600),
                           ("pullback", 600, 900)):
            out.append(_span(name, unit, top, t + a + shift, t + b + shift))
    return out


def _launch(t, corr, name="cudaLaunchKernel"):
    return Event(name, t, t + 5, corr, DeviceType.CPU)


def _events():
    """Each phase launches a kernel the device runs later; the backward's
    launch runs at a time the caller sits in ``objective.backward`` (as
    autograd's device thread does). One copy is launched between the steps."""
    ev = [Event(harness.MARKER, 900, 950), Event(harness.MARKER, 4900, 4950)]
    corr = 1
    for t in (1000, 3000):
        for launch, run, dur in ((20, 100, 150), (350, 400, 100), (700, 760, 300)):
            ev += [_launch(t + launch, corr), Event(f"k{corr}", t + run, t + run + dur, corr)]
            corr += 1
    ev += [_launch(2500, 99, "cudaMemcpyAsync"), Event("copy", 2550, 2600, 99)]
    return ev


def test_each_operation_goes_to_the_innermost_span_open_at_its_launch():
    table = phases.attribute(_events(), _spans(), (950, 4900))
    assert table["units"] == 2 and table["top"] == "z_step"
    rows = table["spans"]
    # per unit: rows 150 ns, backward 100, pullback 300 of device time
    assert rows["rows"]["device_ms"] == pytest.approx(150e-6)
    assert rows["objective.backward"]["device_ms"] == pytest.approx(100e-6)
    assert rows["pullback"]["device_ms"] == pytest.approx(300e-6)
    assert rows["z_step"]["device_ms"] == 0 and rows["z_step"]["launches"] == 0
    assert all(rows[n]["launches"] == 1 for n in ("rows", "objective.backward", "pullback"))
    assert rows["rows"]["wall_ms"] == pytest.approx(190e-6)
    assert rows["z_step"]["self_wall_ms"] == pytest.approx((1000 - 190 - 300 - 300) * 1e-6)
    assert rows["z_step"]["cpu_ms"] == pytest.approx(500e-6)
    whole = table["unit"]
    assert whole["device_ms"] == pytest.approx(550e-6) and whole["launches"] == 3
    assert whole["wall_ms"] == pytest.approx(1000e-6)
    # the copy between the steps is the only busy time launched outside them
    busy = 2 * 550 + 50
    assert table["busy_ms"] == pytest.approx(busy / 2 * 1e-6)
    assert table["covered"] == pytest.approx(1100 / busy)
    assert table["outside_launches"] == 1 and table["unmatched"] == 0


def test_idle_gaps_are_named_by_the_span_the_host_was_in():
    table = phases.attribute(_events(), _spans(), (950, 4900), top=20)
    names = [name for name, _ in table["idle_gaps"]]
    # the longest: from the second step's last kernel to the window's end
    assert names[0] == "outside: host after k6" and table["idle_gaps"][0][1] == 840e-9
    # between the first step's rows kernel (ends 1250) and the backward's (1400)
    assert "z_step/objective.backward: host after k1 before k2" in names
    assert "z_step/pullback: host after k2 before k3" in names
    assert "z_step/rows: cudaLaunchKernel before k1" in names     # the launch at its middle
    idle = table["spans"]
    assert sum(r["idle_ms"] for r in idle.values()) == pytest.approx(table["unit"]["idle_ms"])


def test_a_second_clock_is_aligned_by_the_markers_launch():
    events = _events() + [_launch(880, 7)]
    events[0] = Event(harness.MARKER, 900, 950, 7)
    offset, how = phases.clock_offset(events, 870, 890)
    assert offset == 0 and how.startswith("one clock")
    # the recorder read its clock 10,000 ns behind the profiler's
    offset, how = phases.clock_offset(events, 870 - 10_000, 890 - 10_000)
    assert offset == 10_000 and how.startswith("two clocks")
    shifted = phases.attribute(events, _spans(shift=-10_000), (950, 4900), offset)
    same = phases.attribute(events, _spans(), (950, 4900))
    assert shifted["spans"] == same["spans"]


def test_the_table_prints_every_span_and_the_shares():
    table = phases.attribute(_events(), _spans(), (950, 4900))
    lines = phases.table_lines(table, how="one clock")
    text = "\n".join(lines)
    for name in ("z_step", "rows", "objective.backward", "pullback", "(whole unit)"):
        assert name in text
    assert "(95.65% of it)" in text and "busy time launched inside a unit 95.65%" in text


def test_the_readers_find_nothing_without_spans_or_outside_their_driver():
    table = phases.attribute(_events(), _spans(), (950, 4900))
    names = [m["name"] for m in phases.PHASE_METRICS]
    read = {n: harness.load_module(ROOT / "perfbench" / "metrics" / f"{n}.py").read
            for n in names}
    z = {"kind": "ztrain", "phases": table}
    assert read["rows_ms.ztrain"](z) == pytest.approx(150e-6)
    assert read["pullback_ms.ztrain"](z) == pytest.approx(300e-6)
    assert read["objective_bwd_ms.ztrain"](z) == pytest.approx(100e-6)
    assert read["objective_fwd_ms.ztrain"](z) is None      # no such span in this table
    assert read["launches.ztrain"](z) == 3 and read["host_cpu_ms.ztrain"](z) == 500e-6
    for n in names:
        if n.endswith(".serve"):
            assert read[n](z) is None                        # a Z table is not a request's
        assert read[n]({"kind": "ztrain"}) is None            # the harness's own context
        assert read[n]({"kind": "serve", "phases": None}) is None
        assert read[n]({"kind": "other", "phases": table}) is None


def test_the_span_metrics_fit_the_manifest():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    have = {m["name"] for m in manifest["per_layer"] + manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    merged = phases.with_phase_metrics(manifest)
    assert merged["per_layer"][:len(manifest["per_layer"])] == manifest["per_layer"]
    for m in phases.PHASE_METRICS:
        assert m["name"] not in have and (ROOT / "perfbench" / "metrics" /
                                          f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= cells
        moves = next(e for e in manifest["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves["workloads"])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_tiny_cpu_run_reports_no_span_metric_and_keeps_its_keys(monkeypatch, cell):
    """On the CPU there is no device trace: the traced run with the span
    recorder wired in reports none of the span metrics; neither run's line
    changes its keys."""
    lines = {}
    for wired in (False, True):
        if wired:
            monkeypatch.setattr(harness, "traced_window", phases.traced_window)
        for trace in (False, True):
            run = harness.Run(cell, 11, torch.device("cpu"), config_overrides=TINY[cell])
            result = harness.execute(run, 0.2, trace, time.perf_counter(),
                                     bench_manifest=phases.with_phase_metrics(
                                         harness.manifest(harness.BENCH)))
            assert result["correct"], result
            lines[wired, trace] = result
    for trace in (False, True):
        assert list(lines[True, trace]) == list(lines[False, trace])
        assert set(lines[True, trace]["metrics"]) == set(lines[False, trace]["metrics"])
    assert not set(lines[True, True]["metrics"]) & {m["name"] for m in phases.PHASE_METRICS}


def test_operations_that_run_side_by_side_count_once():
    """cuDNN runs some backward kernels on streams of its own: a span's device
    time is the union of its operations', not their sum."""
    spans = [_span("z_step", 0, -1, 1000, 2000), _span("pullback", 0, 0, 1100, 1900)]
    events = [Event(harness.MARKER, 900, 950), Event(harness.MARKER, 2900, 2950),
              _launch(1200, 1), _launch(1210, 2), Event("dgrad_a", 1300, 1500, 1),
              Event("dgrad_b", 1400, 1600, 2)]
    table = phases.attribute(events, spans, (950, 2900))
    assert table["spans"]["pullback"]["device_ms"] == pytest.approx(300e-6)
    assert table["spans"]["pullback"]["launches"] == 2
    assert table["unit"]["device_ms"] == pytest.approx(300e-6) and table["covered"] == 1.0
