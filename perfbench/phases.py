"""The program's phase spans on the device trace: which span launched each
device operation, the span table, idle gaps named by phase, and the per-layer
metrics read from them.

    python3 perfbench/phases.py --workload <cell> --seed <n> --seconds <s>
    python3 perfbench/phases.py --workload <cell> --seed <n> --seconds <s> --cost <pairs>

The first runs the cell as ``run.py --trace 1`` does (``harness.execute``),
with the program's span recorder (``utils/profiling.recording``) on around
the traced window alone: standard error gets the span table, and the result
line carries the metrics of ``PHASE_METRICS`` beside the manifest's and idle
gaps named by the span the host was in. The second measures what recording
costs: after set-up, ``<pairs>`` pairs of windows of ``<s>`` seconds, one
recording and one not, in alternating order, no profiler; it prints their
times per unit. Both need a CUDA device.

The attribution: a device operation (kernel, copy, set) goes to the innermost
span open when the CUDA runtime call that launched it ran, matched by the
correlation id the profiler gives both, on whatever thread it ran (autograd
launches the backward from a thread of its own while the caller waits inside
``objective.backward``). Spans are stamped on ``time.time_ns()``; where the
profiler's clock differs, the two are aligned by the launch of the window's
opening marker kernel.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[1]

TOP = {"ztrain": "z_step", "serve": "predict"}
Z_CELLS = ["lenet5_mnist.ztrain_gram", "resnet1m_cifar10.ztrain_gram"]
SERVE_CELLS = ["lenet5_mnist.serve_weight"]
ROWS_LAYER = "rows, pullback, push-forward (core/operators.py)"
ALGEBRA_LAYER = "Gram algebra and kernels (training/inducing.py, ops/cuda)"


def _metric(name, unit, source, layer, moves, cells):
    return {"name": name, "unit": unit, "better": "lower", "source": source, "layer": layer,
            "moves": moves, "workloads": cells}


# the per-layer metrics of the spans, in the manifest's form
PHASE_METRICS = [
    _metric("rows_ms.ztrain", "ms", "device_trace", ROWS_LAYER, "z_step_ms", Z_CELLS),
    _metric("pullback_ms.ztrain", "ms", "device_trace", ROWS_LAYER, "z_step_ms", Z_CELLS),
    _metric("objective_fwd_ms.ztrain", "ms", "device_trace", ALGEBRA_LAYER, "z_step_ms",
            Z_CELLS),
    _metric("objective_bwd_ms.ztrain", "ms", "device_trace", ALGEBRA_LAYER, "z_step_ms",
            Z_CELLS),
    _metric("host_cpu_ms.ztrain", "ms", "host_clock", "whole Z step (training/inducing.py)",
            "z_step_ms", Z_CELLS),
    _metric("launches.ztrain", "count", "device_trace", "whole Z step (training/inducing.py)",
            "z_step_ms", Z_CELLS),
    _metric("contract_ms.serve", "ms", "device_trace",
            "whole predictor batch (inference/lla.py)", "predict_img_per_s", SERVE_CELLS),
    _metric("pushforward_ms.serve", "ms", "device_trace", ROWS_LAYER, "predict_img_per_s",
            SERVE_CELLS),
    _metric("host_cpu_ms.serve", "ms", "host_clock", "whole predictor batch (inference/lla.py)",
            "predict_img_per_s", SERVE_CELLS),
    _metric("launches.serve", "count", "device_trace",
            "whole predictor batch (inference/lla.py)", "predict_img_per_s", SERVE_CELLS),
]


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

def innermost(spans, offset_ns: int = 0):
    """``f(t) -> index of the innermost span open at t, or -1``, vectorised
    over an array of times on the profiler's clock (the spans' own shifted
    by ``offset_ns``). Spans of one thread nest; where threads interleave,
    the latest opened of those still open counts."""
    marks = sorted([(s.start_ns + offset_ns, 1, i) for i, s in enumerate(spans)]
                   + [(s.end_ns + offset_ns, 0, i) for i, s in enumerate(spans)])
    # the times at which the innermost open span changes, and that span after
    # each (-1 before the first)
    breaks, owner, open_ = [np.iinfo(np.int64).min], [-1], []
    for t, opens, i in marks:
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
        breaks.append(t)
        owner.append(open_[-1] if open_ else -1)
    breaks, owner = np.array(breaks, np.int64), np.array(owner, np.int64)

    def at(times) -> np.ndarray:
        return owner[np.searchsorted(breaks, np.asarray(times, np.int64), side="right") - 1]
    return at


def path(spans, i: int) -> str:
    """``z_step/pullback``: the span's name under its ancestors'."""
    names = []
    while i >= 0:
        names.append(spans[i].name)
        i = spans[i].parent
    return "/".join(reversed(names))


def device_ops(events, window):
    """The device operations of the trace that overlap the window (kernels,
    copies, sets; the markers and user annotations left out, as
    ``harness.read_trace`` leaves them)."""
    from perfbench.harness import MARKER
    w0, w1 = window
    return [e for e in events if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation() and MARKER not in e.name()
            and e.end_ns() > w0 and e.start_ns() < w1]


def launch_times(events, ops) -> np.ndarray:
    """For each device operation the start of the runtime call that launched
    it (host events with the same correlation id), -1 where none matched."""
    launch = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.correlation_id():
            launch.setdefault(e.correlation_id(), e.start_ns())
    return np.array([launch.get(e.correlation_id(), launch.get(e.linked_correlation_id(), -1))
                     for e in ops], np.int64)


def attribute(events, spans, window: tuple[int, int], offset_ns: int = 0,
              top: int = 10) -> dict:
    """The span table of a traced window. Per traced unit (a top-level span
    that opened inside the window), for each span name: the device ms and the
    launches of the operations it launched itself (not through a nested
    span), its wall, self-wall and process-CPU ms, and the device's idle ms
    whose gap midpoint it held innermost; ``unit``: the same over a whole
    unit; ``covered``: the share of the window's device busy time launched
    inside a unit; ``idle_gaps``: the ``top`` longest gaps named by span."""
    from perfbench.harness import merged
    w0, w1 = window
    ops = device_ops(events, window)
    start = np.array([max(e.start_ns(), w0) for e in ops], np.int64)
    end = np.array([min(e.end_ns(), w1) for e in ops], np.int64)
    busy = merged(zip(start.tolist(), end.tolist()))
    busy_ns = union_ns(start, end)
    at = innermost(spans, offset_ns)
    launched = launch_times(events, ops)
    roots = [i for i, s in enumerate(spans)
             if s.parent < 0 and w0 <= s.start_ns + offset_ns <= w1]
    units = {spans[i].unit for i in roots}
    # whether a span belongs to a traced unit; the last entry, read for the
    # index -1, is "no span"
    counted = np.array([s.unit in units for s in spans] + [False])
    owner = np.where(launched >= 0, at(launched), -1)
    owner = np.where(counted[owner], owner, -1)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gap_owner = at(np.array([(s + e) // 2 for s, e in gaps], np.int64))
    gap_owner = np.where(counted[gap_owner], gap_owner, -1)

    n = len(spans)
    # a span's device time is the union of its operations' intervals: cuDNN
    # runs some backward kernels on streams of its own, side by side
    dev_ns = np.zeros(n + 1)
    order = np.argsort(owner, kind="stable")
    cuts = np.flatnonzero(np.diff(owner[order])) + 1
    for group in np.split(order, cuts) if len(order) else []:
        dev_ns[owner[group[0]] + 1] = union_ns(start[group], end[group])
    launches = np.bincount(owner + 1, minlength=n + 1)
    idle_ns = np.bincount(gap_owner + 1, weights=[float(e - s) for s, e in gaps],
                          minlength=n + 1)
    child_ns = np.zeros(n + 1)
    for s in spans:
        child_ns[s.parent + 1] += s.end_ns - s.start_ns
    per = max(len(roots), 1)
    table: dict[str, dict] = {}
    whole = dict.fromkeys(("device_ms", "wall_ms", "cpu_ms", "launches", "idle_ms"), 0.0)
    for i, s in enumerate(spans):
        if not counted[i]:
            continue
        wall, cpu = s.end_ns - s.start_ns, s.cpu_end_ns - s.cpu_start_ns
        own = {"device_ms": dev_ns[i + 1], "wall_ms": wall, "self_wall_ms": wall - child_ns[i + 1],
               "cpu_ms": cpu, "launches": launches[i + 1], "idle_ms": idle_ns[i + 1]}
        row = table.setdefault(s.name, dict.fromkeys(own, 0.0))
        for k, v in own.items():
            row[k] += v / per if k == "launches" else v / 1e6 / per
        whole["launches"] += launches[i + 1] / per
        whole["idle_ms"] += idle_ns[i + 1] / 1e6 / per
        if s.parent < 0:
            whole["wall_ms"] += wall / 1e6 / per
            whole["cpu_ms"] += cpu / 1e6 / per
    inside_ns = union_ns(start[owner >= 0], end[owner >= 0])
    whole["device_ms"] = inside_ns / 1e6 / per
    covered = inside_ns / busy_ns if busy_ns else 0.0
    names = Counter(spans[i].name for i in roots)
    return {"units": len(roots), "top": names.most_common(1)[0][0] if names else None,
            "spans": table, "unit": whole, "covered": covered, "busy_ms": busy_ns / 1e6 / per,
            "outside_launches": int(launches[0]), "unmatched": int((launched < 0).sum()),
            "idle_gaps": name_gaps(events, spans, gaps, gap_owner, ops, start, end, top)}


def union_ns(start: np.ndarray, end: np.ndarray) -> int:
    """The length of the union of the intervals ``[start, end)``."""
    from perfbench.harness import merged
    return sum(e - s for s, e in merged(zip(start.tolist(), end.tolist())))


def name_gaps(events, spans, gaps, gap_owner, ops, start, end, top: int) -> list:
    """The ``top`` longest gaps as ``[name, seconds]``, named as
    ``harness.read_trace`` names them (the innermost host event running at
    the gap's middle, the operations either side) after the path of the span
    the host was in: ``z_step/pullback: host after … before …``, or
    ``outside: …``."""
    from perfbench.harness import WINDOW_SPAN
    host = [e for e in events if e.device_type() == DeviceType.CPU and e.name() != WINDOW_SPAN]
    h_start = np.array([e.start_ns() for e in host], np.int64)
    h_end = np.array([e.end_ns() for e in host], np.int64)
    out = []
    for k in sorted(range(len(gaps)), key=lambda k: gaps[k][0] - gaps[k][1])[:top]:
        s, e = gaps[k]
        mid = (s + e) // 2
        around = np.flatnonzero((h_start <= mid) & (h_end >= mid))
        name = "host"
        if around.size:
            name = host[around[np.argmin(h_end[around] - h_start[around])]].name()
        before, after = np.flatnonzero(end <= s), np.flatnonzero(start >= e)
        if before.size:
            name += " after " + ops[before[np.argmax(end[before])]].name()[:60]
        if after.size:
            name += " before " + ops[after[np.argmin(start[after])]].name()[:60]
        prefix = path(spans, int(gap_owner[k])) if gap_owner[k] >= 0 else "outside"
        out.append([f"{prefix}: {name}"[:160], (e - s) / 1e9])
    return out


def clock_offset(events, before_ns: int, after_ns: int) -> tuple[int, str]:
    """``(profiler clock - recorder clock, how)``, from the launch of the
    first marker kernel, which the recorder's clock read just before
    (``before_ns``) and just after (``after_ns``)."""
    from perfbench.harness import MARKER
    marks = sorted((e for e in events if e.device_type() == DeviceType.CUDA
                    and MARKER in e.name()), key=lambda e: e.start_ns())
    launch = launch_times(events, marks[:1])
    if not marks or launch[0] < 0:
        return 0, "the marker's launch is not on the trace: clocks taken as one"
    if before_ns <= launch[0] <= after_ns:
        return 0, f"one clock: the marker's launch lies {launch[0] - before_ns} ns into the " \
                  f"{after_ns - before_ns} ns the recorder read around it"
    offset = int(launch[0]) - (before_ns + after_ns) // 2
    return offset, f"two clocks: aligned by the marker's launch, offset {offset} ns"


def table_lines(table: dict, how: str) -> list[str]:
    """The span table as text, per traced unit."""
    cols = ("device_ms", "wall_ms", "self_wall_ms", "cpu_ms", "launches", "idle_ms")
    lines = [f"span table, per {table['top']} ({table['units']} traced): clock: {how}",
             f"{'span':<20}" + "".join(f"{c:>14}" for c in cols)]
    for name, row in table["spans"].items():
        lines.append(f"{name:<20}" + "".join(f"{row[c]:>14.3f}" for c in cols))
    whole = table["unit"]
    lines.append(f"{'(whole unit)':<20}" + "".join(
        f"{whole[c]:>14.3f}" if c in whole else f"{'':>14}" for c in cols))
    busy_ms = table["busy_ms"]
    phases = sum(row["device_ms"] for row in table["spans"].values())
    lines.append(f"device busy per unit {busy_ms:.3f} ms; the spans' device ms sum to "
                 f"{phases:.3f} ({100 * phases / busy_ms if busy_ms else 0:.2f}% of it); "
                 f"busy time launched inside a unit {100 * table['covered']:.2f}%; launches "
                 f"outside every unit {table['outside_launches']}, with no launch on the trace "
                 f"{table['unmatched']}")
    return lines


# ---------------------------------------------------------------------------
# the traced window with the spans recorded, and the readers
# ---------------------------------------------------------------------------

def traced_window(session, seconds: float, cuda: bool) -> tuple[dict, dict]:
    """``harness.traced_window`` with the program's span recorder on around
    the window; on a CUDA device the result adds ``phases`` (``attribute``'s
    table) and its idle gaps are named by span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from laplace_inducing_points_tpu_torch.utils.profiling import recording
    from perfbench import harness
    if not cuda:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(harness.WINDOW_SPAN):
                out = session.window(seconds)
        events = prof.profiler.kineto_results.events()
        return out, {**harness.read_trace(events, harness.window_ends(events, False)),
                     "phases": None}
    with profile(activities=[ProfilerActivity.CUDA]) as prof, recording() as spans:
        before = time.time_ns()
        torch.cuda._sleep(1000)
        after = time.time_ns()
        out = session.window(seconds)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    window = harness.window_ends(events, True)
    traced = harness.read_trace(events, window)
    offset, how = clock_offset(events, before, after)
    table = attribute(events, spans, window, offset)
    traced["idle_gaps"] = table.pop("idle_gaps")
    traced["phases"] = table
    print("\n".join(table_lines(table, how)), file=sys.stderr, flush=True)
    return out, traced


def _table(ctx: dict, kind: str):
    table = ctx.get("phases")
    if ctx["kind"] != kind or not table or not table["units"] or table["top"] != TOP[kind]:
        return None
    return table


def phase_ms(ctx: dict, kind: str, name: str):
    """Device ms per unit of the operations that spans ``name`` launched."""
    table = _table(ctx, kind)
    if table is None or name not in table["spans"]:
        return None
    return table["spans"][name]["device_ms"]


def host_cpu_ms(ctx: dict, kind: str):
    """Process CPU ms per unit (all threads)."""
    table = _table(ctx, kind)
    return None if table is None else table["unit"]["cpu_ms"]


def launches(ctx: dict, kind: str):
    """Device operations launched per unit."""
    table = _table(ctx, kind)
    return None if table is None else table["unit"]["launches"]


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def with_phase_metrics(manifest: dict) -> dict:
    """The manifest with ``PHASE_METRICS`` after its own per-layer metrics."""
    have = {m["name"] for m in manifest["per_layer"]}
    return {**manifest, "per_layer": manifest["per_layer"]
            + [m for m in PHASE_METRICS if m["name"] not in have]}


def recording_cost(run, seconds: float, pairs: int) -> dict:
    """Time per unit of ``pairs`` pairs of windows with the span recorder on
    and off, in alternating order, after one set-up; no profiler."""
    from laplace_inducing_points_tpu_torch.utils.profiling import recording
    session = run.driver.Session(run)
    ms = {"on": [], "off": []}
    spans_per_unit = 0.0
    for p in range(pairs):
        for on in ((True, False) if p % 2 == 0 else (False, True)):
            if on:
                with recording() as spans:
                    out = session.window(seconds)
                spans_per_unit = len(spans) / out["units"]
            else:
                out = session.window(seconds)
            ms["on" if on else "off"].append(out["elapsed_s"] * 1e3 / out["units"])
    on, off = statistics.median(ms["on"]), statistics.median(ms["off"])
    return {"cell": run.cell, "seed": run.seed, "seconds": seconds, "ms_on": ms["on"],
            "ms_off": ms["off"], "median_on": on, "median_off": off,
            "cost_pct": 100.0 * (on / off - 1.0), "spans_per_unit": spans_per_unit}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell with its phase spans recorded.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--cost", type=int, default=0,
                   help="measure the recorder's cost in this many pairs of windows instead")
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    from perfbench import harness
    args = parse(argv)
    m = harness.manifest(harness.BENCH)
    cells = {w["name"]: w for w in m["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}: one of {sorted(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(device)}; nvidia-smi: {harness.nvidia_smi()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    run = harness.Run(args.workload, args.seed, device)
    if args.cost:
        print(json.dumps(recording_cost(run, args.seconds, args.cost)), flush=True)
        return 0
    harness.traced_window = traced_window
    result = harness.execute(run, args.seconds, True, t_start, chips, with_phase_metrics(m))
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from perfbench import run as _run   # run.py's environment: compiler caches, one host thread
    sys.exit(main(sys.argv[1:], _run.T_START))
