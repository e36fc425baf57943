"""The benchmark's runner: finds a cell's files by name, times its window,
reads its trace, runs its check against the plain reference and prints the
one result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name in
``BENCHMARK.json``:

- the cell's entry in ``BENCHMARK.json``: its configuration and traffic mix
  (and its ``why``), read from there alone;
- ``workloads/<cell>.json``: the limits of the numbers that decide
  ``correct``;
- ``configs/<config>.json``: the sizes, and the network (``net``) whose
  plain reference is ``reference/<net>.py``;
- ``traffic/<mix>.json``: the mix's parameters, and the driver
  (``traffic/<driver>.py``) that generates it;
- ``metrics/<metric>.py``: a reader with ``read(ctx)`` of one per-layer
  metric (``None`` where it finds nothing to read).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType

import numpy as np
import torch
from torch.autograd import DeviceType

from perfbench import work

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "laplace_inducing_points_tpu")
WINDOW_SPAN = "perfbench.window"
# torch.cuda._sleep's kernel: one before and one after a traced window mark
# its ends on the device's own clock
MARKER = "spin_kernel"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark, loaded by its path (names may hold
    dots: ``metrics/mfu.ztrain.py``)."""
    name = "perfbench._loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Run:
    """One run of one cell: its files, its seed and its device."""

    def __init__(self, cell: str, seed: int, device: torch.device, bench: Path = BENCH,
                 config_overrides: dict | None = None):
        self.cell, self.seed, self.device, self.bench = cell, int(seed), device, bench
        entries = {w["name"]: w for w in manifest(bench)["workloads"]}
        if cell not in entries:
            raise KeyError(f"unknown workload {cell!r}: one of {sorted(entries)}")
        self.entry = entries[cell]
        self.config = load_json(bench / "configs" / f"{self.entry['config']}.json")
        self.config.update(config_overrides or {})
        self.mix = load_json(bench / "traffic" / f"{self.entry['traffic']}.json")
        self.driver = load_module(bench / "traffic" / f"{self.mix['driver']}.py")
        self.net = load_module(bench / "reference" / f"{self.config['net']}.py")
        self.limits = load_json(bench / "workloads" / f"{cell}.json")["limits"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# ---------------------------------------------------------------------------
# timing and the trace
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def read_trace(events, window: tuple[int, int], top: int = 10) -> dict:
    """From a ``torch.profiler`` run's raw events (``prof.events()`` builds a
    tree of them, minutes for a window of ResNet1M steps) and the window's
    ends in ns: the window's length, the seconds in which the device ran an
    operation (the union of its kernel, copy and set intervals inside the
    window), the device operations with the most time, and the longest idle
    gaps, each named by the innermost host event that was running at its
    middle (in a trace of the device alone, a CUDA runtime call or "host")
    and the device operations on either side of it."""
    w0, w1 = window
    device = [e for e in events if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation() and MARKER not in e.name()]
    busy = merged((max(e.start_ns(), w0), min(e.end_ns(), w1)) for e in device
                  if e.end_ns() > w0 and e.start_ns() < w1)
    by_name: dict[str, float] = {}
    for e in device:
        if e.end_ns() > w0 and e.start_ns() < w1:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns()
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    host = [e for e in events if e.device_type() == DeviceType.CPU
            and e.name() != WINDOW_SPAN]
    starts = np.array([e.start_ns() for e in host], dtype=np.int64)
    ends = np.array([e.end_ns() for e in host], dtype=np.int64)
    d_starts = np.array([e.start_ns() for e in device], dtype=np.int64)
    d_ends = np.array([e.end_ns() for e in device], dtype=np.int64)
    idle = []
    for length, s, e in gaps[:top]:
        mid = (s + e) // 2
        around = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = "host"
        if around.size:
            name = host[around[np.argmin(ends[around] - starts[around])]].name()
        before, after = np.flatnonzero(d_ends <= s), np.flatnonzero(d_starts >= e)
        if before.size:
            name += " after " + device[before[np.argmax(d_ends[before])]].name()[:60]
        if after.size:
            name += " before " + device[after[np.argmin(d_starts[after])]].name()[:60]
        idle.append([name[:160], length / 1e9])
    return {"window_s": (w1 - w0) / 1e9, "busy_s": sum(e - s for s, e in busy) / 1e9,
            "device_ops": [[n[:160], ns / 1e9] for n, ns in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": idle}


def window_ends(events, cuda: bool) -> tuple[int, int]:
    """The traced window's ends in ns: on a CUDA device, from the end of the
    opening marker kernel to the start of the closing one; elsewhere, the
    ``perfbench.window`` span."""
    if cuda:
        marks = sorted((e.start_ns(), e.end_ns()) for e in events
                       if e.device_type() == DeviceType.CUDA and MARKER in e.name())
        if len(marks) != 2:
            raise RuntimeError(f"the trace holds {len(marks)} marker kernels, not two")
        return marks[0][1], marks[1][0]
    spans = [e for e in events if e.name() == WINDOW_SPAN and e.device_type() == DeviceType.CPU]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} window spans, not one")
    return spans[0].start_ns(), spans[0].end_ns()


def traced_window(session, seconds: float, cuda: bool) -> tuple[dict, dict]:
    """The window under ``torch.profiler``. On a CUDA device it records the
    device's activity alone (kernels, copies, runtime calls), not every host
    operation, whose recording would stretch a host-paced step two-fold."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if cuda:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            out = session.window(seconds)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(WINDOW_SPAN):
                out = session.window(seconds)
    events = prof.profiler.kineto_results.events()
    return out, read_trace(events, window_ends(events, cuda))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unavailable"


def loaded_forbidden() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name is JAX's, Flax's,
    optax's or the JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def manifest(bench: Path) -> dict:
    return load_json(bench.parent / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def check_lines(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(every number finite and within its limit, {name: {value, limit}})``."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        ok = ok and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit}
    return ok, out


def execute(run: Run, seconds: float, trace: bool, t_start: float, chips: int = 1,
            bench_manifest: dict | None = None) -> dict:
    """Set-up, the window (traced or not), the check; the result line's
    object. Runs on whatever device ``run`` names."""
    session = run.driver.Session(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    cuda = run.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    out, traced = session.window(seconds), None
    attempted, failed = out["attempted"], out["failed"]
    if trace:
        # the rates come from the untraced window; the trace only reads the
        # device's busy time and what filled it
        traced_out, traced = traced_window(session, min(run.mix["trace_seconds"], seconds), cuda)
        attempted, failed = attempted + traced_out["attempted"], failed + traced_out["failed"]
        print(f"untraced window: {out['units']} in {out['elapsed_s']:.3f} s; traced window: "
              f"{traced_out['units']} in {traced_out['elapsed_s']:.3f} s", file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    ctx = None
    if trace:
        ctx = {"kind": run.mix["driver"], "cell": run.cell, "units": out["units"],
               "elapsed_s": out["elapsed_s"], "traced_units": traced_out["units"],
               "flops_per_unit": session.flops_per_unit(),
               "kernels": [], **traced}
        if cuda:
            for name, fn, work in session.kernel_calls():
                ctx["kernels"].append({"name": name, "ms": cuda_ms(fn),
                                       "bound_ms": work.bound_s() * 1e3})
    session.free()
    try:
        numbers = session.check()
    except torch.linalg.LinAlgError as err:     # the reference cannot follow the program
        print(f"the check failed: {err}", file=sys.stderr)
        numbers = {name: math.nan for name in run.limits}
    ok, check = check_lines(numbers, run.limits)
    m = bench_manifest if bench_manifest is not None else manifest(run.bench)
    metrics = {}
    if trace:
        for spec in m["per_layer"]:
            if _applies(spec, run.cell):
                value = load_module(run.bench / "metrics" / f"{spec['name']}.py").read(ctx)
                if value is not None:
                    metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        measured = {**out["metrics"], "setup_s": setup_s, "peak_gib": window_peak / 2**30}
        for spec in m["end_to_end"]:
            if _applies(spec, run.cell):
                metrics[spec["name"]] = {"value": measured[spec["name"]], "unit": spec["unit"]}
    device = {"platform": "gpu" if cuda else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": chips, "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"correct": ok and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"], device["window_s"] = traced["busy_s"], traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["check"] = check
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    m = manifest(BENCH)
    cells = {w["name"]: w for w in m["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}: one of {sorted(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the benchmark needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(device)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {nvidia_smi()}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"peaks: {work.PEAK_FLOPS:g} FLOP/s (TF32), {work.PEAK_BYTES:g} B/s", flush=True)
    run = Run(args.workload, args.seed, device)
    result = execute(run, args.seconds, bool(args.trace), t_start, chips, m)
    bad = loaded_forbidden()
    if bad:
        print(f"the process holds modules it must not: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
