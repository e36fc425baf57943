"""What the per-layer metrics of ``metrics/`` read from a traced run's
context: ``kind`` (the traffic driver), ``units`` and ``elapsed_s`` (steps
or requests completed in the untraced window before the trace, and its
length), ``traced_units``, ``window_s`` and ``busy_s`` (steps or requests in
the traced window, its length and the device's busy time in it),
``flops_per_unit`` (``work.py``) and ``kernels`` (the port's public kernels
timed by CUDA events at the cell's shapes after the window, each with its
bound from ``work.py``). Each returns ``None`` where the run has nothing for
it to read."""

from __future__ import annotations

from perfbench import work


def mfu(ctx: dict, kind: str):
    """The whole step's (or batch's) share of the TF32 peak: its operations
    over its time in the untraced window, in %."""
    if ctx["kind"] != kind or not ctx["units"]:
        return None
    return 100.0 * ctx["flops_per_unit"] * ctx["units"] / (ctx["elapsed_s"] * work.PEAK_FLOPS)


def kernel_roofline(ctx: dict, kind: str):
    """The kernels' summed bound over their summed CUDA-event time, in %."""
    if ctx["kind"] != kind or not ctx["kernels"]:
        return None
    return 100.0 * (sum(k["bound_ms"] for k in ctx["kernels"])
                    / sum(k["ms"] for k in ctx["kernels"]))


def device_idle(ctx: dict, kind: str):
    """The share of an untraced step (or request) in which the device ran
    nothing, in %: one less the device's busy time per unit in the trace over
    the untraced window's time per unit. The trace's own window is longer
    than an untraced one by what tracing costs the host (a quarter at
    ResNet1M's many small launches), and the device's work is not."""
    if ctx["kind"] != kind or not ctx["units"] or not ctx["traced_units"]:
        return None
    busy_per_unit = ctx["busy_s"] / ctx["traced_units"]
    return 100.0 * (1.0 - busy_per_unit * ctx["units"] / ctx["elapsed_s"])
