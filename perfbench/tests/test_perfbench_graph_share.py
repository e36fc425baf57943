"""The reader of ``graph_share.ztrain`` on the CPU: what it reads from the
program's counters, where it finds nothing, and that a tiny traced run's
line carries it (0%: the CPU replays no graph)."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness

from perfbench_tiny import ROOT, TINY


def _read():
    return harness.load_module(ROOT / "perfbench" / "metrics" / "graph_share.ztrain.py").read


def test_graph_share_reads_the_steps_that_replayed(monkeypatch):
    from laplace_inducing_points_tpu_torch.training.inducing import optimize_step
    read = _read()
    monkeypatch.setattr(optimize_step, "calls", 200)
    monkeypatch.setattr(optimize_step, "graph_replays", 198)
    assert read({"kind": "ztrain"}) == pytest.approx(99.0)
    assert read({"kind": "serve"}) is None
    monkeypatch.setattr(optimize_step, "calls", 0)
    assert read({"kind": "ztrain"}) is None


def test_graph_share_finds_nothing_in_a_program_without_the_counters(monkeypatch):
    """A program that keeps no graph counters (the parent of the change that
    added them) gives no reading and no error."""
    from laplace_inducing_points_tpu_torch.training import inducing

    def step(*args, **kwargs):
        raise AssertionError("not called")

    monkeypatch.setattr(inducing, "optimize_step", step)
    assert _read()({"kind": "ztrain"}) is None


def test_a_tiny_traced_run_reports_graph_share():
    cell = "lenet5_mnist.ztrain_gram"
    run = harness.Run(cell, 5, torch.device("cpu"), config_overrides=TINY[cell])
    result = harness.execute(run, 0.3, True, time.perf_counter())
    assert result["metrics"]["graph_share.ztrain"] == {"value": 0.0, "unit": "%"}
