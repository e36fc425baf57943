"""The harness on the CPU at tiny sizes: what it loads, how it finds a cell's
files by name, that it refuses to run without a card, and that ``correct``
comes out false when the timed path underneath is broken."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from perfbench import calibrate, harness

from perfbench_tiny import ROOT, TINY

CPU = torch.device("cpu")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "laplace_inducing_points_tpu"}


def _execute(cell: str, seed: int = 5, trace: bool = False, seconds: float = 0.3) -> dict:
    run = harness.Run(cell, seed, CPU, config_overrides=TINY[cell])
    return harness.execute(run, seconds, trace, time.perf_counter())


def _python(code: str, root=ROOT) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter from ``root``, the program's package
    importable from the repository."""
    env = {**os.environ, "PYTHONPATH": f"{root}{os.pathsep}{ROOT}"}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                          text=True, env=env, timeout=600, cwd=str(root))


def _top_levels(stdout: str) -> set:
    return set(json.loads(stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = _python(f"""
        import json, sys, time, torch
        from perfbench import harness
        for cell, cfg in {TINY!r}.items():
            run = harness.Run(cell, 3, torch.device("cpu"), config_overrides=cfg)
            harness.execute(run, 0.1, True, time.perf_counter())
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = _top_levels(out.stdout)
    assert "laplace_inducing_points_tpu_torch" in loaded and "perfbench" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    out = _python("""
        import json, sys, torch
        from perfbench.reference import lenet5, lla, resnet1m
        from perfbench import inputs
        cpu = torch.device("cpu")
        flat = inputs.weights(lenet5, 1, cpu).double()
        z = inputs.images(2, lenet5.INPUT_SHAPE, 10, 1, inputs.IMAGES, cpu).double()
        lla.kl_value_and_grad(lenet5, flat, {}, z, z, 0.005, 100)
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert not _top_levels(out.stdout) & (FORBIDDEN | {"laplace_inducing_points_tpu_torch"})


def test_run_py_without_a_card_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "lenet5_mnist.ztrain_gram", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "{" not in out.stdout


def test_a_new_cell_config_and_metric_are_found_as_files(tmp_path):
    """Copy the benchmark, drop in a configuration, a cell and a per-layer
    metric as new files (and their entries in the manifest), edit no file that
    is there, and run the new cell traced."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = tmp_path / "perfbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    config = json.loads((bench / "configs" / "lenet5_mnist.json").read_text())
    config.update(name="lenet5_wide_batch", **TINY["lenet5_mnist.ztrain_gram"])
    (bench / "configs" / "lenet5_wide_batch.json").write_text(json.dumps(config))
    limits = (bench / "workloads" / "lenet5_mnist.ztrain_gram.json").read_text()
    (bench / "workloads" / "lenet5_wide_batch.ztrain_gram.json").write_text(limits)
    (bench / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['units']) if ctx['kind'] == 'ztrain' else None\n")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "lenet5_wide_batch.ztrain_gram", "chips": 1,
                                  "config": "lenet5_wide_batch", "traffic": "ztrain_gram",
                                  "why": "a new cell"})
    for metric in manifest["per_layer"]:
        if metric["name"] == "mfu.ztrain":
            metric["workloads"].append("lenet5_wide_batch.ztrain_gram")
    manifest["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "whole Z step",
                                  "moves": "z_step_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = _python("""
        import json, time, torch
        from perfbench import harness
        run = harness.Run("lenet5_wide_batch.ztrain_gram", 4, torch.device("cpu"))
        print(json.dumps(harness.execute(run, 0.1, True, time.perf_counter())))
    """, root=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["steps_traced"]["value"] >= 1
    assert "mfu.ztrain" in result["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_sound_run_is_correct_and_prints_its_checks_last():
    for cell in TINY:
        result = _execute(cell)
        assert result["correct"] and result["failed"] == 0, result
        assert list(result)[-1] == "check"
        assert set(result["check"]) == set(json.loads(
            (ROOT / "perfbench" / "workloads" / f"{cell}.json").read_text())["limits"])


def _unchanged(inducing):
    step = inducing.optimize_step

    def broken(Z, X, state, alpha, optimizer, **kwargs):
        saved = Z.detach().clone()
        loss = step(Z, X, state, alpha, optimizer, **kwargs)
        with torch.no_grad():
            Z.copy_(saved)
        return loss
    return broken


def _half_batch(inducing):
    return calibrate.half_batch(inducing)[1]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    from laplace_inducing_points_tpu_torch.training import inducing
    monkeypatch.setattr(inducing, "optimize_step", fault(inducing))
    assert not _execute("lenet5_mnist.ztrain_gram")["correct"]


def test_a_fault_that_starts_inside_the_window_is_not_correct(monkeypatch):
    """A gradient of the right size in the wrong direction, from the first
    step after set-up's on: the first steps' numbers pass, the window's
    last step does not."""
    from laplace_inducing_points_tpu_torch.training import inducing
    value_and_grad, calls = inducing.kl_value_and_grad_gram, []

    def turned(*args, **kwargs):
        loss, grad = value_and_grad(*args, **kwargs)
        calls.append(1)
        return loss, (-grad if len(calls) > 3 else grad)
    monkeypatch.setattr(inducing, "kl_value_and_grad_gram", turned)
    result = _execute("lenet5_mnist.ztrain_gram")
    check = {k: c["value"] <= c["limit"] for k, c in result["check"].items()}
    assert len(calls) > 4 and not result["correct"]
    assert check["loss_gap"] and check["grad_norm_gap"] and check["change_norm_gap"]
    assert not check["window_grad_gap"] and not check["window_step_gap"]


def test_a_cell_is_read_from_the_manifest_alone():
    """A cell's configuration and traffic come from its entry in
    ``BENCHMARK.json``; its file under ``workloads/`` holds the limits
    alone."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in manifest["workloads"]:
        cell = json.loads((ROOT / "perfbench" / "workloads" / f"{entry['name']}.json").read_text())
        assert list(cell) == ["limits"]
        run = harness.Run(entry["name"], 1, CPU)
        assert run.config["name"] == entry["config"] and run.entry is not None
        assert run.mix == json.loads(
            (ROOT / "perfbench" / "traffic" / f"{entry['traffic']}.json").read_text())


def test_an_altered_answer_is_not_correct(monkeypatch):
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
    serve = ScalableLLAPredictor.logit_samples

    def altered(self, x, *args, **kwargs):
        out = serve(self, x, *args, **kwargs)
        out[:, -1] = serve(self, x.flip(0), *args, **kwargs)[:, 0]   # one image's answer
        return out
    monkeypatch.setattr(ScalableLLAPredictor, "logit_samples", altered)
    assert not _execute("lenet5_mnist.serve_weight")["correct"]
