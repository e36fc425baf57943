#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the process
exits non-zero without printing a result:

1. environment: requires CUDA, prints torch/CUDA versions and the card's
   ``nvidia-smi`` name and power limit, sets the f32 policy (TF32 off);
2. build: compiles the CUDA kernels from ``laplace_inducing_points_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version and against a
   float64 product, at the serving path's shapes and one small ragged shape,
   with CUDA-event times;
4. main path: writes a seeded LeNet5 MAP file and an inducing set, runs
   ``laplace_inducing_points_tpu_torch.cli.evaluate.main`` for
   ``configs/scale/lenet5_mnist.yml`` (M=100, S=200, batch 256) and checks
   that every kernel was launched and the metrics are finite;
5. agreement: one batch's logit samples and the Gram through the kernels
   against the same computation through the plain versions and through a
   float64 evaluation of the sample contractions; warm timings of the
   factor build and of one batch, broken down.

The line before the last is the card's ``nvidia-smi`` line; the one before
it is the per-kernel JSON; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SEED = 20261016
REL_TOL = 1e-4          # kernel vs plain, relative Frobenius
F64_RATIO = 2.0         # kernel's f64 error may be at most this times the plain's


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_environment() -> str:
    print("== phase 1: environment", flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    print(set_f32_policy())
    return smi


def phase_build() -> float:
    print("== phase 2: build", flush=True)
    from laplace_inducing_points_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    _build.load_library()
    seconds = time.perf_counter() - t0
    path = _build.library_path()
    print(f"built {path.name} from {len(_build.sources())} sources in "
          f"{seconds:.2f} s")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    return seconds


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


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.norm((x.double() - ref.double()).ravel())
                 / torch.linalg.norm(ref.double().ravel()))


def _check_kernel(name, kernel, plain, inputs, timed: bool) -> dict:
    out_k = kernel(*inputs)
    out_p = plain(*inputs)
    out_64 = plain(*(t.double() for t in inputs))
    torch.cuda.synchronize()
    rel_kp = _rel(out_k, out_p)
    err_k = _rel(out_k, out_64)
    err_p = _rel(out_p, out_64)
    max_abs = float((out_k - out_p).abs().max())
    shape = " x ".join(str(tuple(t.shape)) for t in inputs)
    row = {"rel_vs_plain": rel_kp, "rel_vs_f64": err_k, "plain_rel_vs_f64": err_p,
           "max_abs_err": max_abs}
    if timed:
        row["ms"] = cuda_ms(lambda: kernel(*inputs))
        row["plain_ms"] = cuda_ms(lambda: plain(*inputs))
    print(f"  {name:9s} {shape:28s} rel_vs_plain={rel_kp:.3e} "
          f"rel_vs_f64={err_k:.3e} plain_rel_vs_f64={err_p:.3e} "
          f"max_abs_err={max_abs:.3e}"
          + (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f}" if timed else ""),
          flush=True)
    if not (rel_kp <= REL_TOL):
        raise AssertionError(f"{name} {shape}: kernel vs plain {rel_kp:.3e} > {REL_TOL}")
    if not (err_k <= F64_RATIO * err_p):
        raise AssertionError(f"{name} {shape}: f64 error {err_k:.3e} > "
                             f"{F64_RATIO} x plain's {err_p:.3e}")
    return row


def phase_kernels() -> dict:
    """Each kernel against its plain version and f64 at the serving shapes
    (M=100, K=10 -> d=1000; D=61706; S=200) and a small ragged shape."""
    print("== phase 3: kernels against their plain versions", flush=True)
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                                   matmul_nn_plain,
                                                                   matmul_nt,
                                                                   matmul_nt_plain)
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    d, D, S = 1000, 61706, 200
    cases = {
        "syrk": (syrk, syrk_plain, [(randn(d, D),), (randn(77, 301),)]),
        "matmul_nt": (matmul_nt, matmul_nt_plain,
                      [(randn(S, D), randn(d, D)), (randn(13, 333), randn(70, 333))]),
        "matmul_nn": (matmul_nn, matmul_nn_plain,
                      [(randn(S, d), randn(d, D)), (randn(13, 45), randn(45, 1001))]),
    }
    results = {}
    for name, (kernel, plain, shapes) in cases.items():
        for i, inputs in enumerate(shapes):
            row = _check_kernel(name, kernel, plain, inputs, timed=(i == 0))
            if i == 0:
                results[name] = row
    C = syrk(randn(d, D))
    if not torch.equal(C, C.T):
        raise AssertionError("syrk output is not exactly symmetric")
    print("  syrk output exactly symmetric: True")
    return results


CONFIG = "configs/scale/lenet5_mnist.yml"
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "syrk": ("laplace_inducing_points_tpu_torch/csrc/syrk.cu",
             "laplace_inducing_points_tpu/ops/pallas/syrk.py:71"),
    "matmul_nt": ("laplace_inducing_points_tpu_torch/csrc/matmul.cu",
                  "laplace_inducing_points_tpu/ops/pallas/matmul.py:68"),
    "matmul_nn": ("laplace_inducing_points_tpu_torch/csrc/matmul.cu",
                  "laplace_inducing_points_tpu/ops/pallas/matmul.py:153"),
}


def _wrappers() -> dict:
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
    return {"syrk": syrk, "matmul_nt": matmul_nt, "matmul_nn": matmul_nn}


def _write_inputs(workdir: Path, cfg: dict) -> None:
    """A seeded LeNet5 MAP file (numpy lecun-normal init in the JAX layout,
    through the weight converter) and Z = the first M training inputs."""
    from laplace_inducing_points_tpu_torch.core.params import (FlatSpec,
                                                               lecun_normal_params,
                                                               params_from_jax)
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    from laplace_inducing_points_tpu_torch.models.scale import LeNet5
    from laplace_inducing_points_tpu_torch.utils.checkpoint import save_array, save_params
    tree = lecun_normal_params(FlatSpec.from_module(LeNet5()), cfg["model"]["seed"])
    flat, spec = params_from_jax(tree)
    save_params(flat, spec, str(workdir / "map"), "map_mnist")
    ip = cfg["optimization"]["ip"]
    x_train, _ = load_arrays("mnist", train=True, root=str(workdir / "data"))
    save_array(x_train[:ip["m"]], str(workdir / "ind"), "ind_mnist", ip["epochs"])


def _main_path_argv(workdir: Path) -> list[str]:
    return ["--dataset", "mnist", "--config", CONFIG, "--scalable",
            "--predictive", "weight", "--iters", "2", "--max_batches", "2",
            "--device", "cuda", "--ckpt_map", str(workdir / "map"),
            "--ckpt_induc", str(workdir / "ind"), "--data_dir", str(workdir / "data")]


def phase_main_path(workdir: Path) -> tuple[dict, list]:
    """The port's evaluation entry point on LeNet5 at full width."""
    print("== phase 4: main path (cli.evaluate.main, LeNet5 / lenet5_mnist.yml)",
          flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    cfg = load_experiment_config(CONFIG)
    _write_inputs(workdir, cfg)
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    records = evaluate.main(_main_path_argv(workdir))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"launches during the main path: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    for rec in records:
        for key in ("nll", "acc", "brier", "ece"):
            if not math.isfinite(rec[key]):
                raise AssertionError(f"iteration {rec['iter']}: {key}={rec[key]}")
        print(f"iteration {rec['iter']}: factor build {rec['factor_s']:.3f} s, "
              f"{rec['batches']} batches of {cfg['optimization']['map']['batch_size']} "
              f"with S={rec['mc']} in {rec['wallclock_s']:.3f} s "
              f"({rec['per_batch_s']:.3f} s per batch); nll={rec['nll']:.5f} "
              f"acc={rec['acc']:.5f} brier={rec['brier']:.5f} ece={rec['ece']:.5f}")
    return launches, records


def _host_s(fn):
    """``(result, seconds)`` of ``fn()`` on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_agreement(workdir: Path) -> None:
    """One batch (B=256) and one fixed eps (S=200): the predictor's logit
    samples through the kernels, through the plain versions, and through a
    float64 evaluation of the same contractions (same R, V, g and jvp).

    The sample correction cancels the prior draw along high-curvature
    directions, so a contraction's f32 round-off re-enters the logits
    amplified; the float64 evaluation measures how far each f32 path is from
    the exact contractions. The kernel path must be within 1e-3 relative
    Frobenius of it and no further from it than twice the plain path is.
    """
    print("== phase 5: agreement of the kernel path with the plain path", flush=True)
    from torch.func import vmap

    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    from laplace_inducing_points_tpu_torch.inference.lla import (
        ScalableLLAPredictor, amortized_logit_samples_from_noise)
    from laplace_inducing_points_tpu_torch.inference.sample import _g_weights
    from laplace_inducing_points_tpu_torch.models.scale import LeNet5
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                                   matmul_nn_plain,
                                                                   matmul_nt,
                                                                   matmul_nt_plain)
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_array, load_params
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    cfg = load_experiment_config(CONFIG)
    opt, ip = cfg["optimization"], cfg["optimization"]["ip"]
    flat, _, _ = load_params(str(workdir / "map"), "map_mnist")
    state = ModelState(LeNet5().cuda(), flat.cuda(), "classifier")
    Z = torch.as_tensor(load_array(str(workdir / "ind"), "ind_mnist", ip["epochs"])).cuda()
    x_test, _ = load_arrays("mnist", train=False, root=str(workdir / "data"))
    x = torch.as_tensor(x_test[:opt["map"]["batch_size"]]).cuda()
    alpha, range_clip, rank_tol = opt["alpha"], 1.0, 1e-7

    def weights(eps, R, V, g, nt, nn):
        return eps / math.sqrt(alpha) + nn(((nt(eps, R) @ V) * g) @ V.T, R)

    with torch.no_grad():
        pred, build_s = _host_s(lambda: ScalableLLAPredictor(
            state, Z, full_set_size=opt["full_set_size"], range_clip_min=range_clip))
        R, V = pred.R, pred.V
        _, rows_s = _host_s(lambda: ops.dense_wt(state, Z))
        _, gram_s = _host_s(lambda: syrk(R))
        _, eigh_s = _host_s(lambda: torch.linalg.eigh(ops.ensure_symmetry(pred.gram, 0.0)))
        print(f"factor build, warm: {build_s:.3f} s (rows {rows_s:.3f} s, "
              f"syrk {gram_s:.4f} s, eigh {eigh_s:.3f} s)")
        gram_rel = _rel(pred.gram, syrk_plain(R))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        eps = torch.randn(ip["mc_samples"], R.shape[1], generator=gen, device="cuda")
        kernel_out, batch_s = _host_s(lambda: amortized_logit_samples_from_noise(
            state, R, pred.lam, V, alpha, pred.beta, x, eps, rank_tol, range_clip))
        g = _g_weights(pred.lam, alpha, pred.beta, rank_tol, range_clip)
        lin = ops.linearize_model(state, x)
        push = vmap(lin.jvp)
        w_kernel, contract_s = _host_s(lambda: weights(eps, R, V, g, matmul_nt, matmul_nn))
        _, push_s = _host_s(lambda: push(w_kernel))
        print(f"one batch, warm: {batch_s:.4f} s (sample contractions {contract_s:.4f} s, "
              f"jvp push-forward {push_s:.4f} s)")
        plain_out = lin.f0[None] + push(weights(eps, R, V, g, matmul_nt_plain,
                                                matmul_nn_plain))
        w64 = weights(eps.double(), R.double(), V.double(), g.double(),
                      matmul_nt_plain, matmul_nn_plain)
        ref_out = lin.f0[None] + push(w64.float())
    torch.cuda.synchronize()
    rel_kp = _rel(kernel_out, plain_out)
    rel_k = _rel(kernel_out, ref_out)
    rel_p = _rel(plain_out, ref_out)
    close_kp = torch.allclose(kernel_out, plain_out, rtol=1e-3, atol=1e-4)
    close_k = torch.allclose(kernel_out, ref_out, rtol=1e-3, atol=1e-4)
    print(f"gram: kernel vs plain relative Frobenius {gram_rel:.3e}")
    print(f"logit samples {tuple(kernel_out.shape)}, |logit| max "
          f"{float(ref_out.abs().max()):.3e}:")
    print(f"  kernel vs plain: relative Frobenius {rel_kp:.3e}, max_abs_diff "
          f"{float((kernel_out - plain_out).abs().max()):.3e}, "
          f"allclose(rtol=1e-3, atol=1e-4)={close_kp}")
    print(f"  vs float64 contractions: kernel {rel_k:.3e} (max_abs_diff "
          f"{float((kernel_out - ref_out).abs().max()):.3e}, "
          f"allclose(rtol=1e-3, atol=1e-4)={close_k}), plain {rel_p:.3e} (max_abs_diff "
          f"{float((plain_out - ref_out).abs().max()):.3e})")
    if not torch.isfinite(kernel_out).all():
        raise AssertionError("kernel-path logit samples are not finite")
    if gram_rel > REL_TOL:
        raise AssertionError(f"gram: kernel vs plain {gram_rel:.3e} > {REL_TOL}")
    if not (rel_k <= 1e-3 and rel_k <= F64_RATIO * rel_p):
        raise AssertionError(f"kernel-path logit samples are {rel_k:.3e} from the "
                             f"float64 contractions (plain path: {rel_p:.3e})")


def main() -> int:
    smi = phase_environment()
    phase_build()
    kernel_rows = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = phase_main_path(Path(tmp))
        phase_agreement(Path(tmp))
    table = [{"name": name, "route": "cuda", "source": KERNELS[name][0],
              "replaces": KERNELS[name][1], "launches": launches[name],
              "max_abs_err": kernel_rows[name]["max_abs_err"],
              "ms": kernel_rows[name]["ms"], "plain_ms": kernel_rows[name]["plain_ms"]}
             for name in KERNELS]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
