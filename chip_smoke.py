#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA GPU.

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
   factor build and of one batch, broken down;
6. backward kernels: each kernel's ``torch.autograd.Function`` gradients
   against plain autograd and a float64 evaluation, at the training shapes
   (Gzz = syrk(Rz), Gxz = Rx Rzᵀ) and a small ragged shape, with CUDA-event
   times of the backward passes;
7. training path: ``laplace_inducing_points_tpu_torch.cli.train_scale.main``
   in ``full_pipeline`` mode on LeNet5 at full width (M=100, batch 128,
   D=61,706; only the step counts cut), then ``cli.evaluate.main`` on its MAP
   and Z; checks finite losses, that Z moved and that every forward and
   backward kernel was launched; MAP and Z s/step and the split of a warm
   Z step;
8. gradient agreement: one Z step's KL and dL/dZ through the kernels, through
   the plain versions and through a float64 evaluation of the Gram algebra
   (same rows).

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
FP32_FLOPS = 67e12      # H100 SXM FP32 (FFMA) peak, FLOP/s
TF32X3_FLOPS = 495e12 / 3   # three TF32 tensor-core passes per FP32 product
HBM_BYTES = 3.35e12     # H100 SXM HBM3, bytes/s


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


def bound(flops: float, nbytes: float) -> dict:
    """The least time of a call on the card: the larger of its operations
    over the FP32 peak and its bytes (inputs read once, outputs written once)
    over the memory rate; and the 3xTF32 tensor-core time of the same
    operations, which the precision contract also allows."""
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_3xtf32_ms": max(flops / TF32X3_FLOPS * 1e3, t_bytes),
            "gflop": flops / 1e9}


def _work(name: str, *shapes) -> dict:
    """Operations and bytes of a product at these operand shapes."""
    if name == "syrk":                      # A (d, D): the lower half of A Aᵀ
        (d, D), = shapes
        return bound(d * (d + 1) * D, 4 * (d * D + d * d))
    if name == "matmul_nt":                 # (m, D) · (n, D)ᵀ
        (m, D), (n, _) = shapes
        return bound(2 * m * n * D, 4 * (m * D + n * D + m * n))
    (m, z), (_, D) = shapes                 # matmul_nn: (m, z) · (z, D)
    return bound(2 * m * z * D, 4 * (m * z + z * D + m * D))


LIBRARY = {   # one PyTorch call that computes each forward product
    "syrk": lambda A: torch.mm(A, A.T),
    "matmul_nt": lambda A, B: torch.mm(A, B.T),
    "matmul_nn": lambda A, B: torch.mm(A, B),
}


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
        row["library_ms"] = cuda_ms(lambda: LIBRARY[name](*inputs))
        row.update(_work(name, *(t.shape for t in inputs)))
    print(f"  {name:9s} {shape:28s} rel_vs_plain={rel_kp:.3e} "
          f"rel_vs_f64={err_k:.3e} plain_rel_vs_f64={err_p:.3e} "
          f"max_abs_err={max_abs:.3e}"
          + (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
             f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
             f"({row['bound_by']}; 3xTF32 {row['bound_3xtf32_ms']:.4f}; "
             f"{row['gflop']:.1f} GFLOP)" if timed else ""),
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


BACKWARD = {   # the training path's backward passes -> the JAX custom VJP each replaces
    "syrk_backward": "laplace_inducing_points_tpu/ops/pallas/syrk.py:122",
    "matmul_nt_backward": "laplace_inducing_points_tpu/ops/pallas/matmul.py:105",
}


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = fn.backward_launches = 0


def _read_counts() -> dict:
    torch.cuda.synchronize()
    counts = {}
    for name, fn in _wrappers().items():
        counts[name] = fn.launches
        counts[f"{name}_backward"] = fn.backward_launches
    return counts


def _grads(fn, inputs, need, ct, dtype):
    """``(out, leaves, grads)`` of ``fn`` at ``inputs`` cast to ``dtype``; the
    graph is kept, so the backward can be timed again."""
    leaves = [t.detach().to(dtype).requires_grad_(n) for t, n in zip(inputs, need)]
    out = fn(*leaves)
    wrt = [t for t in leaves if t.requires_grad]
    return out, wrt, torch.autograd.grad(out, wrt, ct.to(dtype), retain_graph=True)


def _check_backward(name, kernel, plain, inputs, need, ct, timed=False,
                    library=None) -> dict:
    """The Function's gradients against plain autograd and float64 autograd,
    to phase 3's rule for each gradient; if ``timed``, also the CUDA-event
    times of the backward alone (the graph is kept from one forward) and of
    ``library``, one PyTorch call doing the backward's product, where there
    is one."""
    out_k, wrt_k, g_k = _grads(kernel, inputs, need, ct, torch.float32)
    out_p, wrt_p, g_p = _grads(plain, inputs, need, ct, torch.float32)
    _, _, g_64 = _grads(plain, inputs, need, ct, torch.float64)
    torch.cuda.synchronize()
    row = {"rel_vs_plain": 0.0, "max_abs_err": 0.0}
    shape = " x ".join(str(tuple(t.shape)) for t in inputs)
    for i, (gk, gp, g64) in enumerate(zip(g_k, g_p, g_64)):
        rel_kp, err_k, err_p = _rel(gk, gp), _rel(gk, g64), _rel(gp, g64)
        row["rel_vs_plain"] = max(row["rel_vs_plain"], rel_kp)
        row["max_abs_err"] = max(row["max_abs_err"], float((gk - gp).abs().max()))
        print(f"  {name:18s} {shape:40s} grad {i}: rel_vs_plain={rel_kp:.3e} "
              f"rel_vs_f64={err_k:.3e} plain_rel_vs_f64={err_p:.3e}", flush=True)
        if not (rel_kp <= REL_TOL):
            raise AssertionError(f"{name} {shape} grad {i}: kernel vs plain "
                                 f"{rel_kp:.3e} > {REL_TOL}")
        if not (err_k <= F64_RATIO * err_p):
            raise AssertionError(f"{name} {shape} grad {i}: f64 error {err_k:.3e} > "
                                 f"{F64_RATIO} x plain's {err_p:.3e}")
    if timed:
        row["ms"] = cuda_ms(lambda: torch.autograd.grad(out_k, wrt_k, ct,
                                                        retain_graph=True))
        row["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(out_p, wrt_p, ct,
                                                              retain_graph=True))
        row["library_ms"] = None if library is None else cuda_ms(library)
        print(f"  {name:18s} backward ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f}"
              f" library_ms={row['library_ms']}", flush=True)
    return row


def phase_backward() -> dict:
    """Each Function's gradients at the training shapes (M=100, K=10 ->
    d_z=1000; batch 128 -> d_x=1280; D=61706) and a small ragged shape."""
    print("== phase 6: backward kernels against plain and float64 autograd", flush=True)
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                                   matmul_nn_plain,
                                                                   matmul_nt,
                                                                   matmul_nt_plain)
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    dz, dx, D = 1000, 1280, 61706
    Rz, Rx = randn(dz, D), randn(dx, D)
    rows = {}
    print("  forward, cross-Gram shape:", flush=True)
    _check_kernel("matmul_nt", matmul_nt, matmul_nt_plain, (Rx, Rz), timed=True)
    # the path's configurations: Gzz = syrk(Rz), Gxz = Rx Rzᵀ with only Rz
    # requiring grad (so matmul_nt's backward computes dB alone)
    ct_zz, ct_xz = randn(dz, dz), randn(dx, dz)
    sym_zz = ct_zz + ct_zz.T        # the one product of syrk's backward is sym_zz · Rz
    rows["syrk_backward"] = _check_backward(
        "syrk_backward", syrk, syrk_plain, (Rz,), (True,), ct_zz, timed=True,
        library=lambda: torch.mm(sym_zz, Rz))
    rows["syrk_backward"].update(bound(2 * dz * dz * D, 4 * (2 * dz * D + dz * dz)))
    rows["matmul_nt_backward"] = _check_backward(
        "matmul_nt_backward", matmul_nt, matmul_nt_plain, (Rx, Rz), (False, True),
        ct_xz, timed=True, library=lambda: torch.mm(ct_xz.T, Rx))
    rows["matmul_nt_backward"].update(bound(2 * dz * dx * D,
                                            4 * (dx * D + dx * dz + dz * D)))
    # both gradients of each product once, and B3's own backward at the shape
    # of B1's backward product (no ported path differentiates B3 yet)
    _check_backward("matmul_nt_backward", matmul_nt, matmul_nt_plain, (Rx, Rz),
                    (True, True), ct_xz)
    A_nn, ct_nn = randn(dz, dz), randn(dz, D)
    rows["matmul_nn_backward"] = _check_backward(
        "matmul_nn_backward", matmul_nn, matmul_nn_plain, (A_nn, Rz), (True, True),
        ct_nn, timed=True)
    rows["matmul_nn_backward"].update(bound(4 * dz * dz * D,
                                            4 * (dz * dz + 2 * dz * D + dz * dz + dz * D)))
    for name, fn, plain, shapes, ct_shape in (
            ("syrk_backward", syrk, syrk_plain, [(77, 301)], (77, 77)),
            ("matmul_nt_backward", matmul_nt, matmul_nt_plain, [(13, 333), (70, 333)],
             (13, 70)),
            ("matmul_nn_backward", matmul_nn, matmul_nn_plain, [(13, 45), (45, 1001)],
             (13, 1001))):
        inputs = [randn(*sh) for sh in shapes]
        _check_backward(name, fn, plain, inputs, [True] * len(inputs), randn(*ct_shape))
    return rows


def _train_config(workdir: Path) -> str:
    """lenet5_mnist.yml with only the step counts cut: map.epochs 150 -> 1
    (31 steps on the synthetic surrogate), ip.epochs 250 -> 5."""
    text = Path(CONFIG).read_text()
    for old, new in (("    epochs: 150\n", "    epochs: 1\n"),
                     ("    epochs: 250\n", "    epochs: 5\n")):
        if text.count(old) != 1:
            raise AssertionError(f"{CONFIG} has no single line {old!r}")
        text = text.replace(old, new)
    path = workdir / "lenet5_mnist_steps_cut.yml"
    path.write_text(text)
    return str(path)


def _warm_z_step(state, Z, X, alpha, beta, gamma, reps: int = 3) -> dict:
    """Host seconds of the parts of a warm Z step (device synchronised),
    median of ``reps``."""
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.training.inducing import (_kl_core,
                                                                     grams_from_rows)
    parts = {"rows": [], "gram_forward": [], "gram_backward": [], "pullback": []}
    for _ in range(reps + 1):
        with torch.no_grad():
            (Rz, Rx), rows_s = _host_s(lambda: (ops.dense_wt(state, Z),
                                                ops.dense_wt(state, X)))
        Rz.requires_grad_()
        loss, fwd_s = _host_s(lambda: _kl_core(*grams_from_rows(Rz, Rx), alpha, beta,
                                               gamma))
        (ct,), bwd_s = _host_s(lambda: torch.autograd.grad(loss, Rz))
        _, pull_s = _host_s(lambda: ops.dense_wt_pullback(state, Z, ct))
        for key, val in zip(parts, (rows_s, fwd_s, bwd_s, pull_s)):
            parts[key].append(val)
    return {key: statistics.median(vals[1:]) for key, vals in parts.items()}


def phase_training(workdir: Path, backward_rows: dict) -> dict:
    """The port's trainer on LeNet5 at full width, then evaluation of its
    MAP and Z; the launch counts of both are read together."""
    print("== phase 7: training path (cli.train_scale.main full_pipeline, then "
          "cli.evaluate.main)", flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale
    from laplace_inducing_points_tpu_torch.data.scale import get_dataloaders
    from laplace_inducing_points_tpu_torch.models.scale import LeNet5
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_array, load_params
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    config = _train_config(workdir)
    cfg = load_experiment_config(config)
    opt, ip = cfg["optimization"], cfg["optimization"]["ip"]
    print(f"config {CONFIG} with step counts cut: map.epochs 150 -> "
          f"{opt['map']['epochs']}, ip.epochs 250 -> {ip['epochs']}; unchanged: "
          f"M={ip['m']}, ip.batch_size={ip['batch_size']}, K=10, D=61706, "
          f"map.batch_size={opt['map']['batch_size']}, alpha={opt['alpha']}")
    dirs = {key: str(workdir / key) for key in ("train_map", "train_ind", "data")}
    common = ["--dataset", "mnist", "--config", config, "--device", "cuda",
              "--ckpt_map", dirs["train_map"], "--ckpt_induc", dirs["train_ind"],
              "--data_dir", dirs["data"]]
    _reset_counts()
    result = train_scale.main(["full_pipeline", "--alpha_ip", str(opt["alpha"]),
                               "--train_log", str(workdir / "train_log.jsonl"), *common])
    records = evaluate.main(["--scalable", "--predictive", "weight", "--iters", "1",
                             "--max_batches", "2", *common])
    launches = _read_counts()
    print(f"launches during the training path: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0 and name != "matmul_nn_backward":
            raise AssertionError(f"{name} was not launched by the training path")
    map_stats, ind = result["map"], result["inducing"]
    losses = [r["loss"] for r in ind["rows"]]
    if not (math.isfinite(map_stats["loss_first"]) and math.isfinite(map_stats["loss_last"])):
        raise AssertionError(f"MAP loss not finite: {map_stats}")
    if len(losses) != ip["epochs"] or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"Z-step losses: {losses}")
    if not (result["Z_moved"] > 0.0):
        raise AssertionError("Z did not move")
    for key in ("nll", "acc", "brier", "ece"):
        if not math.isfinite(records[0][key]):
            raise AssertionError(f"evaluation of the trained Z: {key}={records[0][key]}")
    print(f"MAP: {map_stats['steps']} steps, first {map_stats['first_step_s']:.4f} s, "
          f"warm median {map_stats['s_per_step']:.5f} s per step; loss "
          f"{map_stats['loss_first']:.4f} -> {map_stats['loss_last']:.4f}")
    print(f"Z: {ind['steps']} steps, first {ind['first_step_seconds']:.3f} s, warm median "
          f"{ind['seconds_per_step']:.4f} s per step; losses "
          f"{', '.join(f'{v:.6g}' for v in losses)}; max |Z - Z0| = {result['Z_moved']:.4g}")
    print(f"evaluation of the trained Z: nll={records[0]['nll']:.5f} "
          f"acc={records[0]['acc']:.5f} brier={records[0]['brier']:.5f} "
          f"ece={records[0]['ece']:.5f}")

    flat, _, _ = load_params(dirs["train_map"], "map_mnist")
    state = ModelState(LeNet5().cuda(), flat.cuda(), "classifier")
    Z = torch.as_tensor(load_array(dirs["train_ind"], "ind_mnist", ip["epochs"])).cuda()
    ip_loader, _, _ = get_dataloaders("mnist", ip["batch_size"], aug=False,
                                      root=dirs["data"])
    X = torch.as_tensor(next(iter(ip_loader))[0]).cuda()
    N = opt["full_set_size"]
    beta, gamma = N / Z.shape[0], N / X.shape[0]
    split = _warm_z_step(state, Z, X, opt["alpha"], beta, gamma)
    bwd_kernel_ms = (backward_rows["syrk_backward"]["ms"]
                     + backward_rows["matmul_nt_backward"]["ms"])
    print(f"warm Z step split (host clock, synchronised, median of 3): rows "
          f"{split['rows']:.4f} s, Gram algebra forward incl. Cholesky "
          f"{split['gram_forward']:.4f} s, its backward {split['gram_backward']:.4f} s "
          f"(of which the backward kernels {bwd_kernel_ms / 1e3:.4f} s, phase 6), "
          f"row pullback {split['pullback']:.4f} s")
    return {"launches": launches, "state": state, "Z": Z, "X": X, "alpha": opt["alpha"],
            "beta": beta, "gamma": gamma}


def phase_gradient_agreement(train: dict) -> None:
    """One Z step's KL value and dL/dZ through the kernels, through the plain
    versions and through a float64 evaluation of the Gram algebra, from the
    same rows; each ∂L/∂Rz is pulled back through the same f32 row build. The
    kernel path must be no further from float64 than F64_RATIO times the plain
    path, for the value and for dL/dZ."""
    print("== phase 8: gradient agreement of one Z step", flush=True)
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nt_plain
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk_plain
    from laplace_inducing_points_tpu_torch.training.inducing import (
        _kl_core, kl_rows_value_and_grad)
    state, Z, X = train["state"], train["Z"], train["X"]
    consts = (train["alpha"], train["beta"], train["gamma"])
    with torch.no_grad():
        Rz, Rx = ops.dense_wt(state, Z), ops.dense_wt(state, X)

    def plain_value_and_grad(dtype):
        rz = Rz.detach().to(dtype).requires_grad_()
        rx = Rx.to(dtype)
        loss = _kl_core(syrk_plain(rz), matmul_nt_plain(rx, rz), torch.sum(rx * rx),
                        rz.shape[1], *consts)
        return loss.detach(), torch.autograd.grad(loss, rz)[0]

    out = {"kernel": kl_rows_value_and_grad(Rz, Rx, *consts),
           "plain": plain_value_and_grad(torch.float32),
           "float64": plain_value_and_grad(torch.float64)}
    dZ = {key: ops.dense_wt_pullback(state, Z, ct.float()) for key, (_, ct) in out.items()}
    value = {key: float(v) for key, (v, _) in out.items()}
    torch.cuda.synchronize()
    val_err = {key: abs(value[key] - value["float64"]) / abs(value["float64"])
               for key in ("kernel", "plain")}
    grad_err = {key: _rel(dZ[key], dZ["float64"]) for key in ("kernel", "plain")}
    print(f"KL: kernel {value['kernel']:.9g}, plain {value['plain']:.9g}, "
          f"float64 {value['float64']:.12g}; relative error kernel "
          f"{val_err['kernel']:.3e}, plain {val_err['plain']:.3e}")
    print(f"dL/dZ {tuple(dZ['kernel'].shape)}: rel-L2 vs float64 kernel "
          f"{grad_err['kernel']:.3e}, plain {grad_err['plain']:.3e}; kernel vs plain "
          f"{_rel(dZ['kernel'], dZ['plain']):.3e}; cosine(kernel, float64) "
          f"{float(torch.nn.functional.cosine_similarity(dZ['kernel'].ravel(), dZ['float64'].ravel(), dim=0)):.9f}")
    if not all(math.isfinite(v) for v in value.values()):
        raise AssertionError(f"KL values not finite: {value}")
    for what, err in (("KL value", val_err), ("dL/dZ", grad_err)):
        if not (err["kernel"] <= F64_RATIO * err["plain"]):
            raise AssertionError(f"{what}: kernel path {err['kernel']:.3e} from float64, "
                                 f"more than {F64_RATIO} x the plain path's "
                                 f"{err['plain']:.3e}")


def main() -> int:
    smi = phase_environment()
    phase_build()
    kernel_rows = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        launches, _ = phase_main_path(Path(tmp))
        phase_agreement(Path(tmp))
        backward_rows = phase_backward()
        train = phase_training(Path(tmp), backward_rows)
        phase_gradient_agreement(train)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [{"name": name, "route": "cuda", "source": KERNELS[name][0],
              "replaces": KERNELS[name][1], "launches": launches[name],
              **{k: kernel_rows[name][k] for k in keys}}
             for name in KERNELS]
    # B3's own backward has no caller on a ported path (phase 6 checks and times it)
    table += [{"name": name, "route": "cuda",
               "source": "laplace_inducing_points_tpu_torch/csrc/matmul.cu",
               "replaces": replaces, "launches": train["launches"][name],
               **{k: backward_rows[name][k] for k in keys}}
              for name, replaces in BACKWARD.items()]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
