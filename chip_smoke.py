#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and toy paths once on one CUDA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the process
exits non-zero without printing a result:

1. environment: requires CUDA, prints torch/CUDA versions and the card's
   ``nvidia-smi`` name and power limit, sets the f32 policy (TF32 off);
2. build: compiles the CUDA kernels from ``laplace_inducing_points_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version and against a
   float64 product, at the serving path's shapes and small ragged shapes (the
   Gram at odd D with rows off a 16-byte boundary, below one split's depth and
   at a d that is not a multiple of its tile, exactly symmetric at each);
   each path of B2 and B3 (row, rank, tiled) at the shape it serves on the
   main paths and at a ragged odd-D shape (rows off a 16-byte boundary), with
   the path each call took; the coherent part (bias) of the tiled paths' and
   the Gram's error at the serving and cross-Gram shapes, random and
   all-positive operands, against cuBLAS FP32's; CUDA-event times of one call and of a run of calls
   against the bound of the arithmetic each path does;
4. main path: writes a seeded LeNet5 MAP file and an inducing set, runs
   ``laplace_inducing_points_tpu_torch.cli.evaluate.main`` for
   ``configs/scale/lenet5_mnist.yml`` (M=100, S=200, batch 256) and checks
   that every kernel and every path it uses was launched and the metrics are
   finite;
5. agreement: one batch's logit samples and the Gram through the kernels
   against the same computation through the plain versions and through a
   float64 evaluation of the sample contractions; warm timings of the
   factor build and of one batch, broken down;
6. backward kernels: each kernel's ``torch.autograd.Function`` gradients
   against plain autograd and a float64 evaluation, at the training shapes
   (Gzz = syrk(Rz), Gxz = Rx Rzᵀ), at the SLQ loop's one-row products and a
   small ragged shape, with CUDA-event times of the backward passes;
7. training path: ``laplace_inducing_points_tpu_torch.cli.train_scale.main``
   in ``full_pipeline`` mode on LeNet5 at full width (M=100, batch 128,
   D=61,706; only the step counts cut), then ``cli.evaluate.main`` on its MAP
   and Z; checks finite losses, that Z moved and that every forward and
   backward kernel and every path the run uses was launched; MAP and Z
   s/step and the split of a warm Z step;
8. gradient agreement: one Z step's KL and dL/dZ through the kernels, through
   the plain versions and through a float64 evaluation of the Gram algebra
   (same rows); the kernels' KL value must be well closer to float64 than the
   plain path's;
9. the GGN probe sweep (TF32 tensor cores) against its plain FP32 version,
   against two cuBLAS TF32 products and against float64, at the stochastic
   objective's shapes (V (240, 61706), R (1280, 61706), scale 468.75), the
   residual sweep's P = 16 and ragged shapes (V off a 16-byte boundary,
   P > 256); its gradient in V against float64 autograd; its bias against
   cuBLAS TF32's, random and all-positive operands; CUDA-event times;
10. stochastic path: ``cli.train_scale.main train_inducing --objective
    stochastic`` on phase 7's MAP weights (the config as shipped: 256 probes,
    1 SLQ probe, 200 Krylov steps; only ip.epochs cut to 3), then
    ``cli.evaluate.main`` on its Z; checks finite losses and metrics, that Z
    moved and that every forward and backward kernel and every path of B2
    and B3 was launched (B3's own backward included); Z s/step, a warm
    step's split and its peak memory;
11. estimator agreement: one stochastic Z step's KL and dL/dZ on the same
    probes through the kernels, through the kernels with the FP32 sweep,
    through the plain versions and in float64, beside the spread of the
    estimator over eight probe draws, each also in float64 for the root
    mean square of the TF32 path's shift of the KL value;
12. the wide MLP's kernel shapes (``configs/scale/mlp_mnist.yml``, D = 235,146,
    d_z = 1,000, d_x = 1,280, S = 200, and the evidence Gram of a MAP batch,
    (2560, D)): each kernel against its plain version and float64, timed, the
    Gram exactly symmetric, the backward passes of the Gram and cross-Gram;
13. the MLP as shipped: ``cli.train_scale.main full_pipeline`` without
    ``--alpha_ip`` (the alpha grid search on the card; map.epochs 100 -> 1,
    ip.epochs 250 -> 3), ``cli.evaluate.main`` on 2 batches and one
    ``update_alpha`` step on the trained MAP (batch 256); every kernel of the
    gram path launched, alpha in [10, 1000], every grid NLL, the log evidence
    and its slope finite; warm Z-step split, peak memory, factor build and
    serving batch;
14. ResNet1M's kernel shapes (``configs/scale/resnet1m_cifar10.yml``,
    D = 1,084,586, d_z = 500, d_x = 320; Rz is 2.17 GB, past 2^31 bytes) as in
    phase 12, with the backward products of contraction depth 500 and 320;
15. ResNet1M as shipped (CIFAR-10 surrogate, augmentation on for the MAP,
    alpha_ip 10 as the config's header prescribes, example_block 4,
    sample_block 25; map.epochs 75 -> 10, ip.epochs 100 -> 3), then
    ``cli.evaluate.main`` on 2 test batches, checked and timed as phase 13;
16. phase 8's gradient agreement on ResNet1M's trained MAP and Z;
17. the matrix-free operators at M = 1,024 (``lenet5_mnist_matfree1k.yml``,
    d = 10,240, seeded weights): the W factor over example blocks of 128
    against one block (value and dL/dZ of <Y, gram_matmat(X)>), the Gram action
    against the rows through B1 and through B3 then B2 and against float64,
    Nystrom-preconditioned and plain CG against a float64 Cholesky solve;
18. the matfree slice as shipped: ``cli.train_scale.main full_pipeline`` on
    ``lenet5_mnist_matfree1k.yml`` (12 MAP epochs, the alpha grid search on
    the matfree predictive, ip.epochs 60 -> 3 on ``stochastic_matfree``, the
    CG healthchecks), then ``cli.evaluate.main --predictive matfree`` on 2
    test batches with two generators; B4 and its backward launched by that
    run (the counts reported as ``<kernel>@matfree1k``); the
    split of a warm Z step (sketch, trace term with its CG solves, SLQ,
    backward), every solve's iterations, the peak memory, the sketch build
    and one serving batch;
19. the acceptance checks on phase 18's MAP and Z: (a) matfree dL/dZ against
    the materialized one on the same probes (its Cholesky pivot jitter off:
    the same function; the jitter's own share printed) over precond_rank
    {0, 16, 64} x cg_maxiter {25, 50, 100}, gated at the shipped knobs below
    the materialized gradient's spread over 4 probe draws (the cosine of the
    draws' mean with the exact gram dL/dZ printed), and with tight CG (tol
    1e-6, maxiter 500) on those 5 probe sets at relative L2 at most 0.05
    and cosine at least 0.998; (b) 20 matfree, 20 materialized (same probes) and
    20 gram steps on the same 2,560 images, each one's change of their
    exact gram KL against the estimate's sd over 8 probe draws (printed),
    gated: the matfree trajectory stays within half the materialized one's
    length of it; (c) the healthcheck residual with cuDNN's TF32 on and off
    (trap C1; printed);
20. matfree against materialized Matheron draws on the same eps, eta (tight
    CG gated at 1e-3; the shipped knobs printed), ``--predictive matfree``
    against ``--predictive weight`` (exact) within the weight path's
    generator noise; B1, B2 and B3 launched by the materialized sampler's
    build and draws (the counts reported as ``<kernel>@matheron1k``); the
    kernels at this path's shapes, timed (B1 (10240, D), B2/B3 at S = 32, B4
    at P = 12 and 4 against Rx);
21. ``lenet5_mnist_matfree4k.yml`` (M = 4,096, d = 40,960) on phase 18's MAP:
    one Z step through ``cli.train_scale.main train_inducing --alpha_ip 50``
    and one ``cli.evaluate.main --predictive matfree`` batch, timed with
    their peak memory; its KL against the materialized one on the same
    probes without its pivot jitter (Rz 10.1 GB, the Gram 6.7 GB);
22. the kernels at the toy shapes (banana d_z 80, D 626; spiral 100, 4,946;
    sine 40, 321): B1-B3 forward and backward against their plain versions
    and float64 by phase 3's rules (the bias gate, B1 exactly symmetric), B3's
    own backward and B4 at banana's stochastic step, timed against the bound
    and the torch.mm each replaces;
23. banana as shipped: ``cli.main_toy.main full_pipeline`` (250 MAP epochs,
    500 gram Z steps at alpha_train 1, every figure computed on the card) and
    ``cli.evaluate.main`` with the weight, cov and dense predictives against
    the OOD ring at r = 1.05; the MAP loss falls, Z moves, the figures are
    finite, the cov statistics are reused, B1, B2 and their backward passes
    launched (``<kernel>@banana``);
24. the golden banana MAP and Z (tests/golden) through the port's weight
    predictor at S = 200: band (a) of tests/test_golden_banana.py; the dense
    and cov predictives' NLL printed beside it;
25. regressor_sine.yml through ``cli.main_toy.main full_pipeline`` (map.epochs
    cut where as shipped would take more than 60 s at banana's step time) and
    ``cli.evaluate.main`` (weight, dense): the Gaussian NLL falls, logvar moves,
    the 1-D predictive is finite with a positive variance, the kernels
    launched (``<kernel>@sine``);
26. classifier_xor.yml's 4 restarts (``main_toy train_inducing``, the lowest
    full-set KL selected) and banana's stochastic Z step (``--scalable``, 5
    steps; B3's backward and B4 launched, ``<kernel>@banana``);
27. ``cli.evaluate.main --predictive cov`` at LeNet5's full width on phase 7's
    MAP and Z beside ``--predictive weight``: finite metrics, the statistics
    cache hit on the second repetition, the self-check's share and the NLL
    gaps printed with the peak memory;
28. resume: ``cli.train_scale.main train_map`` (lenet5_mnist.yml, 1 MAP
    epoch), then ``train_map --continue``: the restored step and the learning
    rate there (the cosine schedule's floor), the weights against an
    in-process continuation (the same Adam state, a fresh loader of the same
    seed; relative L2 at most 1e-6), then ``train_inducing --continue``;
29. ``--profile``: ``train_scale train_inducing --profile`` (gram, 2 Z steps)
    and ``evaluate --scalable --profile --iters 2`` (one batch): each trace
    holds B1-B3's kernels with the launches of the port's counters for the
    same steps, their device ms as the trace gives them printed;
30. ``gram_chunked`` against ``gram`` on phase 7's MAP, Z and X: the two
    stagings in float64 (KL relative 1e-6, dL/dZ relative L2 1e-5); in
    float32 the chunked rows (1e-4) and pullback (1e-5) against one block's,
    the chunked rows against float64 (2x the cuDNN-off chunks' error),
    and each step's dL/dZ against float64 (the chunked one within 2x the
    gram one's); warm step time and peak memory of each, and the same at
    matfree1k's materialized size (M = 1,024, d_z = 10,240);
31. the mesh on the card (the one H100 listed twice, and the real devices
    where there are more): ``sharded_gram`` against B1's Gram (relative 1e-6),
    ``sharded_dense_wt`` and ``sharded_ggn_matmat`` against their unsharded
    versions, the data-parallel MAP step against one device's on LeNet5 and
    on ResNet1M at batch 16 (BatchNorm; where the two float32 gradients
    are further apart than 1e-5, each against float64 on its own ReLU
    masks), ``ScalableLLAPredictor(
    mesh=)`` against the plain draws on its factor and noise (weight, S = 200;
    matfree, S = 32; logits relative 1e-5, or for the weight path no further
    from its float64 contractions than 2x the plain draws, for the matfree
    path within 10x the CG residual float32 reaches), with a second
    factor build's distance printed, and ``evaluate --mesh`` and
    ``train_scale`` without ``--no-mesh`` on one GPU (no mesh there, as in the
    reference); the data-parallel MAP gradients against float64 on their
    own ReLU masks;
32. the convolution policy (``utils.device.set_conv_policy``): every route
    of the port's convolutions (rows, row pullback, the matfree factor, the
    MAP gradient, the serving push-forward, the cov Jacobians) at every size
    the scale configs give it, on seeded LeNet5 and ResNet1M: float32 against
    float64 within 2x the cuDNN-off path's error, rows and MAP gradients
    bitwise equal in two evaluations, no Winograd or FFT kernel; the same
    routes and the steps' times without the policy (a subprocess,
    ``chip_smoke.py --conv-before OUT``); two factor builds' logits on the
    same noise. Every float64 reference replays the ReLU masks of the float32
    forward it is held against (``utils.relu_masks``). Then the routes at
    small sizes (STEP1) on the first images, against float64 computed on the
    CPU by a process that ran beside phases 3-31 at nice 19
    (``chip_smoke.py --cpu-reference OUT``): the card's float64 on the CPU's
    masks within REF_TOL of the CPU's, and each ResNet1M route's float32 with
    cuDNN off within F64_RATIO times the CPU float32 port's error (under the
    policy within F64_RATIO times cuDNN off's); the policy's probe, its error and
    cost, and a process that ran cuDNN before importing the port
    (``chip_smoke.py --conv-first``) must fail on it;
33. the toy generators: ``cli.make_data`` for each dataset, then
    ``main_toy full_pipeline`` on banana at a data seed no fixture holds;
34. the public API, imported only through the subpackages' exports: the
    parameter counts, ``train_inducing_points`` (3 gram steps on phase 7's
    MAP, B1, B2 and their backward passes launched, the ``mnist`` image
    callback), ``is_pd``, ``nystrom_preconditioner`` into ``cg_batched``,
    ``viz.exp_plots`` on an evaluation record; the step's kernels timed at
    its shapes.

The line before the last is the card's ``nvidia-smi`` line; the one before
it is the per-kernel JSON; the last line is ``{"ok": true, "device": ...}``.
The line before those three gives the whole run's seconds.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
REL_TOL = 1e-4          # kernel vs plain, relative Frobenius
F64_RATIO = 2.0         # kernel's f64 error may be at most this times the plain's
BIAS_TOL = 1e-8         # coherent relative error always allowed: a sixth of FP32's 2^-24
KL_CLOSER = 2.0         # phase 8: the kernels' KL value at least this much closer to f64
FP32_FLOPS = 67e12      # H100 SXM FP32 (FFMA) peak, FLOP/s
TF32_FLOPS = 495e12     # H100 SXM dense TF32 tensor-core peak, FLOP/s
TF32X3_FLOPS = TF32_FLOPS / 3   # three TF32 tensor-core passes per FP32 product
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
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import geometry
    from laplace_inducing_points_tpu_torch.ops.cuda.sweep import sweep_geometry
    device = torch.device("cuda", torch.cuda.current_device())
    print(f"B1/B2/B3 planners' geometry (from the library): {geometry(device)}")
    print(f"B4 planner's geometry (from the library): {sweep_geometry(device)}")
    return seconds


def cuda_ms(fn, reps: int = 7, min_ms: float = 0.0) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs after a warm-up.
    A run is one call, or with ``min_ms`` enough back-to-back calls to last
    that long (at most 50), which hides the host's cost of a call behind the
    device's work when the call is short."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    calls = 1
    if min_ms > 0:
        calls = max(1, min(50, math.ceil(min_ms / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.norm((x.double() - ref.double()).ravel())
                 / torch.linalg.norm(ref.double().ravel()))


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """The least time of a call on the card: the larger of its operations
    over ``peak``, the rate of the arithmetic the kernel does, and its bytes
    (inputs read once, outputs written once) over the memory rate. The FP32
    (FFMA) figure rides along for comparison."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_fp32_ms": max(flops / FP32_FLOPS * 1e3, t_bytes),
            "gflop": flops / 1e9}


def _peak(paths: set) -> float:
    """The arithmetic of a call that launched these kernel paths: the tiled
    paths of B1, B2 and B3 run 3xTF32 on the tensor cores, the row and rank
    paths FP32 FFMA."""
    return TF32X3_FLOPS if any(p.endswith(".tiled") for p in paths) else FP32_FLOPS


def _work(name: str, shapes, peak: float) -> dict:
    """Operations and bytes of a product at these operand shapes."""
    if name == "syrk":                      # A (d, D): the lower half of A Aᵀ
        (d, D), = shapes
        return bound(d * (d + 1) * D, 4 * (d * D + d * d), peak)
    if name == "matmul_nt":                 # (m, D) · (n, D)ᵀ
        (m, D), (n, _) = shapes
        return bound(2 * m * n * D, 4 * (m * D + n * D + m * n), peak)
    (m, z), (_, D) = shapes                 # matmul_nn: (m, z) · (z, D)
    return bound(2 * m * z * D, 4 * (m * z + z * D + m * D), peak)


def _with_paths(call):
    """``(call(), the kernel paths of B1, B2 and B3 it launched)``."""
    before = _path_counts()
    out = call()
    after = _path_counts()
    return out, {key for key, n in after.items() if n > before[key]}


LIBRARY = {   # one PyTorch call that computes each forward product
    "syrk": lambda A: torch.mm(A, A.T),
    "matmul_nt": lambda A, B: torch.mm(A, B.T),
    "matmul_nn": lambda A, B: torch.mm(A, B),
}


def _bias(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The coherent part of ``x``'s error: beta in x - ref = beta ref + (the
    rest, orthogonal to ref)."""
    e, r = (x.double() - ref.double()).ravel(), ref.double().ravel()
    return float(torch.dot(e, r) / torch.dot(r, r))


def _check_kernel(name, kernel, plain, inputs, timed: bool) -> dict:
    """The kernel against its plain version and float64 (REL_TOL, F64_RATIO);
    if ``timed``, CUDA-event ms of one call (``ms``) and of a run of calls
    (``run_ms``), the plain version's and the library call's, and the bound of
    the arithmetic the call did."""
    out_k, paths = _with_paths(lambda: kernel(*inputs))
    out_p = plain(*inputs)
    out_64 = plain(*(t.double() for t in inputs))
    torch.cuda.synchronize()
    rel_kp = _rel(out_k, out_p)
    err_k = _rel(out_k, out_64)
    err_p = _rel(out_p, out_64)
    max_abs = float((out_k - out_p).abs().max())
    shape = " x ".join(str(tuple(t.shape)) for t in inputs)
    row = {"rel_vs_plain": rel_kp, "rel_vs_f64": err_k, "plain_rel_vs_f64": err_p,
           "bias": _bias(out_k, out_64), "plain_bias": _bias(out_p, out_64),
           "outputs": out_k.numel(), "max_abs_err": max_abs, "paths": paths}
    if timed:
        row["ms"] = cuda_ms(lambda: kernel(*inputs))
        row["run_ms"] = cuda_ms(lambda: kernel(*inputs), min_ms=2.0)
        row["plain_ms"] = cuda_ms(lambda: plain(*inputs))
        row["library_ms"] = cuda_ms(lambda: LIBRARY[name](*inputs))
        row["library_run_ms"] = cuda_ms(lambda: LIBRARY[name](*inputs), min_ms=2.0)
        row.update(_work(name, [t.shape for t in inputs], _peak(paths)))
    print(f"  {name:9s} {shape:28s} rel_vs_plain={rel_kp:.3e} "
          f"rel_vs_f64={err_k:.3e} plain_rel_vs_f64={err_p:.3e} "
          f"bias={row['bias']:+.2e} plain_bias={row['plain_bias']:+.2e} "
          f"max_abs_err={max_abs:.3e}"
          + (f" ms={row['ms']:.4f} (run {row['run_ms']:.4f}) plain_ms={row['plain_ms']:.4f} "
             f"library_ms={row['library_ms']:.4f} (run {row['library_run_ms']:.4f}) "
             f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; FP32 FFMA "
             f"{row['bound_fp32_ms']:.4f}; {row['gflop']:.1f} GFLOP)" if timed else ""),
          flush=True)
    if not (rel_kp <= REL_TOL):
        raise AssertionError(f"{name} {shape}: kernel vs plain {rel_kp:.3e} > {REL_TOL}")
    if not (err_k <= F64_RATIO * err_p):
        raise AssertionError(f"{name} {shape}: f64 error {err_k:.3e} > "
                             f"{F64_RATIO} x plain's {err_p:.3e}")
    return row


def _offset(t: torch.Tensor, floats: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts ``floats`` floats into a
    fresh allocation: rows off a 16-byte boundary."""
    buf = torch.empty(t.numel() + floats, device=t.device)
    out = buf[floats:].view(t.shape)
    out.copy_(t)
    return out


# Each path of B2 and B3 (matmul.cu, matmul_tiled.cu): name in the kernels JSON
# -> (wrapper, path, the main-path product it is timed at)
PATHS = {
    "matmul_nt.row": ("matmul_nt", "row", "SLQ Rz v"),
    "matmul_nt.tiled": ("matmul_nt", "tiled", "Woodbury projection, 240 range probes"),
    "matmul_nn.row": ("matmul_nn", "row", "SLQ Rz^T u"),
    "matmul_nn.rank": ("matmul_nn", "rank", "rank-one backward product"),
    "matmul_nn.tiled": ("matmul_nn", "tiled", "Woodbury correction, 240 probes"),
}


def _check_path(name, path, kernel, plain, inputs, timed: bool) -> dict:
    """``_check_kernel``, and the call went through ``path``."""
    row = _check_kernel(name, kernel, plain, inputs, timed)
    if row["paths"] != {f"{name}.{path}"}:
        shape = " x ".join(str(tuple(t.shape)) for t in inputs)
        raise AssertionError(f"{name} {shape} took the paths {sorted(row['paths'])}, "
                             f"not {path!r}")
    return row


def _check_bias(rows: list, tol: float = BIAS_TOL, yardstick: str = "cuBLAS FP32") -> None:
    """A kernel's error must not be coherent: the tensor cores truncate their
    FP32 sums toward zero (and TF32 operands that are not rounded first), and a
    product's coherent error (its bias) passes into the KL value amplified by
    gamma/alpha (the sweep's by gamma into the S_X trace) where round-to-nearest
    errors cancel. Each row is (label, the kernel's bias, the yardstick's bias,
    the yardstick's relative error vs float64, outputs). Gate: |bias| <=
    F64_RATIO x the larger of the yardstick's |bias| and its noise floor (its
    relative error over sqrt(outputs)), or ``tol``. For the FP32 kernels a
    truncated 8-term sum loses 3.5e-8 to 3.9e-8 of its value on average on an
    H100, so a kernel that does not take that loss back, or takes it back
    twice, fails by 3x."""
    failed = []
    for label, bias, base, base_err, outputs in rows:
        floor = base_err / math.sqrt(outputs)
        limit = max(F64_RATIO * max(abs(base), floor), tol)
        ok = abs(bias) <= limit
        print(f"  bias {label:44s} kernel {bias:+.3e}, {yardstick} {base:+.3e} (noise floor "
              f"{floor:.3e}); limit {limit:.3e} {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(label)
    if failed:
        raise AssertionError(f"coherent error above the limit: {failed}")


def phase_kernels() -> dict:
    """Each kernel against its plain version and f64 at the serving shapes
    (M=100, K=10 -> d=1000; D=61706; S=200) and a small ragged shape; each
    path of B2 and B3 at the stochastic objective's shapes (SLQ products at one
    row, rank-one backward products, Woodbury probes: 16 and 240) and at a
    ragged odd-D shape with rows off a 16-byte boundary; the tiled paths' bias
    at the serving and cross-Gram (batch 128 -> 1280 rows) shapes."""
    print("== phase 3: kernels against their plain versions", flush=True)
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                                   matmul_nn_plain,
                                                                   matmul_nt,
                                                                   matmul_nt_plain)
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    d, D, S = 1000, 61706, 200
    cases = {
        # the Gram at the serving shape, a small ragged one, odd D with rows off a
        # 16-byte boundary, D below one split's depth, d not a multiple of the tile
        "syrk": (syrk, syrk_plain, [(randn(d, D),), (randn(77, 301),),
                                    (_offset(randn(130, 3001), 1),), (randn(d, 600),),
                                    (_offset(randn(200, 5002), 2),)]),
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
            if name == "syrk":
                C = syrk(*inputs)
                if not torch.equal(C, C.T):
                    raise AssertionError(f"syrk {tuple(inputs[0].shape)}: not exactly symmetric")
    print("  syrk output exactly symmetric at every shape: True")

    print("  paths of B2 and B3 (CUDA-event ms per call over a run of calls):", flush=True)
    wrappers = {"matmul_nt": (matmul_nt, matmul_nt_plain),
                "matmul_nn": (matmul_nn, matmul_nn_plain)}
    Rz = randn(d, D)
    path_cases = [   # (JSON name or None, wrapper, path, inputs, timed)
        ("matmul_nt.row", "matmul_nt", "row", (randn(1, D), Rz), True),
        (None, "matmul_nt", "tiled", (randn(16, D), Rz), True),
        ("matmul_nt.tiled", "matmul_nt", "tiled", (randn(240, D), Rz), True),
        ("matmul_nn.row", "matmul_nn", "row", (randn(1, d), Rz), True),
        ("matmul_nn.rank", "matmul_nn", "rank", (randn(d, 1), randn(1, D)), True),
        ("matmul_nn.tiled", "matmul_nn", "tiled", (randn(240, d), Rz), True),
        (None, "matmul_nt", "row", (_offset(randn(1, 3001), 1), randn(130, 3001)), False),
        (None, "matmul_nt", "row", (_offset(randn(3, 3002), 2), randn(130, 3002)), False),
        (None, "matmul_nt", "tiled", (_offset(randn(16, 3001), 1), randn(130, 3001)), False),
        (None, "matmul_nt", "tiled", (randn(240, 3001), randn(130, 3001)), False),
        (None, "matmul_nn", "row", (_offset(randn(1, d), 1), randn(d, 3001)), False),
        (None, "matmul_nn", "rank", (randn(70, 1), randn(1, 3001)), False),
        (None, "matmul_nn", "tiled", (randn(16, d), randn(d, 3001)), False),
        (None, "matmul_nn", "tiled", (_offset(randn(240, d), 2), randn(d, 3001)), False),
    ]
    for key, name, path, inputs, timed in path_cases:
        kernel, plain = wrappers[name]
        if key is not None:
            print(f"  {key}: {PATHS[key][2]}", flush=True)
        row = _check_path(name, path, kernel, plain, inputs, timed)
        if key is not None:
            results[key] = row

    print("  coherent error of the tiled paths and the Gram against float64:", flush=True)
    bias_rows = [("serving NT, normal operands", results["matmul_nt"]),
                 ("serving NN, normal operands", results["matmul_nn"]),
                 ("Gram, normal operands", results["syrk"])]
    A = rand(d, D)
    bias_rows.append(("Gram, positive operands", _check_kernel("syrk", syrk, syrk_plain, (A,),
                                                               False)))
    del A
    for label, name, shapes, draw in (
            ("serving NT, positive operands", "matmul_nt", ((S, D), (d, D)), rand),
            ("serving NN, positive operands", "matmul_nn", ((S, d), (d, D)), rand),
            ("cross-Gram NT, normal operands", "matmul_nt", ((1280, D), (d, D)), randn),
            ("cross-Gram NT, positive operands", "matmul_nt", ((1280, D), (d, D)), rand)):
        kernel, plain = wrappers[name]
        inputs = tuple(draw(*shape) for shape in shapes)
        bias_rows.append((label, _check_path(name, "tiled", kernel, plain, inputs, False)))
        del inputs
    _check_bias([(label, row["bias"], row["plain_bias"], row["plain_rel_vs_f64"], row["outputs"])
                 for label, row in bias_rows])
    return results


CONFIG = "configs/scale/lenet5_mnist.yml"
KERNELS = {   # name -> (source, the TPU kernel it replaces); serving shapes: tiled paths
    "syrk": ("laplace_inducing_points_tpu_torch/csrc/syrk.cu",
             "laplace_inducing_points_tpu/ops/pallas/syrk.py:71"),
    "matmul_nt": ("laplace_inducing_points_tpu_torch/csrc/matmul_tiled.cu",
                  "laplace_inducing_points_tpu/ops/pallas/matmul.py:68"),
    "matmul_nn": ("laplace_inducing_points_tpu_torch/csrc/matmul_tiled.cu",
                  "laplace_inducing_points_tpu/ops/pallas/matmul.py:153"),
}
SERVING_KERNELS = ("syrk", "matmul_nt", "matmul_nn")


def _wrappers() -> dict:
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
    from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
    return {"syrk": syrk, "matmul_nt": matmul_nt, "matmul_nn": matmul_nn,
            "ggn_sweep": ggn_sweep}


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
    wrappers = {name: _wrappers()[name] for name in SERVING_KERNELS}
    _reset_counts()
    records = evaluate.main(_main_path_argv(workdir))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    paths = _path_counts()
    print(f"launches during the main path: {json.dumps(launches)}; by path: "
          f"{json.dumps(paths)}")
    for name, n in {**launches, "matmul_nt.tiled": paths["matmul_nt.tiled"],
                    "matmul_nn.tiled": paths["matmul_nn.tiled"]}.items():
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


BACKWARD = {   # the training paths' backward passes -> the JAX custom VJP each replaces
    "syrk_backward": "laplace_inducing_points_tpu/ops/pallas/syrk.py:122",
    "matmul_nt_backward": "laplace_inducing_points_tpu/ops/pallas/matmul.py:105",
    "matmul_nn_backward": "laplace_inducing_points_tpu/ops/pallas/matmul.py:190",
}


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = fn.backward_launches = 0
        for path in getattr(fn, "path_launches", {}):
            fn.path_launches[path] = 0


def _path_counts() -> dict:
    """Launches of B2's and B3's kernels by path (forward and backward)."""
    return {f"{name}.{path}": n for name, fn in _wrappers().items()
            for path, n in getattr(fn, "path_launches", {}).items()}


def _read_counts() -> dict:
    torch.cuda.synchronize()
    counts = {}
    for name, fn in _wrappers().items():
        counts[name] = fn.launches
        counts[f"{name}_backward"] = fn.backward_launches
    counts.update(_path_counts())
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
    (out_k, wrt_k, g_k), paths = _with_paths(
        lambda: _grads(kernel, inputs, need, ct, torch.float32))
    out_p, wrt_p, g_p = _grads(plain, inputs, need, ct, torch.float32)
    _, _, g_64 = _grads(plain, inputs, need, ct, torch.float64)
    torch.cuda.synchronize()
    row = {"rel_vs_plain": 0.0, "max_abs_err": 0.0, "paths": paths}
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
    rows["syrk_backward"].update(bound(2 * dz * dz * D, 4 * (2 * dz * D + dz * dz),
                                       _peak(rows["syrk_backward"]["paths"])))
    rows["matmul_nt_backward"] = _check_backward(
        "matmul_nt_backward", matmul_nt, matmul_nt_plain, (Rx, Rz), (False, True),
        ct_xz, timed=True, library=lambda: torch.mm(ct_xz.T, Rx))
    rows["matmul_nt_backward"].update(bound(2 * dz * dx * D, 4 * (dx * D + dx * dz + dz * D),
                                            _peak(rows["matmul_nt_backward"]["paths"])))
    # both gradients of each product once, and B3's own backward (the
    # stochastic objective's Woodbury correction) at the shape of B1's
    # backward product; its library time is the two torch.mm of its products
    _check_backward("matmul_nt_backward", matmul_nt, matmul_nt_plain, (Rx, Rz),
                    (True, True), ct_xz)
    A_nn, ct_nn = randn(dz, dz), randn(dz, D)
    rows["matmul_nn_backward"] = _check_backward(
        "matmul_nn_backward", matmul_nn, matmul_nn_plain, (A_nn, Rz), (True, True),
        ct_nn, timed=True, library=lambda: (torch.mm(ct_nn, Rz.T), torch.mm(A_nn.T, ct_nn)))
    rows["matmul_nn_backward"].update(bound(4 * dz * dz * D,
                                            4 * (dz * dz + 2 * dz * D + dz * dz + dz * D),
                                            _peak(rows["matmul_nn_backward"]["paths"])))
    # the SLQ loop's one-row products: B2's backward at one row (dA on B3's row
    # path, dB rank-one) and B3's (dA on B2's row path, dB rank-one); library:
    # the two torch.mm of the same products
    v, ct_v = randn(1, D), randn(1, dz)
    rows["matmul_nt_backward.row"] = _check_backward(
        "matmul_nt_backward", matmul_nt, matmul_nt_plain, (v, Rz), (True, True), ct_v,
        timed=True, library=lambda: (torch.mm(ct_v, Rz), torch.mm(ct_v.T, v)))
    rows["matmul_nt_backward.row"].update(bound(4 * dz * D, 4 * (dz + dz * D + D + dz * D),
                                                _peak(rows["matmul_nt_backward.row"]["paths"])))
    u, ct_u = randn(1, dz), randn(1, D)
    rows["matmul_nn_backward.row"] = _check_backward(
        "matmul_nn_backward", matmul_nn, matmul_nn_plain, (u, Rz), (True, True), ct_u,
        timed=True, library=lambda: (torch.mm(ct_u, Rz.T), torch.mm(u.T, ct_u)))
    rows["matmul_nn_backward.row"].update(bound(4 * dz * D, 4 * (D + dz * D + dz + dz * D),
                                                _peak(rows["matmul_nn_backward.row"]["paths"])))
    for name, row in rows.items():
        print(f"  {name:22s} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; FP32 FFMA "
              f"{row['bound_fp32_ms']:.4f}); paths {sorted(row['paths'])}", flush=True)
    for name, fn, plain, shapes, ct_shape in (
            ("syrk_backward", syrk, syrk_plain, [(77, 301)], (77, 77)),
            ("matmul_nt_backward", matmul_nt, matmul_nt_plain, [(13, 333), (70, 333)],
             (13, 70)),
            ("matmul_nn_backward", matmul_nn, matmul_nn_plain, [(13, 45), (45, 1001)],
             (13, 1001))):
        inputs = [randn(*sh) for sh in shapes]
        _check_backward(name, fn, plain, inputs, [True] * len(inputs), randn(*ct_shape))
    return rows


# kernels and paths the gram path (phase 7) does not run: B3's own backward, B4
# and the one-row and rank-one paths belong to the stochastic objective (phase 10)
GRAM_PATH_UNUSED = ("matmul_nn_backward", "ggn_sweep", "ggn_sweep_backward",
                    "matmul_nt.row", "matmul_nn.row", "matmul_nn.rank")


def _cut_config(workdir: Path, config: str, cuts: dict, name: str) -> str:
    """A copy of ``config`` with the lines of ``cuts`` (old -> new epochs)
    replaced, each of which it must hold once (a comment may follow the
    number), written to ``workdir/name``."""
    text = Path(config).read_text()
    for old, new in cuts.items():
        pattern = re.compile(rf"^    epochs: {old}(?=[ \n])", re.MULTILINE)
        if len(pattern.findall(text)) != 1:
            raise AssertionError(f"{config} has no single line '    epochs: {old}'")
        text = pattern.sub(f"    epochs: {new}", text)
    path = workdir / name
    path.write_text(text)
    return str(path)


def _train_config(workdir: Path) -> str:
    """lenet5_mnist.yml with only the step counts cut: map.epochs 150 -> 1
    (31 steps on the synthetic surrogate), ip.epochs 250 -> 5."""
    return _cut_config(workdir, CONFIG, {150: 1, 250: 5}, "lenet5_mnist_steps_cut.yml")


def _warm_z_step(state, Z, X, alpha, beta, gamma, reps: int = 3,
                 example_block=None) -> dict:
    """Host seconds of the parts of a warm Z step (device synchronised),
    median of ``reps``, the row builds and pullback in blocks of
    ``example_block`` examples; and the peak device memory of the row build
    and of the whole step above what was allocated before it
    (``torch.cuda.max_memory_allocated``, GiB), and that base."""
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.training.inducing import (_kl_core,
                                                                     grams_from_rows)
    parts = {"rows": [], "gram_forward": [], "gram_backward": [], "pullback": []}
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            (Rz, Rx), rows_s = _host_s(lambda: (
                ops.dense_wt(state, Z, example_block=example_block),
                ops.dense_wt(state, X, example_block=example_block)))
        rows_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        Rz.requires_grad_()
        loss, fwd_s = _host_s(lambda: _kl_core(*grams_from_rows(Rz, Rx), alpha, beta,
                                               gamma))
        (ct,), bwd_s = _host_s(lambda: torch.autograd.grad(loss, Rz))
        del Rz, Rx, loss
        _, pull_s = _host_s(lambda: ops.dense_wt_pullback(state, Z, ct,
                                                           example_block=example_block))
        del ct
        for key, val in zip(parts, (rows_s, fwd_s, bwd_s, pull_s)):
            parts[key].append(val)
    split = {key: statistics.median(vals[1:]) for key, vals in parts.items()}
    split["rows_peak_gib"] = rows_peak
    split["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    split["base_gib"] = base / 2**30
    return split


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
        if n <= 0 and name not in GRAM_PATH_UNUSED:
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
            "beta": beta, "gamma": gamma, "map_dir": dirs["train_map"],
            "data_dir": dirs["data"]}


def phase_gradient_agreement(train: dict, phase: str = "phase 8") -> dict:
    """One Z step's KL value and dL/dZ through the kernels, through the plain
    versions and through a float64 evaluation of the Gram algebra, from the
    same rows (built and pulled back in blocks of ``train["example_block"]``
    examples); each ∂L/∂Rz is pulled back through the same f32 row build. The
    kernel path must be no further from float64 than F64_RATIO times the plain
    path, for the value and for dL/dZ, and its KL value KL_CLOSER times closer
    to float64 than the plain path's."""
    print(f"== {phase}: gradient agreement of one Z step", flush=True)
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nt_plain
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk_plain
    from laplace_inducing_points_tpu_torch.training.inducing import (
        _kl_core, kl_rows_value_and_grad)
    state, Z, X = train["state"], train["Z"], train["X"]
    consts = (train["alpha"], train["beta"], train["gamma"])
    block = train.get("example_block")
    with torch.no_grad():
        Rz = ops.dense_wt(state, Z, example_block=block)
        Rx = ops.dense_wt(state, X, example_block=block)

    def plain_value_and_grad(dtype):
        rz = Rz.detach().to(dtype).requires_grad_()
        rx = Rx.to(dtype)
        loss = _kl_core(syrk_plain(rz), matmul_nt_plain(rx, rz), torch.sum(rx * rx),
                        rz.shape[1], *consts)
        return loss.detach(), torch.autograd.grad(loss, rz)[0]

    out = {"kernel": kl_rows_value_and_grad(Rz, Rx, *consts),
           "plain": plain_value_and_grad(torch.float32),
           "float64": plain_value_and_grad(torch.float64)}
    del Rz, Rx
    dZ = {key: ops.dense_wt_pullback(state, Z, ct.float(), example_block=block)
          for key, (_, ct) in out.items()}
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
    # the compensated kernels keep the KL value well closer to float64 than
    # cuBLAS FP32 (3.9-32x on an H100); a coherent bias in Gxz loses that
    if not (KL_CLOSER * val_err["kernel"] <= val_err["plain"]):
        raise AssertionError(f"KL value: kernel path {val_err['kernel']:.3e} from float64, "
                             f"not {KL_CLOSER} x closer than the plain path's "
                             f"{val_err['plain']:.3e}")
    return {"value_err": val_err, "grad_err": grad_err}


@contextlib.contextmanager
def tf32_matmuls():
    """cuBLAS f32 matmuls in TF32 inside the scope only (the library yardstick
    of the sweep kernel); the f32 policy is restored on exit."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _library_sweep(V, R, scale):
    """Two cuBLAS TF32 products, ``scale·(V Rᵀ) R``: timed, never used by the port."""
    with tf32_matmuls():
        return scale * torch.mm(torch.mm(V, R.T), R)


def _sweep_work(P: int, d: int, D: int) -> dict:
    """The sweep's least time: 4·P·d·D operations over the TF32 peak, or its
    bytes (V and R read once, Y written once) over the memory rate."""
    flops, nbytes = 4 * P * d * D, 4 * (2 * P * D + d * D)
    t_ops, t_bytes = flops / TF32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "two_pass_bytes_ms": 4 * (2 * P * D + 2 * d * D) / HBM_BYTES * 1e3}


SWEEP_BIAS_TOL = 1e-6   # coherent relative error always allowed in the TF32 sweep


def phase_sweep() -> dict:
    """B4 against its plain FP32 version, two cuBLAS TF32 products and
    float64, forward and gradient in V, at the path shapes and ragged ones (V
    off a 16-byte boundary; P > 256, two probe groups). Gates: the kernel is
    no further from float64 than F64_RATIO times the cuBLAS TF32 products, and
    its bias passes _check_bias against cuBLAS TF32's (at least
    SWEEP_BIAS_TOL), on random operands at every shape and on all-positive
    ones at the path shape."""
    print("== phase 9: the GGN probe sweep (TF32) against FP32, cuBLAS TF32 and float64",
          flush=True)
    from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep, ggn_sweep_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    rows, bias_rows, too_far = {}, [], []
    for P, d, D, scale, offset, draw, timed in ((240, 1280, 61706, 468.75, 0, randn, True),
                                                (240, 1280, 61706, 468.75, 0, rand, False),
                                                (16, 1280, 61706, 468.75, 0, randn, False),
                                                (240, 130, 3001, 468.75, 1, randn, False),
                                                (300, 70, 333, 0.5, 0, randn, False),
                                                (17, 70, 333, 0.5, 0, randn, False)):
        V, R, ct = draw(P, D), draw(d, D), randn(P, D)
        V = _offset(V, offset) if offset else V
        fwd = {"kernel": ggn_sweep(V, R, scale), "plain": ggn_sweep_plain(V, R, scale),
               "library": _library_sweep(V, R, scale)}
        ref = ggn_sweep_plain(V.double(), R.double(), scale)
        v = V.clone().requires_grad_()
        (dv_kernel,) = torch.autograd.grad(ggn_sweep(v, R, scale), v, ct)
        v64 = V.double().requires_grad_()
        (dv_64,) = torch.autograd.grad(ggn_sweep_plain(v64, R.double(), scale), v64,
                                       ct.double())
        bwd = {"kernel": dv_kernel, "plain": ggn_sweep_plain(ct, R, scale),
               "library": _library_sweep(ct, R, scale)}
        torch.cuda.synchronize()
        kind = "positive" if draw is rand else "normal"
        for what, outs, exact in (("forward", fwd, ref), ("dV", bwd, dv_64)):
            err = {key: _rel(out, exact) for key, out in outs.items()}
            to_plain = _rel(outs["kernel"], outs["plain"])
            print(f"  ggn_sweep {what:7s} V {(P, D)}{' +' + str(offset) if offset else ''} "
                  f"R {(d, D)} scale {scale}, {kind}: rel vs f64 kernel {err['kernel']:.3e}, "
                  f"cuBLAS TF32 {err['library']:.3e}, plain FP32 {err['plain']:.3e}; kernel vs "
                  f"plain FP32 {to_plain:.3e}", flush=True)
            if not err["kernel"] <= F64_RATIO * err["library"]:
                too_far.append(f"{what} {(P, d, D)} {kind}: f64 error {err['kernel']:.3e} > "
                               f"{F64_RATIO} x cuBLAS TF32's {err['library']:.3e}")
            if what == "forward" or draw is randn:
                bias_rows.append((f"{what} {(P, d, D)}, {kind} operands",
                                  _bias(outs["kernel"], exact), _bias(outs["library"], exact),
                                  err["library"], exact.numel()))
        if not timed:
            continue
        work = _sweep_work(P, d, D)
        rows["ggn_sweep"] = {
            "max_abs_err": float((fwd["kernel"] - fwd["plain"]).abs().max()),
            "ms": cuda_ms(lambda: ggn_sweep(V, R, scale)),
            "run_ms": cuda_ms(lambda: ggn_sweep(V, R, scale), min_ms=2.0),
            "plain_ms": cuda_ms(lambda: ggn_sweep_plain(V, R, scale)),
            "library_ms": cuda_ms(lambda: _library_sweep(V, R, scale)),
            "library_run_ms": cuda_ms(lambda: _library_sweep(V, R, scale), min_ms=2.0), **work}
        out = ggn_sweep(v, R, scale)
        rows["ggn_sweep_backward"] = {
            "max_abs_err": float((bwd["kernel"] - bwd["plain"]).abs().max()),
            "ms": cuda_ms(lambda: torch.autograd.grad(out, v, ct, retain_graph=True)),
            "run_ms": cuda_ms(lambda: torch.autograd.grad(out, v, ct, retain_graph=True),
                              min_ms=2.0),
            "plain_ms": cuda_ms(lambda: ggn_sweep_plain(ct, R, scale)),
            "library_ms": cuda_ms(lambda: _library_sweep(ct, R, scale)),
            "library_run_ms": cuda_ms(lambda: _library_sweep(ct, R, scale), min_ms=2.0),
            **work}
        for name, row in rows.items():
            print(f"  {name:18s} ms={row['ms']:.4f} (run {row['run_ms']:.4f}) plain_ms="
                  f"{row['plain_ms']:.4f} library_ms (cuBLAS TF32)={row['library_ms']:.4f} (run "
                  f"{row['library_run_ms']:.4f}) bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}; {row['gflop']:.1f} GFLOP; two-pass bytes "
                  f"{row['two_pass_bytes_ms']:.4f} ms)", flush=True)
        del V, R, ct, v, v64, fwd, bwd, ref, dv_64, out
    _check_bias(bias_rows, SWEEP_BIAS_TOL, "cuBLAS TF32")
    if too_far:
        raise AssertionError(f"ggn_sweep further from float64 than allowed: {too_far}")
    return rows


def _stochastic_config(workdir: Path) -> str:
    """lenet5_mnist.yml with only ip.epochs cut, 250 -> 3."""
    return _cut_config(workdir, CONFIG, {250: 3}, "lenet5_mnist_z_steps_cut.yml")


def _warm_stochastic_step(state, Z, X, alpha, beta, gamma, probes, slq_samples,
                          num_matvecs, reps: int = 2) -> dict:
    """Host seconds of the parts of a warm stochastic Z step (device
    synchronised), median of ``reps`` after one warm-up, and its peak memory."""
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.ops import slq as slq_mod
    from laplace_inducing_points_tpu_torch.ops import stochtrace as st
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
    from laplace_inducing_points_tpu_torch.training import inducing as ind
    names = ("rows", "gram_cholesky", "hutchpp", "slq", "backward", "pullback")
    parts = {key: [] for key in names}
    s1, s2 = ind.probe_split(probes.shape[0])
    for _ in range(reps + 1):
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            (Rz, Rx), rows_s = _host_s(lambda: (ops.dense_wt(state, Z), ops.dense_wt(state, X)))
        Rz.requires_grad_()
        L, chol_s = _host_s(lambda: ind._c_cholesky(syrk(Rz), alpha, beta))
        trace, hpp_s = _host_s(lambda: st.hutchpp(
            ind.stochastic_composite(Rz, Rx, L, alpha, gamma), probes, s1=s1, s2=s2))
        stacked, stacked_t = ind.stacked_operator(Rz, alpha, beta)
        logdet, slq_s = _host_s(lambda: slq_mod.slq_logdet_product(
            stacked, probes[:slq_samples], num_matvecs, t_matvec=stacked_t))
        (ct,), bwd_s = _host_s(lambda: torch.autograd.grad(trace + logdet, Rz))
        _, pull_s = _host_s(lambda: ops.dense_wt_pullback(state, Z, ct))
        for key, val in zip(names, (rows_s, chol_s, hpp_s, slq_s, bwd_s, pull_s)):
            parts[key].append(val)
        del Rz, Rx, L, trace, logdet, ct
    split = {key: statistics.median(vals[1:]) for key, vals in parts.items()}
    split["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return split


def phase_stochastic(workdir: Path, train: dict) -> dict:
    """The port's trainer with the stochastic objective on LeNet5 at full
    width, from phase 7's MAP weights, then evaluation of its Z; the launch
    counts of both are read together."""
    print("== phase 10: stochastic path (cli.train_scale.main train_inducing --objective "
          "stochastic, then cli.evaluate.main)", flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale
    from laplace_inducing_points_tpu_torch.ops import stochtrace as st
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    config = _stochastic_config(workdir)
    ip = load_experiment_config(config)["optimization"]["ip"]
    print(f"config {CONFIG} with ip.epochs 250 -> {ip['epochs']}; as shipped: M={ip['m']}, "
          f"ip.batch_size={ip['batch_size']}, st_samples={ip['st_samples']}, slq_samples="
          f"{ip['slq_samples']}, slq_num_matvecs={ip['slq_num_matvecs']}, alpha_ip="
          f"{train['alpha']}")
    common = ["--dataset", "mnist", "--config", config, "--device", "cuda",
              "--ckpt_map", train["map_dir"], "--ckpt_induc", str(workdir / "stoch_ind"),
              "--data_dir", train["data_dir"]]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    result = train_scale.main(["train_inducing", "--objective", "stochastic", "--alpha_ip",
                               str(train["alpha"]), "--train_log",
                               str(workdir / "stoch_log.jsonl"), *common])
    run_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = evaluate.main(["--scalable", "--predictive", "weight", "--iters", "1",
                             "--max_batches", "2", *common])
    launches = _read_counts()
    print(f"launches during the stochastic path: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the stochastic path")
    ind = result["inducing"]
    losses = [r["loss"] for r in ind["rows"]]
    if ind["objective"] != "stochastic":
        raise AssertionError(f"the run trained {ind['objective']!r}")
    if len(losses) != ip["epochs"] or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"Z-step losses: {losses}")
    if not (result["Z_moved"] > 0.0):
        raise AssertionError("Z did not move")
    for key in ("nll", "acc", "brier", "ece"):
        if not math.isfinite(records[0][key]):
            raise AssertionError(f"evaluation of the stochastic Z: {key}={records[0][key]}")
    print(f"Z: {ind['steps']} steps, first {ind['first_step_seconds']:.3f} s, warm median "
          f"{ind['seconds_per_step']:.4f} s per step; losses "
          f"{', '.join(f'{v:.8g}' for v in losses)}; max |Z - Z0| = {result['Z_moved']:.4g}; "
          f"peak memory of the run {run_peak_gib:.2f} GiB")
    print(f"evaluation of the stochastic Z: nll={records[0]['nll']:.5f} "
          f"acc={records[0]['acc']:.5f} brier={records[0]['brier']:.5f} "
          f"ece={records[0]['ece']:.5f}")
    state, X, Z = train["state"], train["X"], train["Z"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    probes = st.rademacher_probes(gen, ip["st_samples"], state.spec.num_params)
    split = _warm_stochastic_step(state, Z, X, train["alpha"], train["beta"], train["gamma"],
                                  probes, ip["slq_samples"], ip["slq_num_matvecs"])
    print(f"warm stochastic Z step split (host clock, synchronised, median of 2): rows "
          f"{split['rows']:.4f} s, Gram + Cholesky {split['gram_cholesky']:.4f} s, Hutch++ "
          f"sweeps {split['hutchpp']:.4f} s, SLQ loop {split['slq']:.4f} s, backward "
          f"{split['backward']:.4f} s, row pullback {split['pullback']:.4f} s; peak memory "
          f"{split['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated)")
    return {"launches": launches, "ip": ip}


ESTIMATOR_DRAWS = 8   # probe draws behind the estimator's spread and the TF32 shift


def phase_estimator_agreement(train: dict, ip: dict) -> None:
    """One stochastic Z step's KL and dL/dZ on the same probes: (a) the
    kernel path, (b) the kernels with the FP32 sweep, (c) the plain FP32
    path, each against float64 of the same row algebra, each ∂L/∂Rz pulled
    back through the same f32 row build; beside the estimator's spread over
    ESTIMATOR_DRAWS probe draws of the kernel path. Gates: (b) no further
    from float64 than F64_RATIO times (c); (a) within 0.1 times the spread:
    for the KL value, the root mean square over the draws of (a)'s shift from
    float64 on each (one draw's shift against a spread of four swung from
    0.0003 to 0.13 of it over probe seeds, with FFMA B2/B3 kernels too); for dL/dZ,
    the first draw's."""
    print("== phase 11: estimator agreement of one stochastic Z step", flush=True)
    import functools

    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.ops import stochtrace as st
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                                   matmul_nn_plain,
                                                                   matmul_nt,
                                                                   matmul_nt_plain)
    from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep, ggn_sweep_plain
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain
    from laplace_inducing_points_tpu_torch.training import inducing as ind
    state, Z, X = train["state"], train["Z"], train["X"]
    consts = (train["alpha"], train["beta"], train["gamma"])
    knobs = (ip["slq_samples"], ip["slq_num_matvecs"])
    products = {
        "kernel": ind.KERNEL_PRODUCTS,
        "kernel_fp32_sweep": ind.Products(syrk, matmul_nt, matmul_nn,
                                          functools.partial(ggn_sweep, precision="highest")),
        "plain": ind.Products(syrk_plain, matmul_nt_plain, matmul_nn_plain, ggn_sweep_plain),
    }
    with torch.no_grad():
        Rz, Rx = ops.dense_wt(state, Z), ops.dense_wt(state, X)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def draw():
        return st.rademacher_probes(gen, ip["st_samples"], state.spec.num_params)

    def value_and_dz(probes, prods, dtype=torch.float32):
        v, ct = ind.kl_stochastic_rows_value_and_grad(
            Rz.to(dtype), Rx.to(dtype), *consts, probes.to(dtype), *knobs, products=prods)
        return float(v), ops.dense_wt_pullback(state, Z, ct.float())

    probes = draw()
    out = {key: value_and_dz(probes, prods) for key, prods in products.items()}
    out["float64"] = value_and_dz(probes, products["plain"], torch.float64)
    pairs = [(out["kernel"], out["float64"])]    # (kernel path, float64) per draw
    for _ in range(ESTIMATOR_DRAWS - 1):
        more = draw()
        pairs.append((value_and_dz(more, products["kernel"]),
                      value_and_dz(more, products["plain"], torch.float64)))
    draws = [kernel for kernel, _ in pairs]
    torch.cuda.synchronize()
    v64, g64 = out["float64"]
    val_err = {key: abs(v - v64) / abs(v64) for key, (v, _) in out.items()}
    grad_err = {key: _rel(g, g64) for key, (_, g) in out.items()}
    shift_rms = math.sqrt(statistics.fmean((k[0] - f[0]) ** 2 for k, f in pairs))
    values = torch.tensor([v for v, _ in draws], dtype=torch.float64)
    grads = torch.stack([g.double() for _, g in draws])
    mean_g = grads.mean(0)
    value_spread = float(values.std())
    grad_spread = float(torch.sqrt(((grads - mean_g) ** 2).sum() / len(draws))
                        / torch.linalg.norm(mean_g))
    for key in ("kernel", "kernel_fp32_sweep", "plain"):
        print(f"  {key:17s} KL {out[key][0]:.10g} (rel vs f64 {val_err[key]:.3e}, abs "
              f"{abs(out[key][0] - v64):.4g}); dL/dZ rel-L2 vs f64 {grad_err[key]:.3e}")
    print(f"  float64           KL {v64:.12g}")
    print(f"  spread over {len(draws)} probe draws (kernel path): KL std {value_spread:.4g} "
          f"(relative {value_spread / abs(v64):.3e}; values "
          f"{', '.join(f'{v:.10g}' for v in values.tolist())}); dL/dZ relative spread "
          f"{grad_spread:.3e}")
    print(f"  TF32 shift of the KL value on each draw: "
          f"{', '.join(f'{k[0] - f[0]:+.4g}' for k, f in pairs)}; root mean square "
          f"{shift_rms:.4g}")
    print(f"  TF32 shift / spread: KL {shift_rms / value_spread:.3e} (first draw alone "
          f"{abs(out['kernel'][0] - v64) / value_spread:.3e}), dL/dZ "
          f"{grad_err['kernel'] / grad_spread:.3e}")
    if not all(math.isfinite(v) for v, _ in out.values()):
        raise AssertionError(f"KL values not finite: {out}")
    for what, err in (("KL value", val_err), ("dL/dZ", grad_err)):
        if not err["kernel_fp32_sweep"] <= F64_RATIO * err["plain"]:
            raise AssertionError(f"{what}: FP32 kernel path {err['kernel_fp32_sweep']:.3e} "
                                 f"from float64, more than {F64_RATIO} x the plain path's "
                                 f"{err['plain']:.3e}")
    if not shift_rms < 0.1 * value_spread:
        raise AssertionError(f"KL value: the TF32 path is {shift_rms:.4g} from float64 "
                             f"(root mean square over {len(pairs)} draws), not below 0.1 x "
                             f"the spread {value_spread:.4g}")
    if not grad_err["kernel"] < 0.1 * grad_spread:
        raise AssertionError(f"dL/dZ: the TF32 path is {grad_err['kernel']:.3e} from "
                             f"float64, not below 0.1 x the spread {grad_spread:.3e}")


# The gram path on the scale configs beyond LeNet5: (label, config, dataset,
# the config's epochs lines cut (map, ip), the alpha of the Z training: None
# for the grid search, as shipped; the flagship's header prescribes 10).
# ResNet1M keeps 10 MAP epochs (310 steps): after one (31 steps) its BatchNorm
# running statistics are 27% of the way from their initial values (momentum
# 0.99), the eval-mode network's test NLL is ~80, softmax probabilities
# underflow to 0 and d√p/dp = inf makes dL/dZ NaN at the first Z step, in
# the reference's algebra as in the port's
SCALE_PATHS = {
    "mlp_mnist": ("configs/scale/mlp_mnist.yml", "mnist", {100: 1, 250: 3}, None),
    "resnet1m_cifar10": ("configs/scale/resnet1m_cifar10.yml", "cifar10", {75: 10, 100: 3},
                         10.0),
}
# kernels of these paths (with B2's and B3's tiled path), each listed in the
# kernels JSON as "<kernel>@<label>"
SCALE_KERNELS = ("syrk", "matmul_nt", "matmul_nn", "syrk_backward", "matmul_nt_backward")


def _scale_kernels(label: str, d_z: int, d_x: int, D: int, extra: tuple = ()) -> dict:
    """Each kernel of a scale path at that path's shapes (the Gram of Z's rows,
    the cross-Gram, the serving products at S = 200, and ``extra``) against
    its plain version and float64 by phase 3's rules (its bias too), timed;
    the Gram exactly symmetric; the backward passes of the Gram and the
    cross-Gram against plain and float64 autograd, timed with their library
    products. Returns the timed rows by JSON name."""
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                                   matmul_nn_plain,
                                                                   matmul_nt,
                                                                   matmul_nt_plain)
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    S = 200
    Rz, Rx = randn(d_z, D), randn(d_x, D)
    rows, checked = {}, []
    print(f"  {label}: d_z={d_z}, d_x={d_x}, D={D} (Rz {4 * d_z * D / 1e9:.2f} GB)", flush=True)
    rows["syrk"] = _check_kernel("syrk", syrk, syrk_plain, (Rz,), timed=True)
    C = syrk(Rz)
    if not torch.equal(C, C.T):
        raise AssertionError(f"syrk {(d_z, D)}: not exactly symmetric")
    print(f"  syrk {(d_z, D)} exactly symmetric: True")
    del C
    rows["matmul_nt.cross_gram"] = _check_path("matmul_nt", "tiled", matmul_nt,
                                               matmul_nt_plain, (Rx, Rz), True)
    rows["matmul_nt"] = _check_path("matmul_nt", "tiled", matmul_nt, matmul_nt_plain,
                                    (randn(S, D), Rz), True)
    rows["matmul_nn"] = _check_path("matmul_nn", "tiled", matmul_nn, matmul_nn_plain,
                                    (randn(S, d_z), Rz), True)
    for name, inputs in extra:
        kernel, plain = {"syrk": (syrk, syrk_plain), "matmul_nt": (matmul_nt, matmul_nt_plain),
                         "matmul_nn": (matmul_nn, matmul_nn_plain)}[name]
        inputs = tuple(f(gen) for f in inputs)
        checked.append((f"{name} {' x '.join(str(tuple(t.shape)) for t in inputs)}",
                        _check_kernel(name, kernel, plain, inputs, timed=True)))
        del inputs
    checked += [(f"{name} at {label}", rows[name])
                for name in ("syrk", "matmul_nt.cross_gram", "matmul_nt", "matmul_nn")]
    _check_bias([(key, row["bias"], row["plain_bias"], row["plain_rel_vs_f64"], row["outputs"])
                 for key, row in checked])
    ct_zz, ct_xz = randn(d_z, d_z), randn(d_x, d_z)
    sym_zz = ct_zz + ct_zz.T
    rows["syrk_backward"] = _check_backward(
        "syrk_backward", syrk, syrk_plain, (Rz,), (True,), ct_zz, timed=True,
        library=lambda: torch.mm(sym_zz, Rz))
    rows["syrk_backward"].update(bound(2 * d_z * d_z * D, 4 * (2 * d_z * D + d_z * d_z),
                                       _peak(rows["syrk_backward"]["paths"])))
    rows["matmul_nt_backward"] = _check_backward(
        "matmul_nt_backward", matmul_nt, matmul_nt_plain, (Rx, Rz), (False, True), ct_xz,
        timed=True, library=lambda: torch.mm(ct_xz.T, Rx))
    rows["matmul_nt_backward"].update(bound(2 * d_z * d_x * D,
                                            4 * (d_x * D + d_x * d_z + d_z * D),
                                            _peak(rows["matmul_nt_backward"]["paths"])))
    for name in ("syrk_backward", "matmul_nt_backward"):
        row = rows[name]
        print(f"  {name:22s} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; FP32 FFMA "
              f"{row['bound_fp32_ms']:.4f}); paths {sorted(row['paths'])}", flush=True)
    del Rz, Rx, ct_zz, ct_xz, sym_zz
    torch.cuda.empty_cache()
    return rows


def _scale_state(model_cfg: dict, dataset: str, map_dir: str):
    """The trained MAP of a scale path, weights and statistics, on the card."""
    from laplace_inducing_points_tpu_torch.data.scale import DATASET_SHAPES
    from laplace_inducing_points_tpu_torch.models.registry import get_model
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.utils.checkpoint import (load_batch_stats,
                                                                    load_params)
    flat, _, _ = load_params(map_dir, f"map_{dataset}")
    stats = load_batch_stats(map_dir, f"map_{dataset}")
    model = get_model(model_cfg, DATASET_SHAPES[dataset][0]).cuda()
    return ModelState(model, flat.cuda(), model_cfg["type"],
                      {key: t.cuda() for key, t in stats.items()})


def phase_scale_path(workdir: Path, label: str, phase: str) -> dict:
    """A scale config through the port's entry points at full width, only the
    step counts cut: ``cli.train_scale.main full_pipeline`` (alpha from the
    grid search where the config ships none) and ``cli.evaluate.main`` on 2
    test batches; the MLP also takes one ``update_alpha`` step on a batch of
    256 of its trained MAP. The launch counts of the whole run are read
    together; every kernel of the gram path must have been launched."""
    config, dataset, cuts, alpha_ip = SCALE_PATHS[label]
    print(f"== {phase}: {label} (cli.train_scale.main full_pipeline, then "
          f"cli.evaluate.main)", flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale
    from laplace_inducing_points_tpu_torch.data.scale import get_dataloaders
    from laplace_inducing_points_tpu_torch.training.alpha import (make_alpha_optimizer,
                                                                  update_alpha)
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_array
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    cut = _cut_config(workdir, config, cuts, f"{label}_steps_cut.yml")
    cfg = load_experiment_config(cut)
    opt, ip, sampling = cfg["optimization"], cfg["optimization"]["ip"], cfg["sampling"]
    (map_from, map_to), (ip_from, ip_to) = cuts.items()
    print(f"config {config} with step counts cut: map.epochs {map_from} -> {map_to}, "
          f"ip.epochs {ip_from} -> {ip_to}; as shipped: model {cfg['model']['name']}, "
          f"M={ip['m']}, ip.batch_size={ip['batch_size']}, map.batch_size="
          f"{opt['map']['batch_size']}, S={ip['mc_samples']}, example_block="
          f"{ip['example_block']}, sample_block={sampling['sample_block']}, alpha "
          f"{'from the grid search' if alpha_ip is None else alpha_ip}")
    dirs = {key: str(workdir / f"{label}_{key}") for key in ("map", "ind", "data")}
    common = ["--dataset", dataset, "--config", cut, "--device", "cuda",
              "--ckpt_map", dirs["map"], "--ckpt_induc", dirs["ind"], "--data_dir",
              dirs["data"]]
    alpha_args = [] if alpha_ip is None else ["--alpha_ip", str(alpha_ip)]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    result = train_scale.main(["full_pipeline", *alpha_args, "--train_log",
                               str(workdir / f"{label}_log.jsonl"), *common])
    run_peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    records = evaluate.main(["--scalable", "--predictive", "weight", "--iters", "1",
                             "--max_batches", "2", *common])
    state = _scale_state(cfg["model"], dataset, dirs["map"])
    evidence = None
    if alpha_ip is None:
        train_loader, _, _ = get_dataloaders(dataset, opt["map"]["batch_size"], aug=False,
                                             root=dirs["data"])
        x = torch.as_tensor(next(iter(train_loader))[0]).cuda()
        log_alpha = torch.tensor(math.log(opt["alpha"]), device="cuda", requires_grad=True)
        (value, slope), evidence_s = _host_s(lambda: update_alpha(
            log_alpha, make_alpha_optimizer(log_alpha), x, state, opt["full_set_size"],
            ip["example_block"]))
        evidence = {"value": float(value), "slope": float(slope), "seconds": evidence_s,
                    "alpha_after": math.exp(log_alpha.item()), "batch": x.shape[0]}
    launches = _read_counts()
    print(f"launches during the {label} path: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0 and name not in GRAM_PATH_UNUSED:
            raise AssertionError(f"{name} was not launched by the {label} path")
    if "inducing" not in result:
        raise AssertionError(f"{label}: the Z training diverged at its first step")
    map_stats, ind, alpha = result["map"], result["inducing"], result["alpha"]
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
    print(f"alpha_ip = {alpha['alpha_ip']:.6g} ({alpha['alpha_src']})")
    if alpha_ip is None:
        for a, nll in alpha["grid"]:
            print(f"  grid point alpha={a:.6g}: validation NLL {nll:.6f}")
        nlls = [nll for _, nll in alpha["grid"]]
        if len(nlls) != 11 or not all(math.isfinite(v) for v in nlls):
            raise AssertionError(f"grid-search NLLs: {alpha['grid']}")
        if not (alpha["alpha_src"] == "grid" and 10.0 <= alpha["alpha_ip"] <= 1000.0):
            raise AssertionError(f"selected alpha {alpha}")
        print(f"update_alpha on the trained MAP, batch {evidence['batch']} (B1 at "
              f"({evidence['batch'] * 10}, {state.spec.num_params})): log evidence "
              f"{evidence['value']:.8g}, d/dlog alpha {evidence['slope']:.6g}, alpha "
              f"{opt['alpha']} -> {evidence['alpha_after']:.6g}, {evidence['seconds']:.3f} s")
        if not (math.isfinite(evidence["value"]) and math.isfinite(evidence["slope"])):
            raise AssertionError(f"log evidence not finite: {evidence}")
    print(f"MAP: {map_stats['steps']} steps, first {map_stats['first_step_s']:.4f} s, "
          f"warm median {map_stats['s_per_step']:.5f} s per step; loss "
          f"{map_stats['loss_first']:.4f} -> {map_stats['loss_last']:.4f}")
    print(f"Z: {ind['steps']} steps, first {ind['first_step_seconds']:.3f} s, warm median "
          f"{ind['seconds_per_step']:.4f} s per step; losses "
          f"{', '.join(f'{v:.8g}' for v in losses)}; max |Z - Z0| = {result['Z_moved']:.4g}; "
          f"peak memory of the training run {run_peak_gib:.2f} GiB above the "
          f"{base / 2**30:.2f} GiB allocated before it")
    print(f"evaluation: factor build {records[0]['factor_s']:.3f} s, {records[0]['batches']} "
          f"batches in {records[0]['wallclock_s']:.3f} s ({records[0]['per_batch_s']:.3f} s "
          f"per batch); nll={records[0]['nll']:.5f} acc={records[0]['acc']:.5f} "
          f"brier={records[0]['brier']:.5f} ece={records[0]['ece']:.5f}")
    Z = torch.as_tensor(load_array(dirs["ind"], f"ind_{dataset}", ip["epochs"])).cuda()
    ip_loader, test_loader, _ = get_dataloaders(dataset, ip["batch_size"], aug=False,
                                                root=dirs["data"])
    X = torch.as_tensor(next(iter(ip_loader))[0]).cuda()
    N = opt["full_set_size"]
    return {"launches": launches, "state": state, "Z": Z, "X": X,
            "alpha": alpha["alpha_ip"], "beta": N / Z.shape[0], "gamma": N / X.shape[0],
            "example_block": ip["example_block"], "sample_block": sampling["sample_block"],
            "S": ip["mc_samples"], "N": N, "data_dir": dirs["data"], "dataset": dataset,
            "test_batch": opt["map"]["batch_size"], "map_stats": map_stats, "ind": ind}


def phase_scale_timings(train: dict, label: str) -> None:
    """Warm timings of a scale path on its trained MAP and Z: the split and
    peak memory of a Z step (rows and pullback in example blocks), the factor
    build and one serving batch (B = the MAP batch, S as shipped, pushed
    forward in sample blocks)."""
    from laplace_inducing_points_tpu_torch.data.scale import get_dataloaders
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
    state, Z, X = train["state"], train["Z"], train["X"]
    split = _warm_z_step(state, Z, X, train["alpha"], train["beta"], train["gamma"],
                         reps=2, example_block=train["example_block"])
    print(f"{label} warm Z step split (host clock, synchronised, median of 2): rows "
          f"{split['rows']:.4f} s, Gram algebra forward incl. Cholesky "
          f"{split['gram_forward']:.4f} s, its backward {split['gram_backward']:.4f} s, "
          f"row pullback {split['pullback']:.4f} s; peak memory above the "
          f"{split['base_gib']:.2f} GiB allocated before: row build "
          f"{split['rows_peak_gib']:.2f} GiB, whole step {split['peak_gib']:.2f} GiB")
    _, test_loader, _ = get_dataloaders(train["dataset"], train["test_batch"], aug=False,
                                        root=train["data_dir"])
    x = torch.as_tensor(next(iter(test_loader))[0]).cuda()
    with torch.no_grad():
        builds = [_host_s(lambda: ScalableLLAPredictor(
            state, Z, full_set_size=train["N"], example_block=train["example_block"],
            range_clip_min=1.0, sample_block=train["sample_block"])) for _ in range(2)]
        pred = builds[-1][0]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
        batches = [_host_s(lambda: pred.logit_samples(x, train["alpha"], gen, train["S"]))
                   for _ in range(3)]
    out = batches[-1][0]
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: serving logit samples not finite")
    print(f"{label} factor build, warm: {builds[-1][1]:.3f} s (first here "
          f"{builds[0][1]:.3f} s); one serving batch {tuple(out.shape)}, warm: "
          f"{statistics.median(s for _, s in batches[1:]):.4f} s (first {batches[0][1]:.4f} s)")


# ---------------------------------------------------------------------------
# the matfree slice (phases 17-21): LeNet5 at M = 1,024 and 4,096
# ---------------------------------------------------------------------------

MATFREE = {"matfree1k": "configs/scale/lenet5_mnist_matfree1k.yml",
           "matfree4k": "configs/scale/lenet5_mnist_matfree4k.yml"}
ALPHA_4K = 50.0       # lenet5_mnist_matfree4k.yml's header (lines 19-26): --alpha_ip 50
CONTRACT_RANKS = (0, 16, 64)        # phase 19(a): precond_rank x cg_maxiter
CONTRACT_MAXITERS = (25, 50, 100)
SPREAD_DRAWS = 4                    # probe draws behind dL/dZ's spread, phase 19(a)
# phase 19(a)'s limits on matfree dL/dZ solved tightly (rank 64, tol 1e-6,
# maxiter 500) against the materialized one without its pivot jitter:
# measured 0.0023-0.0072 at alpha 1,000; losing the SLQ route gives
# 0.088-0.19, a zero dL/dZ 1 and 0. At the shipped tol 1e-3 the distance is
# set by cg_tol and, against the shipped materialized objective, by its
# jitter, not by the code (0.02-0.15 at alpha 1,000, 0.99 once), so only
# the gate below the probe spread holds there
CONTRACT_TOL, CONTRACT_TIGHT_MAXITER = 1e-6, 500
CONTRACT_REL, CONTRACT_COS = 0.05, 0.998
DESCENT_STEPS = 20                  # phase 19(b)
DESCENT_IMAGES = 2560
DESCENT_DRAWS = 8
# phase 19(b)'s limit on |Z_free - Z_mat| / |Z_mat - Z0|: measured 0.13-0.21;
# a trainer that leaves Z where it is gives 1
TRAJECTORY_APART = 0.5
MATFREE_KERNELS = ("ggn_sweep", "ggn_sweep_backward")    # the matfree1k CLI path's
MATHERON_KERNELS = ("syrk", "matmul_nt", "matmul_nn")    # the materialized sampler's


@contextlib.contextmanager
def _cg_solves():
    """Record ``(right-hand sides, iterations, worst relative residual)`` of
    every batched CG solve run inside, forward and backward."""
    from laplace_inducing_points_tpu_torch.ops import cg
    core, log = cg._cg_core, []

    def logged(matmat, B, **kwargs):
        X, info = core(matmat, B, **kwargs)
        log.append((B.shape[0], info.iterations, info.rel_residual))
        return X, info

    cg._cg_core = logged
    try:
        yield log
    finally:
        cg._cg_core = core


@contextlib.contextmanager
def _no_pivot_jitter():
    """The materialized objective without its Cholesky pivot jitter (2e-6 of
    C's Gershgorin bound, about 2.3 beside rho = alpha/beta = 125 at phase
    18's alpha): the same function as the matfree objective, whose CG
    solves ``C = G + rho I`` as it stands."""
    from laplace_inducing_points_tpu_torch.training import inducing as ind
    real = ind._pivot_jitter
    ind._pivot_jitter = lambda C: torch.zeros((), dtype=C.dtype, device=C.device)
    try:
        yield
    finally:
        ind._pivot_jitter = real


def _solves_line(solves) -> str:
    return ", ".join(f"{p} rhs: {k} it ({r:.1e})" for p, k, r in solves)


def _seeded_lenet5(seed: int):
    """LeNet5 on the card with numpy lecun-normal weights from ``seed``."""
    from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                               params_from_jax)
    from laplace_inducing_points_tpu_torch.models.scale import LeNet5
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(LeNet5()), seed))
    return ModelState(LeNet5().cuda(), flat.cuda(), "classifier")


def phase_operators(workdir: Path) -> None:
    """The matrix-free operators at M = 1,024 (d = 10,240) on seeded LeNet5
    weights and the first 1,024 surrogate training images: the blocked factor
    against the monolithic one (value and dL/dZ of <Y, gram_matmat(X)>), the
    Gram action against the rows through B1 and through B3 then B2 and a
    float64 evaluation, and preconditioned CG against a float64 Cholesky
    solve of C = G + (alpha/beta) I at the 4k header's alpha."""
    print("== phase 17: matrix-free operators on the card (M = 1,024)", flush=True)
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    from laplace_inducing_points_tpu_torch.ops.cg import cg_batched
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
    from laplace_inducing_points_tpu_torch.ops.nystrom import precond_from_sketch
    from laplace_inducing_points_tpu_torch.training.inducing import matfree_sketch
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    cfg = load_experiment_config(MATFREE["matfree1k"])
    opt, ip = cfg["optimization"], cfg["optimization"]["ip"]
    state = _seeded_lenet5(cfg["model"]["seed"])
    x_train, _ = load_arrays("mnist", train=True, root=str(workdir / "matfree1k_data"))
    M, blk, P = ip["m"], ip["cg_example_block"], 4
    Z = torch.as_tensor(x_train[:M]).cuda()
    d = M * 10
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    Xp, Yp, B = (torch.randn(P, d, generator=gen, device="cuda") for _ in range(3))
    out = {}
    for name, make in (("one block", lambda z: ops.make_w_factor(state, z)),
                       (f"blocks of {blk}",
                        lambda z: ops.make_w_factor(state, z, example_block=blk))):
        z = Z.clone().requires_grad_()

        def run():
            value = torch.sum(Yp * make(z).gram_matmat(Xp))
            return value.detach(), torch.autograd.grad(value, z)[0]

        run()
        torch.cuda.reset_peak_memory_stats()
        (value, grad), seconds = _host_s(run)
        out[name] = (value, grad, seconds, torch.cuda.max_memory_allocated() / 2**30)
    (v0, g0, s0, p0), (v1, g1, s1, p1) = out.values()
    rel_v, rel_g = abs(float(v1 - v0)) / abs(float(v0)), _rel(g1, g0)
    print(f"  <Y, gram_matmat(X)> at P={P}: W factor in one block {float(v0):.8g} ({s0:.3f} s "
          f"with dL/dZ, peak {p0:.2f} GiB), in blocks of {blk} {float(v1):.8g} ({s1:.3f} s, "
          f"peak {p1:.2f} GiB); value rel {rel_v:.2e}, dL/dZ rel {rel_g:.2e}", flush=True)
    if not (rel_v <= 1e-5 and rel_g <= 1e-4):
        raise AssertionError(f"blocked factor vs one block: value {rel_v:.2e}, dZ {rel_g:.2e}")
    blocked = ops.make_w_factor(state, Z, example_block=blk)
    with torch.no_grad():
        Rz = ops.dense_wt(state, Z)
        G = syrk(Rz)
        free, free_s = _host_s(lambda: blocked.gram_matmat(Xp))
        via_b1 = Xp @ G
        via_rows = matmul_nt(matmul_nn(Xp, Rz), Rz)
        ref = (Xp.double() @ Rz.double()) @ Rz.double().T
    errs = {"matrix-free": _rel(free, ref), "syrk(Rz)": _rel(via_b1, ref),
            "matmul_nn then matmul_nt": _rel(via_rows, ref)}
    print(f"  gram_matmat ({free_s:.3f} s, P={P}) vs float64 rows: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; matrix-free vs syrk(Rz) {_rel(free, via_b1):.2e}", flush=True)
    if not errs["matrix-free"] <= REL_TOL:
        raise AssertionError(f"gram_matmat vs float64 rows: {errs['matrix-free']:.2e}")
    rho = ALPHA_4K / (opt["full_set_size"] / M)
    C64 = G.double() + rho * torch.eye(d, device="cuda", dtype=torch.float64)
    x_ref = torch.cholesky_solve(B.double().T, torch.linalg.cholesky(C64)).T
    x_f32 = torch.cholesky_solve(B.T, torch.linalg.cholesky(G + rho * torch.eye(d, device="cuda"))).T
    lam_max = float(torch.linalg.eigvalsh(C64)[-1]) - rho
    del Rz, G, C64
    sketch, sketch_s = _host_s(lambda: matfree_sketch(state, Z, ip["precond_rank"], gen,
                                                      ip["precond_power"], blk))
    for label, precond in (("Nystrom rank %d, power %d" % (ip["precond_rank"],
                                                           ip["precond_power"]),
                            precond_from_sketch(*sketch, rho)), ("none", None)):
        (xs, info), seconds = _host_s(lambda: cg_batched(
            lambda V: blocked.gram_matmat(V) + rho * V, B, tol=1e-6, maxiter=500,
            precond=precond))
        err = _rel(xs, x_ref)
        print(f"  CG (tol 1e-6, maxiter 500, preconditioner {label}) on C = G + {rho:g} I "
              f"(lambda_max {lam_max:.4g}, kappa {(lam_max + rho) / rho:.4g}): "
              f"{info.iterations} iterations, residual {info.rel_residual:.2e}, "
              f"{seconds:.3f} s; rel error vs float64 Cholesky {err:.2e} (f32 Cholesky "
              f"{_rel(x_f32, x_ref):.2e}); sketch {sketch_s:.3f} s", flush=True)
        if precond is not None and not (info.iterations < 500 and err <= 1e-3):
            raise AssertionError(f"preconditioned CG: {info.iterations} iterations, "
                                 f"error {err:.2e}")


def _warm_matfree_step(state, Z, X, alpha, beta, gamma, ip, reps: int = 1) -> dict:
    """Host seconds of the parts of a warm matfree Z step (device
    synchronised), median of ``reps`` after one warm-up: the Nystrom sketch,
    the Hutch++ trace term (its CG solves), the SLQ log-det, the backward
    (its CG solves); every solve's iterations; the peak memory above what
    was allocated before."""
    from laplace_inducing_points_tpu_torch.ops import stochtrace as st
    from laplace_inducing_points_tpu_torch.training import inducing as ind
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    knobs = {key: ip[key] for key in ("cg_tol", "cg_maxiter", "cg_example_block")}
    names = ("sketch", "trace", "slq", "backward")
    parts = {key: [] for key in names}
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sketch, sk_s = _host_s(lambda: ind.matfree_sketch(
            state, Z, ip["precond_rank"], gen, ip["precond_power"], ip["cg_example_block"]))
        probes = st.rademacher_probes(gen, ip["st_samples"], state.spec.num_params)
        z = Z.detach().requires_grad_()
        with _cg_solves() as solves:
            trace, tr_s = _host_s(lambda: ind.matfree_trace_term(
                z, X, state, alpha, beta, gamma, probes, sketch=sketch, **knobs))
            n_fwd = len(solves)
            logdet, slq_s = _host_s(lambda: ind.matfree_logdet_term(
                z, state, alpha, beta, probes[:ip["slq_samples"]], ip["slq_num_matvecs"]))
            (grad,), bwd_s = _host_s(lambda: torch.autograd.grad(trace + logdet, z))
        for key, val in zip(names, (sk_s, tr_s, slq_s, bwd_s)):
            parts[key].append(val)
        if not torch.isfinite(grad).all():
            raise AssertionError("matfree dL/dZ not finite")
        del trace, logdet, grad, z
    split = {key: statistics.median(vals[1:]) for key, vals in parts.items()}
    split.update(peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                 base_gib=base / 2**30, forward_solves=solves[:n_fwd],
                 backward_solves=solves[n_fwd:])
    return split


def _print_matfree_split(label: str, split: dict, smi: str) -> None:
    total = sum(split[k] for k in ("sketch", "trace", "slq", "backward"))
    print(f"{label} warm matfree Z step split (host clock, synchronised; {smi}): sketch "
          f"{split['sketch']:.3f} s, Hutch++ trace term with its CG solves "
          f"{split['trace']:.3f} s, SLQ log-det {split['slq']:.3f} s, backward (its CG "
          f"solves and the recomputed Krylov steps) {split['backward']:.3f} s; total "
          f"{total:.3f} s; peak memory {split['peak_gib']:.2f} GiB above the "
          f"{split['base_gib']:.2f} GiB allocated before", flush=True)
    print(f"  CG solves, forward: {_solves_line(split['forward_solves'])}; backward: "
          f"{_solves_line(split['backward_solves'])}", flush=True)


def phase_matfree_path(workdir: Path, smi: str) -> dict:
    """lenet5_mnist_matfree1k.yml through the port's entry points as shipped
    but for ip.epochs 60 -> 3: ``cli.train_scale.main full_pipeline`` (12 MAP
    epochs, the alpha grid search on the matfree predictive, 3 matfree Z
    steps, the healthchecks) and ``cli.evaluate.main --predictive matfree``
    on 2 test batches, twice (two generators). B4 and its backward must have
    been launched. Then a warm Z step's split, the sketch build cold and
    warm, and one serving batch."""
    label = "matfree1k"
    print(f"== phase 18: {label} as shipped (cli.train_scale.main full_pipeline, then "
          f"cli.evaluate.main --predictive matfree)", flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale
    from laplace_inducing_points_tpu_torch.data.scale import get_dataloaders
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_array
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    cut = _cut_config(workdir, MATFREE[label], {60: 3}, f"{label}_steps_cut.yml")
    cfg = load_experiment_config(cut)
    opt, ip, sampling = cfg["optimization"], cfg["optimization"]["ip"], cfg["sampling"]
    print(f"config {MATFREE[label]} with ip.epochs 60 -> {ip['epochs']}; as shipped: "
          f"map.epochs {opt['map']['epochs']}, M={ip['m']}, ip.batch_size={ip['batch_size']}, "
          f"st_samples={ip['st_samples']}, slq {ip['slq_samples']} x {ip['slq_num_matvecs']}, "
          f"cg_tol={ip['cg_tol']}, cg_maxiter={ip['cg_maxiter']}, precond "
          f"{ip['precond_rank']} (power {ip['precond_power']}), cg_example_block="
          f"{ip['cg_example_block']}; sampling cg_tol={sampling['cg_tol']}, cg_maxiter="
          f"{sampling['cg_maxiter']}; S={ip['mc_samples']}; alpha from the grid search")
    dirs = {key: str(workdir / f"{label}_{key}") for key in ("map", "ind", "data")}
    common = ["--dataset", "mnist", "--config", cut, "--device", "cuda", "--ckpt_map",
              dirs["map"], "--ckpt_induc", dirs["ind"], "--data_dir", dirs["data"]]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _cg_solves() as solves:
        result, train_s = _host_s(lambda: train_scale.main(
            ["full_pipeline", "--train_log", str(workdir / f"{label}_log.jsonl"), *common]))
    run_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    records = evaluate.main(["--scalable", "--predictive", "matfree", "--iters", "2",
                             "--max_batches", "2", *common])
    launches = _read_counts()
    print(f"launches during the {label} CLI path: {json.dumps(launches)}")
    for name in MATFREE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the {label} path")
    if "inducing" not in result:
        raise AssertionError(f"{label}: the Z training diverged at its first step")
    map_stats, ind, alpha = result["map"], result["inducing"], result["alpha"]
    losses = [r["loss"] for r in ind["rows"]]
    if len(losses) != ip["epochs"] or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"Z-step losses: {losses}")
    if not (result["Z_moved"] > 0.0):
        raise AssertionError("Z did not move")
    for rec in records:
        for key in ("nll", "acc", "brier", "ece", "cg_rel_residual"):
            if not math.isfinite(rec[key]):
                raise AssertionError(f"matfree evaluation: {key}={rec[key]}")
    for a, nll in alpha["grid"]:
        print(f"  grid point alpha={a:.6g}: validation NLL {nll:.6f} (matfree predictive)")
    if len(alpha["grid"]) != 11 or not all(math.isfinite(v) for _, v in alpha["grid"]):
        raise AssertionError(f"grid-search NLLs: {alpha['grid']}")
    hc = result["healthcheck_post"]
    print(f"alpha_ip = {alpha['alpha_ip']:.6g} ({alpha['alpha_src']}); whole training run "
          f"{train_s:.2f} s, peak memory {run_peak:.2f} GiB above the {base / 2**30:.2f} GiB "
          f"allocated before ({smi})")
    print(f"MAP: {map_stats['steps']} steps, first {map_stats['first_step_s']:.4f} s, warm "
          f"median {map_stats['s_per_step']:.5f} s per step; loss "
          f"{map_stats['loss_first']:.4f} -> {map_stats['loss_last']:.4f}")
    print(f"Z: {ind['steps']} matfree steps, first {ind['first_step_seconds']:.3f} s, warm "
          f"median {ind['seconds_per_step']:.3f} s per step ({smi}); losses "
          f"{', '.join(f'{v:.8g}' for v in losses)}; max |Z - Z0| = {result['Z_moved']:.4g}")
    print(f"healthcheck at the trained Z: residual {hc['cg_rel_residual']:.2e} after "
          f"{hc['cg_iterations']} iterations ({'converged' if hc['converged'] else 'STALLED'}), "
          f"lam_max {hc['lam_max']:.5g}, kappa {hc['kappa']:.5g}, kappa deflated "
          f"{hc['kappa_deflated']:.5g} (sketch {hc['kappa_deflated_sketch']:.5g}), predicted "
          f"iterations {hc['predicted_iters']:.1f}")
    print(f"CG solves of the whole training run (grid search, healthchecks, Z steps): "
          f"{len(solves)}, iterations {[k for _, k, _ in solves]}")
    for rec in records:
        print(f"evaluation iteration {rec['iter']}: sketch build {rec['factor_s']:.3f} s, "
              f"{rec['batches']} batches in {rec['wallclock_s']:.3f} s "
              f"({rec['per_batch_s']:.3f} s per batch; {smi}); worst CG residual "
              f"{rec['cg_rel_residual']:.2e}; nll={rec['nll']:.5f} acc={rec['acc']:.5f} "
              f"brier={rec['brier']:.5f} ece={rec['ece']:.5f}")
    state = _scale_state(cfg["model"], "mnist", dirs["map"])
    Z = torch.as_tensor(load_array(dirs["ind"], "ind_mnist", ip["epochs"])).cuda()
    ip_loader, test_loader, _ = get_dataloaders("mnist", ip["batch_size"], aug=False,
                                                root=dirs["data"])
    X = torch.as_tensor(next(iter(ip_loader))[0]).cuda()
    N = opt["full_set_size"]
    beta, gamma = N / Z.shape[0], N / X.shape[0]
    split = _warm_matfree_step(state, Z, X, alpha["alpha_ip"], beta, gamma, ip)
    _print_matfree_split(label, split, smi)
    knobs = {key: sampling[key] for key in ("cg_tol", "cg_maxiter", "precond_rank",
                                            "precond_power", "cg_example_block")}
    _, test_loader, _ = get_dataloaders("mnist", opt["map"]["batch_size"], aug=False,
                                        root=dirs["data"])
    x = torch.as_tensor(next(iter(test_loader))[0]).cuda()
    with torch.no_grad():
        builds = [_host_s(lambda: ScalableLLAPredictor(state, Z, full_set_size=N,
                                                       method="matfree", **knobs))
                  for _ in range(2)]
        pred = builds[-1][0]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
        batches = [_host_s(lambda: pred.logit_samples(x, alpha["alpha_ip"], gen,
                                                      ip["mc_samples"])) for _ in range(3)]
    print(f"{label} sketch build (the matfree factor): first in phase 18's evaluate "
          f"{records[0]['factor_s']:.3f} s, here {builds[0][1]:.3f} s, warm {builds[1][1]:.3f} s;"
          f" one serving batch {tuple(batches[-1][0].shape)}, warm "
          f"{statistics.median(s for _, s in batches[1:]):.3f} s (first {batches[0][1]:.3f} s), "
          f"worst CG residual {pred.last_cg_residual:.2e} ({smi})", flush=True)
    return {"launches": launches, "state": state, "Z": Z, "X": X, "alpha": alpha["alpha_ip"],
            "beta": beta, "gamma": gamma, "N": N, "ip": ip, "sampling": sampling,
            "records": records, "common": common, "dirs": dirs, "x_test": x,
            "z_init_dir": dirs["ind"]}


def _materialized_grad(mf: dict, probes):
    from laplace_inducing_points_tpu_torch.training import inducing as ind
    ip = mf["ip"]
    return ind.kl_value_and_grad_stochastic(
        mf["Z"], mf["X"], mf["state"], mf["alpha"], probes, full_set_size=mf["N"],
        st_samples=ip["st_samples"], slq_samples=ip["slq_samples"],
        slq_num_matvecs=ip["slq_num_matvecs"])


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b)))


def phase_acceptance(mf: dict, smi: str) -> None:
    """The JAX package's open acceptance checks on phase 18's MAP and Z
    (M = 1,024): (a) dL/dZ of the matfree objective against the
    materialized one without its pivot jitter on the same probes over
    precond_rank x cg_maxiter, gated at the shipped knobs against the
    materialized gradient's spread over probe draws (and the cosine of the
    draws' mean with the exact gram dL/dZ of the batch, printed), and solved
    tightly on five probe sets at fixed limits that a wrong gradient fails;
    (b) 20 matfree Z steps on 20 batches (2,560 images) from phase
    18's Z, against 20 materialized steps on the same probes and 20 gram
    steps: each one's change of the exact gram KL of those images beside
    the standard deviation of the stochastic estimate over 8 probe draws at
    the start (printed); gated: the matfree trajectory stays close to the
    materialized one; (c) trap C1: the healthcheck residual with cuDNN's
    TF32 on and off, same right-hand sides (printed, not gated)."""
    print("== phase 19: the acceptance checks of the matfree objective (M = 1,024)",
          flush=True)
    from laplace_inducing_points_tpu_torch.data.loader import cycling_batches
    from laplace_inducing_points_tpu_torch.data.scale import get_dataloaders
    from laplace_inducing_points_tpu_torch.ops import stochtrace as st
    from laplace_inducing_points_tpu_torch.training import inducing as ind
    state, Z, ip, D = mf["state"], mf["Z"], mf["ip"], mf["state"].spec.num_params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    probe_sets = [st.rademacher_probes(gen, ip["st_samples"], D)
                  for _ in range(1 + SPREAD_DRAWS)]
    probes = probe_sets[0]
    (_, g_jit), jit_s = _host_s(lambda: _materialized_grad(mf, probes))
    with _no_pivot_jitter():
        (v_mat, g_mat), mat_s = _host_s(lambda: _materialized_grad(mf, probes))
        refs = [g_mat] + [_materialized_grad(mf, p)[1] for p in probe_sets[1:]]
    draws = refs[1:]
    mean = sum(draws) / len(draws)
    spread = math.sqrt(sum(float(torch.sum((g - mean) ** 2)) for g in draws) / len(draws)) \
        / float(torch.linalg.norm(mean))
    _, g_gram = ind.kl_value_and_grad_gram(Z, mf["X"], state, mf["alpha"],
                                           full_set_size=mf["N"])
    print(f"  (a) materialized KL {float(v_mat):.8g}, dL/dZ in {mat_s:.3f} s; relative spread "
          f"of dL/dZ over {SPREAD_DRAWS} probe draws (RMS) {spread:.4f}; cosine of their mean "
          f"with the exact gram dL/dZ of the batch {_cos(mean, g_gram):.4f} (one draw's "
          f"{_cos(draws[0], g_gram):.4f})", flush=True)
    print(f"  (a) the materialized objective's pivot jitter moves its dL/dZ by rel-L2 "
          f"{_rel(g_jit, g_mat):.4e} (with it, as shipped: {jit_s:.3f} s); the matfree "
          f"dL/dZ below is held against the one without it", flush=True)
    sketches = {r: ind.matfree_sketch(state, Z, r, gen, ip["precond_power"],
                                      ip["cg_example_block"]) for r in CONTRACT_RANKS if r}

    def logdet_grad(p):
        # the SLQ log-det term does not depend on the CG knobs: once a probe set
        z = Z.detach().requires_grad_()
        logdet = ind.matfree_logdet_term(z, state, mf["alpha"], mf["beta"],
                                         p[:ip["slq_samples"]], ip["slq_num_matvecs"])
        (g,) = torch.autograd.grad(logdet, z)
        return logdet.detach(), g

    def matfree_grad(rank, maxiter, tol, p, logdet):
        z = Z.detach().requires_grad_()
        trace = ind.matfree_trace_term(
            z, mf["X"], state, mf["alpha"], mf["beta"], mf["gamma"], p,
            cg_tol=tol, cg_maxiter=maxiter, sketch=sketches.get(rank),
            cg_example_block=ip["cg_example_block"])
        (g_trace,) = torch.autograd.grad(trace, z)
        return trace.detach() + logdet[0], g_trace + logdet[1]

    logdet = logdet_grad(probes)
    shipped = None
    for rank in CONTRACT_RANKS:
        for maxiter in CONTRACT_MAXITERS:
            with _cg_solves() as solves:
                (v, g), s = _host_s(lambda: matfree_grad(rank, maxiter, ip["cg_tol"], probes,
                                                         logdet))
            rel, cos = _rel(g, g_mat), _cos(g, g_mat)
            print(f"  (a) precond_rank {rank:2d}, cg_maxiter {maxiter:3d}: KL {float(v):.8g} "
                  f"(rel {abs(float(v - v_mat)) / abs(float(v_mat)):.2e}), dL/dZ rel-L2 "
                  f"{rel:.4e}, cosine {cos:.6f}; trace term and its dL/dZ {s:.2f} s "
                  f"({smi}); solve iterations {[k for _, k, _ in solves]}", flush=True)
            if rank == ip["precond_rank"] and maxiter == ip["cg_maxiter"]:
                shipped = (rel, cos, _rel(g, g_jit))
    rel, cos, rel_jit = shipped
    print(f"  (a) gate at rank {ip['precond_rank']}, maxiter {ip['cg_maxiter']}, tol "
          f"{ip['cg_tol']}: rel-L2 {rel:.4e} below the spread {spread:.4e} (cosine {cos:.6f}; "
          f"rel-L2 {rel_jit:.4e} from the materialized dL/dZ with its jitter)", flush=True)
    if not rel < spread:
        raise AssertionError(f"matfree dL/dZ at the shipped knobs {rel:.4e} from the "
                             f"materialized one, not below the spread {spread:.4e}")

    tight = []
    for i, (p, ref) in enumerate(zip(probe_sets, refs)):
        with _cg_solves() as solves:
            _, g = matfree_grad(ip["precond_rank"], CONTRACT_TIGHT_MAXITER, CONTRACT_TOL, p,
                                logdet if i == 0 else logdet_grad(p))
        tight.append((_rel(g, ref), _cos(g, ref)))
        print(f"  (a) probe set {i}, rank {ip['precond_rank']}, tol {CONTRACT_TOL}, maxiter "
              f"{CONTRACT_TIGHT_MAXITER}: dL/dZ rel-L2 {tight[-1][0]:.4e}, cosine "
              f"{tight[-1][1]:.6f}; solve iterations {[k for _, k, _ in solves]}, worst "
              f"residual {max(r for _, _, r in solves):.1e}", flush=True)
    worst_rel, worst_cos = max(r for r, _ in tight), min(c for _, c in tight)
    print(f"  (a) gate on the tight solves over {len(tight)} probe sets: worst rel-L2 "
          f"{worst_rel:.4e} (limit {CONTRACT_REL}), worst cosine {worst_cos:.6f} (limit "
          f"{CONTRACT_COS})", flush=True)
    if not (worst_rel <= CONTRACT_REL and worst_cos >= CONTRACT_COS):
        raise AssertionError(f"matfree dL/dZ solved tightly: worst rel-L2 {worst_rel:.4e}, "
                             f"worst cosine {worst_cos:.6f} against the materialized one")

    ip_loader, _, _ = get_dataloaders("mnist", ip["batch_size"], aug=False,
                                      root=mf["dirs"]["data"])
    batches = [b for _, b in zip(range(DESCENT_STEPS), cycling_batches(ip_loader))]
    X_sub = torch.cat([torch.as_tensor(x) for x, _ in batches]).cuda()
    knobs = {key: ip[key] for key in ("cg_tol", "cg_maxiter", "precond_rank",
                                      "precond_power", "cg_example_block")}

    with torch.no_grad():
        kl0, kl_s = _host_s(lambda: ind.kl_objective_gram(Z, X_sub, state, mf["alpha"],
                                                          full_set_size=mf["N"]))
        # the stochastic estimate's spread over probe draws, through the
        # materialized objective: the same estimator, whose value (a) holds
        # within 1e-5 of the matfree one, at a fifth of its time
        estimates = [float(ind.kl_objective_stochastic(
            Z, mf["X"], state, mf["alpha"], gen, full_set_size=mf["N"],
            st_samples=ip["st_samples"], slq_samples=ip["slq_samples"],
            slq_num_matvecs=ip["slq_num_matvecs"])) for _ in range(DESCENT_DRAWS)]
    sd = statistics.stdev(estimates)
    probes = [st.rademacher_probes(gen, ip["st_samples"], D) for _ in range(DESCENT_STEPS)]
    sketch_gen = torch.Generator(device="cuda").manual_seed(SEED + 21)

    def steps(objective: str):
        """DESCENT_STEPS Adam steps from phase 18's Z on the batches, the
        stochastic objectives on the same probes; returns (Z, the exact KL's
        change, seconds)."""
        Zs = Z.detach().clone()
        opt = ind.make_optimizer(Zs, ip["lr"])

        def run():
            for (x, _), p in zip(batches, probes):
                extra = {}
                if objective == "stochastic_matfree":
                    extra = dict(knobs, precond_sketch=ind.matfree_sketch(
                        state, Zs, ip["precond_rank"], sketch_gen, ip["precond_power"],
                        ip["cg_example_block"]))
                ind.optimize_step(Zs, torch.as_tensor(x).cuda(), state, mf["alpha"], opt,
                                  objective=objective, full_set_size=mf["N"], probes=p,
                                  st_samples=ip["st_samples"], slq_samples=ip["slq_samples"],
                                  slq_num_matvecs=ip["slq_num_matvecs"], **extra)

        _, seconds = _host_s(run)
        with torch.no_grad():
            kl1 = ind.kl_objective_gram(Zs, X_sub, state, mf["alpha"], full_set_size=mf["N"])
        return Zs, float(kl1 - kl0), seconds

    out = {name: steps(name) for name in ("stochastic_matfree", "stochastic", "gram")}
    print(f"  (b) exact gram KL of the {X_sub.shape[0]} training images of {DESCENT_STEPS} "
          f"batches at phase 18's Z: {float(kl0):.8g} ({kl_s:.2f} s); the stochastic "
          f"estimate there over {DESCENT_DRAWS} probe draws: mean "
          f"{statistics.mean(estimates):.8g}, sd {sd:.6g}", flush=True)
    for name, (Zs, change, seconds) in out.items():
        print(f"  (b) {DESCENT_STEPS} {name} steps (lr {ip['lr']}, the same batches"
              f"{'' if name == 'gram' else ' and probes'}; {seconds:.1f} s, {smi}): exact KL "
              f"change {change:+.6g} ({'a drop beyond' if -change > sd else 'NOT a drop beyond'}"
              f" the sd {sd:.6g}); max |Z - Z0| {float(torch.max(torch.abs(Zs - Z))):.4g}",
              flush=True)
    (Z_free, d_free, _), (Z_mat, d_mat, _) = out["stochastic_matfree"], out["stochastic"]
    apart = float(torch.linalg.norm(Z_free - Z_mat) / torch.linalg.norm(Z_mat - Z))
    print(f"  (b) matfree vs materialized trajectory: |Z_free - Z_mat| / |Z_mat - Z0| "
          f"{apart:.4f} (limit {TRAJECTORY_APART}); exact KL changes {d_free:+.6g} vs "
          f"{d_mat:+.6g}", flush=True)
    # the gate: the matfree trainer follows the materialized one on the same
    # batches and probes (whether either descends is the estimator's signal
    # at these knobs, printed above)
    if not apart <= TRAJECTORY_APART:
        raise AssertionError(f"the matfree trajectory is {apart:.4f} of the materialized "
                             f"one's length away from it")

    res = {}
    old = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            hc = ind.matfree_cg_healthcheck(
                state, Z, mf["alpha"], full_set_size=mf["N"],
                generator=torch.Generator(device="cuda").manual_seed(SEED + 22), warn=False,
                **knobs)
            res[tf32] = hc
            print(f"  (c) trap C1, cudnn.allow_tf32={tf32}: healthcheck residual "
                  f"{hc['cg_rel_residual']:.3e} after {hc['cg_iterations']} iterations, "
                  f"lam_max {hc['lam_max']:.5g}, kappa deflated {hc['kappa_deflated']:.5g}",
                  flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    print(f"  (c) the residual with TF32 convolutions / without: "
          f"{res[True]['cg_rel_residual'] / res[False]['cg_rel_residual']:.3g}x (printed, "
          f"not gated)", flush=True)


def phase_predictive_agreement(mf: dict, smi: str) -> dict:
    """The matfree Matheron sampler against the materialized one on the same
    eps and eta (tight CG: relative error <= 1e-3; the shipped knobs:
    printed), and the metrics of ``--predictive matfree`` (phase 18) against
    ``--predictive weight`` (exact, --range_clip 0) on the same checkpoint
    and batches: the gap within max(3x the gap of two weight runs with other
    generators, 1e-3). Returns the launch counts of the materialized
    sampler's build and draws alone: every kernel of MATHERON_KERNELS must
    have been launched there."""
    print("== phase 20: matfree against the weight predictive (M = 1,024)", flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate
    from laplace_inducing_points_tpu_torch.inference.sample import make_matheron_sampler
    state, Z, alpha, N, sampling = mf["state"], mf["Z"], mf["alpha"], mf["N"], mf["sampling"]
    S, D = mf["ip"]["mc_samples"], state.spec.num_params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    eps = torch.randn(S, D, generator=gen, device="cuda")
    eta = torch.randn(S, Z.shape[0] * 10, generator=gen, device="cuda")
    with torch.no_grad():
        _reset_counts()
        (apply_mat, _), mat_s = _host_s(lambda: make_matheron_sampler(state, Z, alpha, N))
        ref, res_mat = apply_mat(eps, eta, with_info=True)
        launches = _read_counts()
    print(f"launches during the materialized Matheron sampler's build and draws: "
          f"{json.dumps(launches)}")
    for name in MATHERON_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the materialized Matheron sampler")
    with torch.no_grad():
        for tol, maxiter, gated in ((1e-6, 500, True),
                                    (sampling["cg_tol"], sampling["cg_maxiter"], False)):
            (apply_free, _), build_s = _host_s(lambda: make_matheron_sampler(
                state, Z, alpha, N, materialize_w=False, cg_tol=tol, cg_maxiter=maxiter,
                precond_rank=sampling["precond_rank"], precond_power=sampling["precond_power"],
                cg_example_block=sampling["cg_example_block"]))
            (draws, res), draw_s = _host_s(lambda: apply_free(eps, eta, with_info=True))
            err = _rel(draws, ref)
            print(f"  Matheron draws ({S}, {D}), matfree cg_tol {tol:g} maxiter {maxiter} "
                  f"(build {build_s:.3f} s, draws {draw_s:.3f} s, residual {float(res):.2e}) "
                  f"vs materialized (build {mat_s:.3f} s, Cholesky residual "
                  f"{float(res_mat):.2e}): rel error {err:.3e}", flush=True)
            if gated and not err <= 1e-3:
                raise AssertionError(f"matfree Matheron draws {err:.3e} from materialized")
    weight = evaluate.main(["--scalable", "--predictive", "weight", "--range_clip", "0",
                            "--iters", "2", "--max_batches", "2", *mf["common"]])
    free = mf["records"]
    for key in ("nll", "acc"):
        gap = abs(free[0][key] - weight[0][key])
        noise = abs(weight[1][key] - weight[0][key])
        limit = max(3 * noise, 1e-3)
        print(f"  {key}: matfree {free[0][key]:.6f} (second generator {free[1][key]:.6f}), "
              f"weight {weight[0][key]:.6f} (second generator {weight[1][key]:.6f}); gap "
              f"{gap:.3e}, limit max(3 x {noise:.3e}, 1e-3) = {limit:.3e}", flush=True)
        if not gap <= limit:
            raise AssertionError(f"{key}: matfree vs weight gap {gap:.3e} > {limit:.3e}")
    print(f"  serving per batch: weight {weight[1]['per_batch_s']:.4f} s (factor "
          f"{weight[0]['factor_s']:.3f} s), matfree {free[1]['per_batch_s']:.4f} s (sketch "
          f"{free[0]['factor_s']:.3f} s) ({smi})", flush=True)
    return launches


def _matfree_kernels(d_z: int, D: int, S: int, mf: dict) -> dict:
    """Each kernel at the matfree1k path's shapes, by phase 3's rules, timed:
    B1 at Rz (d_z, D) (the materialized sampler, twin and exact KL), B2 and
    B3 at the materialized Matheron draws (S rows), B4 forward and dV at the
    matfree objective's sweeps (P = 12 and 4 against Rx)."""
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                                   matmul_nn_plain,
                                                                   matmul_nt,
                                                                   matmul_nt_plain)
    from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep, ggn_sweep_plain
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    Rz = randn(d_z, D)
    rows = {"syrk": _check_kernel("syrk", syrk, syrk_plain, (Rz,), timed=True),
            "matmul_nt": _check_path("matmul_nt", "tiled", matmul_nt, matmul_nt_plain,
                                     (randn(S, D), Rz), True),
            "matmul_nn": _check_path("matmul_nn", "tiled", matmul_nn, matmul_nn_plain,
                                     (randn(S, d_z), Rz), True)}
    del Rz
    torch.cuda.empty_cache()
    d_x, scale = mf["X"].shape[0] * 10, mf["gamma"]
    R = randn(d_x, D)
    for P in (12, 4):
        V, ct = randn(P, D), randn(P, D)
        v = V.clone().requires_grad_()
        out = ggn_sweep(v, R, scale)
        ref = ggn_sweep_plain(V.double(), R.double(), scale)
        dv_ref = ggn_sweep_plain(ct.double(), R.double(), scale)
        (dv,) = torch.autograd.grad(out, v, ct, retain_graph=True)
        fwd_err = _rel(out, ref)
        lib_err = _rel(_library_sweep(V, R, scale), ref)
        print(f"  ggn_sweep P={P} R {(d_x, D)} scale {scale}: rel vs f64 {fwd_err:.3e} "
              f"(cuBLAS TF32 {lib_err:.3e}), dV {_rel(dv, dv_ref):.3e}", flush=True)
        if not fwd_err <= F64_RATIO * lib_err:
            raise AssertionError(f"ggn_sweep P={P}: {fwd_err:.3e} > {F64_RATIO} x {lib_err:.3e}")
        work = _sweep_work(P, d_x, D)
        for name, call, plain, lib, err in (
                ("ggn_sweep", lambda: ggn_sweep(V, R, scale),
                 lambda: ggn_sweep_plain(V, R, scale), lambda: _library_sweep(V, R, scale),
                 float((out - ggn_sweep_plain(V, R, scale)).abs().max())),
                ("ggn_sweep_backward",
                 lambda: torch.autograd.grad(out, v, ct, retain_graph=True),
                 lambda: ggn_sweep_plain(ct, R, scale), lambda: _library_sweep(ct, R, scale),
                 float((dv - ggn_sweep_plain(ct, R, scale)).abs().max()))):
            row = {"max_abs_err": err, "ms": cuda_ms(call), "plain_ms": cuda_ms(plain),
                   "library_ms": cuda_ms(lib), **work}
            print(f"  {name:18s} P={P}: ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms (cuBLAS TF32)={row['library_ms']:.4f} bound_ms="
                  f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
            rows[name if P == 12 else f"{name}.P{P}"] = row
        del V, ct, v, out, ref, dv_ref, dv
    del R
    torch.cuda.empty_cache()
    return rows


def phase_matfree4k(workdir: Path, mf: dict, smi: str) -> None:
    """lenet5_mnist_matfree4k.yml (M = 4,096, d_z = 40,960) on phase 18's MAP
    (the configs share their model and map blocks): one matfree Z step through
    ``cli.train_scale.main train_inducing --alpha_ip 50`` (its header's alpha;
    ip.epochs 150 -> 1) and one ``cli.evaluate.main --predictive matfree``
    batch, timed with their peak memory; the matfree KL against the
    materialized stochastic KL on the same probes without its Cholesky pivot
    jitter, the same function (Rz 10.1 GB, the Gram 6.7 GB; the jitter's
    share, which varies with the MAP, printed)."""
    label = "matfree4k"
    print(f"== phase 21: {label} (M = 4,096): one Z step and one serving batch", flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale
    from laplace_inducing_points_tpu_torch.ops import stochtrace as st
    from laplace_inducing_points_tpu_torch.training import inducing as ind
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_array
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    cut = _cut_config(workdir, MATFREE[label], {150: 1}, f"{label}_steps_cut.yml")
    cfg = load_experiment_config(cut)
    opt, ip = cfg["optimization"], cfg["optimization"]["ip"]
    ind_dir = str(workdir / f"{label}_ind")
    common = ["--dataset", "mnist", "--config", cut, "--device", "cuda", "--ckpt_map",
              mf["dirs"]["map"], "--ckpt_induc", ind_dir, "--data_dir", mf["dirs"]["data"]]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _cg_solves() as solves:
        result, train_s = _host_s(lambda: train_scale.main(
            ["train_inducing", "--alpha_ip", str(ALPHA_4K), "--train_log",
             str(workdir / f"{label}_log.jsonl"), *common]))
    train_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    ind_stats, hc = result["inducing"], result["healthcheck_post"]
    if not all(math.isfinite(r["loss"]) for r in ind_stats["rows"]):
        raise AssertionError(f"{label} Z-step loss: {ind_stats['rows']}")
    print(f"{label}: M={ip['m']}, one matfree Z step {ind_stats['first_step_seconds']:.2f} s "
          f"(loss {ind_stats['rows'][0]['loss']:.8g}); whole run with both healthchecks "
          f"{train_s:.1f} s; peak memory {train_peak:.2f} GiB above the {base / 2**30:.2f} "
          f"GiB allocated before ({smi}); solve iterations {[k for _, k, _ in solves]}")
    print(f"{label} healthcheck at the stepped Z: residual {hc['cg_rel_residual']:.2e} after "
          f"{hc['cg_iterations']} iterations, lam_max {hc['lam_max']:.5g}, kappa "
          f"{hc['kappa']:.5g}, kappa deflated {hc['kappa_deflated']:.5g}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    records = evaluate.main(["--scalable", "--predictive", "matfree", "--iters", "1",
                             "--max_batches", "1", *common])
    eval_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    rec = records[0]
    for key in ("nll", "acc", "cg_rel_residual"):
        if not math.isfinite(rec[key]):
            raise AssertionError(f"{label} evaluation: {key}={rec[key]}")
    print(f"{label} evaluate --predictive matfree: sketch build {rec['factor_s']:.2f} s, one "
          f"batch {rec['per_batch_s']:.2f} s, worst CG residual {rec['cg_rel_residual']:.2e}, "
          f"peak memory {eval_peak:.2f} GiB ({smi}); nll={rec['nll']:.5f} acc={rec['acc']:.5f}",
          flush=True)
    state = mf["state"]
    Z = torch.as_tensor(load_array(ind_dir, "ind_mnist", ip["epochs"])).cuda()
    X, N = mf["X"], opt["full_set_size"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    probes = st.rademacher_probes(gen, ip["st_samples"], state.spec.num_params)
    knobs = dict(full_set_size=N, st_samples=ip["st_samples"], slq_samples=ip["slq_samples"],
                 slq_num_matvecs=ip["slq_num_matvecs"])
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        v_free, free_s = _host_s(lambda: ind.kl_objective_stochastic(
            Z, X, state, ALPHA_4K, probes, materialize_w=False, cg_tol=ip["cg_tol"],
            cg_maxiter=ip["cg_maxiter"], precond_rank=ip["precond_rank"],
            precond_power=ip["precond_power"], precond_sketch=None,
            cg_example_block=ip["cg_example_block"], **knobs))
        free_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        with _no_pivot_jitter():
            v_mat, mat_s = _host_s(lambda: ind.kl_objective_stochastic(
                Z, X, state, ALPHA_4K, probes, **knobs))
        mat_peak = torch.cuda.max_memory_allocated() / 2**30
        v_jit = ind.kl_objective_stochastic(Z, X, state, ALPHA_4K, probes, **knobs)
    rel = abs(float(v_free - v_mat)) / abs(float(v_mat))
    jitter = abs(float(v_jit - v_mat)) / abs(float(v_mat))
    print(f"{label} KL on the same probes: matfree {float(v_free):.8g} ({free_s:.2f} s, peak "
          f"{free_peak:.2f} GiB), materialized without its pivot jitter {float(v_mat):.8g} "
          f"({mat_s:.2f} s, peak {mat_peak:.2f} GiB; {smi}); rel {rel:.3e}; the jitter moves "
          f"the materialized KL by {jitter:.3e}", flush=True)
    if not rel <= 1e-3:
        raise AssertionError(f"{label}: matfree KL {rel:.3e} from the materialized one")


def run_matfree(workdir: Path, smi: str) -> dict:
    """Phases 17-21: the kernels' rows at the matfree1k shapes, and the
    launches of the matfree1k CLI path and of the materialized sampler."""
    phase_operators(workdir)
    mf = phase_matfree_path(workdir, smi)
    phase_acceptance(mf, smi)
    out = {"launches": {"matfree1k": mf["launches"],
                        "matheron1k": phase_predictive_agreement(mf, smi)},
           "rows": _matfree_kernels(mf["Z"].shape[0] * 10, mf["state"].spec.num_params,
                                    mf["ip"]["mc_samples"], mf)}
    phase_matfree4k(workdir, mf, smi)
    return out


# ---------------------------------------------------------------------------
# the toy slice (phases 22-27): the toy configs at their own widths, the
# dense paths and the cov predictive
# ---------------------------------------------------------------------------

TOY = {"banana": "configs/toy/classifier_banana.yml", "xor": "configs/toy/classifier_xor.yml",
       "sine": "configs/toy/regressor_sine.yml"}
# the kernels' shapes on each toy path (d_z = m·K, d_x = ip.batch_size·K, D, and S:
# the serving draws, ip.mc_samples): banana 40·2, 64·2, D = 626, S = 1,000; spiral
# 50·2, 64·2, D = 4,946; sine 40·1, 128·1, D = 321, S = 5
TOY_SHAPES = {"banana": (80, 128, 626, 1000), "spiral": (100, 128, 4946, 1000),
              "sine": (40, 128, 321, 5)}
TOY_KERNELS = ("syrk", "matmul_nt", "matmul_nn", "syrk_backward", "matmul_nt_backward")
# banana's stochastic Z step (--scalable, phase 26): the Woodbury correction's
# backward and the probe sweep, V (240, 626) against Rx (128, 626), scale N/|X|
BANANA_STOCHASTIC = ("matmul_nn_backward", "ggn_sweep", "ggn_sweep_backward")
SINE_MAP_BUDGET_S = 60.0     # phase 25 cuts map.epochs where as shipped would take longer
XOR_MAP_CUT = {500: 20}      # phase 26(a): a MAP to train Z on, not a result
GOLDEN_BAND = {"nll": (0.233, 0.03), "ece": (0.146, 0.03), "acc": (0.98, 0.021)}


def _toy_source(name: str, row: dict) -> tuple[str, str]:
    """(the CUDA source of the paths a timed call took, the JAX function it
    replaces)."""
    base = "laplace_inducing_points_tpu_torch/csrc/"
    if name.startswith("ggn_sweep"):
        return base + "ggn_sweep.cu", "laplace_inducing_points_tpu/ops/pallas/matmul.py:213"
    replaces = KERNELS[name][1] if name in KERNELS else BACKWARD[name]
    if name == "syrk":
        return base + "syrk.cu", replaces
    tiled = any(p.endswith(".tiled") for p in row["paths"])
    return base + ("matmul_tiled.cu" if tiled else "matmul.cu"), replaces


def _toy_kernels(label: str) -> dict:
    """B1-B3 forward and backward at a toy path's shapes (and, for banana, B3's
    own backward and B4 at the stochastic step's), each by phase 3's rules
    against its plain version and float64 (the Gram exactly symmetric, the
    bias gate), timed against the bound and the torch.mm it replaces."""
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                                   matmul_nn_plain,
                                                                   matmul_nt,
                                                                   matmul_nt_plain)
    from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep, ggn_sweep_plain
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    d_z, d_x, D, S = TOY_SHAPES[label]
    print(f"  {label}: d_z={d_z}, d_x={d_x}, D={D}, S={S}", flush=True)
    Rz, Rx = randn(d_z, D), randn(d_x, D)
    rows = {"syrk": _check_kernel("syrk", syrk, syrk_plain, (Rz,), timed=True)}
    for A in (Rz, _offset(Rz, 1)):
        C = syrk(A)
        if not torch.equal(C, C.T):
            raise AssertionError(f"syrk {(d_z, D)}: not exactly symmetric")
    print(f"  syrk {(d_z, D)} exactly symmetric (aligned and off 16 bytes): True")
    rows["matmul_nt"] = _check_kernel("matmul_nt", matmul_nt, matmul_nt_plain, (Rx, Rz),
                                      timed=True)
    rows["matmul_nt.serving"] = _check_kernel("matmul_nt", matmul_nt, matmul_nt_plain,
                                              (randn(S, D), Rz), timed=True)
    rows["matmul_nn"] = _check_kernel("matmul_nn", matmul_nn, matmul_nn_plain,
                                      (randn(S, d_z), Rz), timed=True)
    _check_kernel("matmul_nn", matmul_nn, matmul_nn_plain, (_offset(randn(S, d_z), 1), Rz),
                  timed=False)
    _check_bias([(f"{name} at {label}", row["bias"], row["plain_bias"],
                  row["plain_rel_vs_f64"], row["outputs"]) for name, row in rows.items()])
    ct_zz, ct_xz = randn(d_z, d_z), randn(d_x, d_z)
    sym_zz = ct_zz + ct_zz.T
    rows["syrk_backward"] = _check_backward(
        "syrk_backward", syrk, syrk_plain, (Rz,), (True,), ct_zz, timed=True,
        library=lambda: torch.mm(sym_zz, Rz))
    rows["syrk_backward"].update(bound(2 * d_z * d_z * D, 4 * (2 * d_z * D + d_z * d_z),
                                       _peak(rows["syrk_backward"]["paths"])))
    rows["matmul_nt_backward"] = _check_backward(
        "matmul_nt_backward", matmul_nt, matmul_nt_plain, (Rx, Rz), (False, True), ct_xz,
        timed=True, library=lambda: torch.mm(ct_xz.T, Rx))
    rows["matmul_nt_backward"].update(bound(2 * d_z * d_x * D,
                                            4 * (d_x * D + d_x * d_z + d_z * D),
                                            _peak(rows["matmul_nt_backward"]["paths"])))
    if label == "banana":
        P = 240
        A, ct = randn(P, d_z), randn(P, D)
        rows["matmul_nn_backward"] = _check_backward(
            "matmul_nn_backward", matmul_nn, matmul_nn_plain, (A, Rz), (True, True), ct,
            timed=True, library=lambda: (torch.mm(ct, Rz.T), torch.mm(A.T, ct)))
        rows["matmul_nn_backward"].update(bound(4 * P * d_z * D,
                                                4 * (P * d_z + 2 * d_z * D + P * D + P * d_z),
                                                _peak(rows["matmul_nn_backward"]["paths"])))
        scale = 450 / 64
        V, ct = randn(P, D), randn(P, D)
        v = V.clone().requires_grad_()
        out = ggn_sweep(v, Rx, scale)
        (dv,) = torch.autograd.grad(out, v, ct, retain_graph=True)
        ref = ggn_sweep_plain(V.double(), Rx.double(), scale)
        dv_ref = ggn_sweep_plain(ct.double(), Rx.double(), scale)
        fwd_err, lib_err = _rel(out, ref), _rel(_library_sweep(V, Rx, scale), ref)
        dv_err, dv_lib = _rel(dv, dv_ref), _rel(_library_sweep(ct, Rx, scale), dv_ref)
        print(f"  ggn_sweep V {(P, D)} R {(d_x, D)} scale {scale:.4g}: rel vs f64 {fwd_err:.3e} "
              f"(cuBLAS TF32 {lib_err:.3e}); dV {dv_err:.3e} (cuBLAS TF32 {dv_lib:.3e})",
              flush=True)
        if not (fwd_err <= F64_RATIO * lib_err and dv_err <= F64_RATIO * dv_lib):
            raise AssertionError(f"ggn_sweep at {label}: further from float64 than "
                                 f"{F64_RATIO} x cuBLAS TF32")
        work = _sweep_work(P, d_x, D)
        for name, call, plain, lib, err in (
                ("ggn_sweep", lambda: ggn_sweep(V, Rx, scale),
                 lambda: ggn_sweep_plain(V, Rx, scale), lambda: _library_sweep(V, Rx, scale),
                 float((out - ggn_sweep_plain(V, Rx, scale)).abs().max())),
                ("ggn_sweep_backward",
                 lambda: torch.autograd.grad(out, v, ct, retain_graph=True),
                 lambda: ggn_sweep_plain(ct, Rx, scale), lambda: _library_sweep(ct, Rx, scale),
                 float((dv - ggn_sweep_plain(ct, Rx, scale)).abs().max()))):
            rows[name] = {"max_abs_err": err, "ms": cuda_ms(call), "plain_ms": cuda_ms(plain),
                          "library_ms": cuda_ms(lib), "paths": set(), **work}
    for name, row in rows.items():
        print(f"  {name}@{label}: ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}); paths {sorted(row['paths'])}"
              + ("  SLOWER than its library call" if row["ms"] > row["library_ms"] else ""),
              flush=True)
    del Rz, Rx
    torch.cuda.empty_cache()
    return rows


def phase_toy_kernels() -> dict:
    print("== phase 22: the kernels at the toy shapes (banana, spiral, sine)", flush=True)
    return {label: _toy_kernels(label) for label in TOY_SHAPES}


def _quiet(main, argv: list, log: Path):
    """``main(argv)`` with its standard output written to ``log``; the log's
    last lines are printed when it raises."""
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        try:
            return main(argv)
        except BaseException:
            f.flush()
            failed = True
        else:
            failed = False
    if failed:
        print("\n".join(log.read_text().splitlines()[-40:]))
        raise AssertionError(f"{main.__module__} {' '.join(argv[:3])} failed (log above)")


def _toy_dirs(workdir: Path, label: str) -> tuple[dict, list]:
    dirs = {key: str(workdir / f"toy_{label}_{key}") for key in ("map", "ind", "fig", "data")}
    return dirs, ["--device", "cuda", "--ckpt_map", dirs["map"], "--ckpt_induc", dirs["ind"],
                  "--data_dir", dirs["data"]]


def _check_launches(label: str, names, launches: dict) -> None:
    print(f"launches during the {label} path: {json.dumps({n: launches[n] for n in names})}")
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the {label} path")


def _eval_line(rec: dict) -> str:
    metrics = " ".join(f"{k}={rec[k]:.5f}" for k in ("nll", "acc", "brier", "ece", "rmse",
                                                     "picp90", "ood_auroc") if k in rec)
    return (f"factor build {rec['factor_s']:.4f} s, {rec['batches']} batches, "
            f"{rec['per_batch_s']:.4f} s per batch; {metrics}")


def phase_toy_banana(workdir: Path, smi: str) -> dict:
    """banana as shipped through ``cli.main_toy full_pipeline`` (250 MAP epochs,
    500 Z steps at alpha_train 1, the config's alpha, the gram objective, every
    figure computed on the card), then ``cli.evaluate`` on its MAP and Z with
    the weight, cov and dense predictives against the OOD ring at r = 1.05."""
    print("== phase 23: banana as shipped (cli.main_toy full_pipeline, then cli.evaluate "
          "weight / cov / dense)", flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate, main_toy
    dirs, common = _toy_dirs(workdir, "banana")
    data = ["--dataset", "banana", "--config", TOY["banana"]]
    _reset_counts()
    result = _quiet(main_toy.main, ["full_pipeline", *data, "--plot_Z", "--comparison",
                                    "--fig_dir", dirs["fig"], *common],
                    workdir / "toy_banana.log")
    mp, ind = result["map"], result["inducing"]
    print(f"MAP: {mp['steps']} steps, warm median {mp['s_per_step']:.5f} s per step ({smi}); "
          f"loss {mp['loss_first']:.4f} -> {mp['loss_last']:.4f} (mean of the first 10 "
          f"{mp['loss_head']:.4f}, of the last 10 {mp['loss_tail']:.4f})")
    print(f"Z: {ind['steps']} gram steps, warm median {ind['s_per_step']:.5f} s per step "
          f"({smi}); loss {ind['loss_first']:.6g} -> {ind['loss_last']:.6g}; max |Z - Z0| = "
          f"{ind['z_moved']:.4g}; figures computed on the card: {result['figures']}")
    if not (math.isfinite(mp["loss_tail"]) and mp["loss_tail"] < mp["loss_head"]):
        raise AssertionError(f"banana MAP loss did not fall: {mp}")
    if not (ind["z_moved"] > 0 and math.isfinite(ind["loss_last"])):
        raise AssertionError(f"banana Z: {ind}")
    if len(result["figures"]) != 4 or not all(result["figures"].values()):
        raise AssertionError(f"banana figures not finite: {result['figures']}")
    records = {}
    for name, flags in (("weight", ["--scalable", "--predictive", "weight"]),
                        ("cov", ["--scalable", "--predictive", "cov"]), ("dense", [])):
        records[name] = _quiet(evaluate.main, [*data, "--ood-dataset", "ring",
                                               "--ood_ring_radius", "1.05", "--iters", "2",
                                               *flags, *common],
                               workdir / f"toy_banana_eval_{name}.log")
        for rec in records[name]:
            if not all(math.isfinite(rec[k]) for k in ("nll", "acc", "ece", "ood_auroc")):
                raise AssertionError(f"banana evaluate {name}: {rec}")
            print(f"evaluate {name} iteration {rec['iter']}: {_eval_line(rec)}", flush=True)
    cov = records["cov"][1]
    print(f"cov: statistics cache hits on the second repetition {cov['stats_cache_hits']} of "
          f"{cov['batches']} batches; self-check share outside the 3x band "
          f"{cov['cov_check_frac']:.4f}")
    if cov["stats_cache_hits"] != cov["batches"]:
        raise AssertionError(f"cov statistics were not reused: {cov}")
    launches = _read_counts()
    _check_launches("banana", TOY_KERNELS, launches)
    return {"launches": launches, "dirs": dirs, "map_s_per_step": mp["s_per_step"]}


def _kept(lam: torch.Tensor, rank_tol: float = 1e-7) -> int:
    """Eigenvalues the samplers' g-weights keep (``inference.sample._g_weights``)."""
    return int((lam > rank_tol * max(float(lam.max()), 1.0)).sum())


def phase_golden_banana(smi: str) -> None:
    """The JAX package's golden banana MAP (converted: tests/golden/banana_torch) and
    Z at its recorded alpha, full_set_size 450, range clip 1.0, S = 200, through
    the port's weight predictor: band (a) of tests/test_golden_banana.py; the
    dense and cov predictives' NLL on the same MAP and Z printed."""
    print("== phase 24: the golden banana operating point through the port", flush=True)
    from laplace_inducing_points_tpu_torch.cli.evaluate import toy_loaders
    from laplace_inducing_points_tpu_torch.data.toy import ring_cache_fname
    from laplace_inducing_points_tpu_torch.evaluation.harness import (auroc_ood,
                                                                      eval_dataset_extended)
    from laplace_inducing_points_tpu_torch.inference.lla import (DenseLLAPredictor,
                                                                 ScalableLLAPredictor)
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier
    from laplace_inducing_points_tpu_torch.utils.checkpoint import (load_array, load_params,
                                                                    load_run_meta)
    flat, _, _ = load_params("tests/golden/banana_torch", "map_banana")
    state = ModelState(SimpleClassifier(16, 3, 2, 2).cuda(), flat.cuda(), "classifier")
    Z = torch.as_tensor(load_array("tests/golden/banana", "ind_banana", 500)).cuda()
    alpha = load_run_meta("tests/golden/banana", "ind_banana")["alpha_ip"]
    test = toy_loaders("banana", 32, "data/", {"n": 500, "noise": 0.090, "seed": 584848})[1]
    rings = {r: toy_loaders("ring", 32, "data/", radius=r, fname=ring_cache_fname(r))[1]
             for r in (2.0, 1.05)}
    common = dict(alpha=alpha, full_set_size=450, num_mc_samples=200)
    with torch.no_grad():
        preds = {"weight": ScalableLLAPredictor(state, Z, full_set_size=450, range_clip_min=1.0),
                 "cov": ScalableLLAPredictor(state, Z, full_set_size=450, range_clip_min=1.0,
                                             method="cov"),
                 "dense": DenseLLAPredictor(state, Z, full_set_size=450)}
        recs = {name: eval_dataset_extended(state, test, Z, predictor=pred,
                                            generator=torch.Generator(device="cuda").manual_seed(0),
                                            **common) for name, pred in preds.items()}
        auroc = {r: auroc_ood(state, recs["weight"]["probs"], loader, Z, predictor=preds["weight"],
                              generator=torch.Generator(device="cuda").manual_seed(1), **common)
                 for r, loader in rings.items()}
    rec = recs["weight"]
    print(f"golden banana, weight path (alpha {alpha}, S = 200; {smi}): nll={rec['nll']:.5f} "
          f"ece={rec['ece']:.5f} acc={rec['acc']:.5f} auroc r=2.0 {auroc[2.0]:.5f} "
          f"r=1.05 {auroc[1.05]:.5f}; Gram eigenvalues above the rank_tol mask "
          f"{_kept(preds['weight'].lam)} of {preds['weight'].d}")
    print(f"dense predictive nll={recs['dense']['nll']:.5f} (the reference's recorded dense "
          f"IP-LLA 0.2008); cov predictive nll={recs['cov']['nll']:.5f} beside the weight "
          f"path's {rec['nll']:.5f} (self-check share {preds['cov'].cov_check_frac:.4f})")
    failed = [f"{k} {rec[k]:.5f} not in {c} +- {w}" for k, (c, w) in GOLDEN_BAND.items()
              if not abs(rec[k] - c) <= w]
    if not auroc[2.0] >= 0.97:
        failed.append(f"auroc r=2.0 {auroc[2.0]:.5f} < 0.97")
    if not abs(auroc[1.05] - 0.892) <= 0.05:
        failed.append(f"auroc r=1.05 {auroc[1.05]:.5f} not in 0.892 +- 0.05")
    if failed:
        raise AssertionError(f"golden banana band (a): {failed}")


def phase_toy_sine(workdir: Path, map_s_per_step: float, smi: str) -> dict:
    """regressor_sine.yml through ``cli.main_toy full_pipeline`` (map.epochs cut
    where as shipped would take more than SINE_MAP_BUDGET_S at banana's MAP
    step time), then ``cli.evaluate`` with the weight and dense predictives."""
    print("== phase 25: the sine regressor (cli.main_toy full_pipeline, then cli.evaluate)",
          flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate, main_toy
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    dirs, common = _toy_dirs(workdir, "sine")
    shipped = load_experiment_config(TOY["sine"])["optimization"]["map"]
    steps_per_epoch = int(0.8 * 300) // shipped["batch_size"]
    projected = shipped["epochs"] * steps_per_epoch * map_s_per_step
    config = TOY["sine"]
    if projected > SINE_MAP_BUDGET_S:
        epochs = max(1, int(SINE_MAP_BUDGET_S / (steps_per_epoch * map_s_per_step)))
        config = _cut_config(workdir, TOY["sine"], {shipped["epochs"]: epochs},
                             "regressor_sine_map_cut.yml")
        print(f"map.epochs cut {shipped['epochs']} -> {epochs}: as shipped "
              f"{shipped['epochs'] * steps_per_epoch} steps would take ~{projected:.0f} s at "
              f"banana's {map_s_per_step:.5f} s per step")
    else:
        print(f"as shipped: {shipped['epochs']} MAP epochs (~{projected:.0f} s projected)")
    data = ["--dataset", "sine", "--config", config]
    _reset_counts()
    result = _quiet(main_toy.main, ["full_pipeline", *data, "--fig_dir", dirs["fig"], *common],
                    workdir / "toy_sine.log")
    records = {name: _quiet(evaluate.main, [*data, "--iters", "1", *flags, *common],
                            workdir / f"toy_sine_eval_{name}.log")[0]
               for name, flags in (("weight", ["--scalable", "--predictive", "weight"]),
                                   ("dense", []))}
    launches = _read_counts()
    mp, ind, res = result["map"], result["inducing"], result["regression_1d"]
    print(f"MAP: {mp['steps']} steps, warm median {mp['s_per_step']:.5f} s per step ({smi}); "
          f"Gaussian NLL loss {mp['loss_head']:.4f} -> {mp['loss_tail']:.4f} (means of the "
          f"first and last 10 steps); logvar {mp['logvar']:.5f}")
    print(f"Z: {ind['steps']} gram steps, warm median {ind['s_per_step']:.5f} s per step; "
          f"max |Z - Z0| = {ind['z_moved']:.4g}; dense 1-D predictive std with X "
          f"{res['full_std'].min():.4g}..{res['full_std'].max():.4g}, with Z "
          f"{res['ip_std'].min():.4g}..{res['ip_std'].max():.4g}")
    for name, rec in records.items():
        print(f"evaluate {name}: {_eval_line(rec)}")
    if not (math.isfinite(mp["loss_tail"]) and mp["loss_tail"] < mp["loss_head"]):
        raise AssertionError(f"sine MAP loss did not fall: {mp}")
    if not abs(mp["logvar"]) > 1e-3:
        raise AssertionError(f"sine logvar did not move from 0: {mp['logvar']}")
    if not (all(np.all(np.isfinite(v)) for v in res.values()) and np.all(res["ip_std"] > 0)):
        raise AssertionError("sine 1-D predictive not finite or its variance not positive")
    if not all(math.isfinite(rec["nll"]) for rec in records.values()):
        raise AssertionError(f"sine evaluation: {records}")
    _check_launches("sine", TOY_KERNELS, launches)
    return {"launches": launches}


def phase_toy_restarts(workdir: Path, banana_dirs: dict, smi: str) -> dict:
    """(a) classifier_xor.yml's 4 restarts through ``cli.main_toy train_inducing``
    on a MAP of XOR_MAP_CUT epochs; (b) ``train_inducing --scalable`` (the
    stochastic objective) on phase 23's banana MAP for 5 Z steps, B4 launched
    at D = 626."""
    print("== phase 26: restarts (xor) and the stochastic toy path (banana --scalable)",
          flush=True)
    from laplace_inducing_points_tpu_torch.cli import main_toy
    (old, new), = XOR_MAP_CUT.items()
    config = _cut_config(workdir, TOY["xor"], XOR_MAP_CUT, "classifier_xor_map_cut.yml")
    dirs, common = _toy_dirs(workdir, "xor")
    data = ["--dataset", "xor", "--config", config]
    _quiet(main_toy.main, ["train_map", *data, "--fig_dir", dirs["fig"], *common],
           workdir / "toy_xor_map.log")
    result = _quiet(main_toy.main, ["train_inducing", *data, *common],
                    workdir / "toy_xor_ind.log")
    ind = result["inducing"]
    kls = ind["restart_kls"]
    print(f"xor (map.epochs cut {old} -> {new}): {len(kls)} restarts of {ind['steps'] // len(kls)} "
          f"gram steps, full-set KLs {', '.join(f'{v:.6g}' for v in kls)}; selected "
          f"{ind['full_set_kl']:.6g}; warm median {ind['s_per_step']:.5f} s per step ({smi})")
    if not (len(kls) == 4 and ind["full_set_kl"] == min(kls)):
        raise AssertionError(f"restart selection: {kls} -> {ind['full_set_kl']}")
    cut = _cut_config(workdir, TOY["banana"], {500: 5}, "classifier_banana_ip_cut.yml")
    _reset_counts()
    result = _quiet(main_toy.main, ["train_inducing", "--scalable", "--dataset", "banana",
                                    "--config", cut, "--device", "cuda",
                                    "--ckpt_map", banana_dirs["map"],
                                    "--ckpt_induc", str(workdir / "toy_banana_scalable_ind"),
                                    "--data_dir", banana_dirs["data"]],
                    workdir / "toy_banana_scalable.log")
    launches = _read_counts()
    ind = result["inducing"]
    print(f"banana --scalable: {ind['steps']} {ind['objective']} steps (ip.epochs cut 500 -> "
          f"5), warm median {ind['s_per_step']:.4f} s per step ({smi}); loss "
          f"{ind['loss_first']:.6g} -> {ind['loss_last']:.6g}; max |Z - Z0| = "
          f"{ind['z_moved']:.4g}")
    if not (ind["objective"] == "stochastic" and ind["z_moved"] > 0
            and math.isfinite(ind["loss_last"])):
        raise AssertionError(f"banana stochastic Z: {ind}")
    _check_launches("banana --scalable", BANANA_STOCHASTIC, launches)
    return {"launches": launches}


def phase_lenet5_cov(workdir: Path, smi: str) -> None:
    """``cli.evaluate --scalable --predictive cov`` at LeNet5's full width on
    phase 7's MAP and Z (2 test batches of 256, two repetitions, jac_block 64),
    beside ``--predictive weight`` on the same batches."""
    print("== phase 27: the cov predictive at LeNet5's full width (phase 7's MAP and Z)",
          flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate
    common = ["--dataset", "mnist", "--config", _train_config(workdir), "--scalable",
              "--iters", "2", "--max_batches", "2", "--device", "cuda", "--ckpt_map",
              str(workdir / "train_map"), "--ckpt_induc", str(workdir / "train_ind"),
              "--data_dir", str(workdir / "data")]
    peaks, records = {}, {}
    for name, flags in (("cov", ["--predictive", "cov", "--jac_block", "64"]),
                        ("weight", ["--predictive", "weight"])):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            records[name] = _quiet(evaluate.main, [*common, *flags],
                                   workdir / f"lenet5_{name}.log")
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        for rec in records[name]:
            if not all(math.isfinite(rec[k]) for k in ("nll", "acc", "brier", "ece")):
                raise AssertionError(f"LeNet5 {name}: {rec}")
            print(f"LeNet5 {name} iteration {rec['iter']}: {_eval_line(rec)}; peak memory "
                  f"{peaks[name]:.2f} GiB ({smi})", flush=True)
        if name == "cov":
            fired = [str(w.message) for w in caught if "covariance-assembly" in str(w.message)]
    cov, weight = records["cov"], records["weight"]
    print(f"cov self-check at alpha {cov[0]['alpha']}: share outside the 3x band "
          f"{cov[0]['cov_check_frac']:.4f}, warning {'fired' if fired else 'silent'}; "
          f"statistics cache hits on the second repetition {cov[1]['stats_cache_hits']}")
    print(f"NLL gap cov - weight on the same batches and generator: "
          f"{cov[0]['nll'] - weight[0]['nll']:+.5f} and {cov[1]['nll'] - weight[1]['nll']:+.5f}; "
          f"the weight path's gap between its two generators "
          f"{weight[1]['nll'] - weight[0]['nll']:+.5f}")
    if cov[1]["stats_cache_hits"] != cov[1]["batches"]:
        raise AssertionError(f"cov statistics were not reused: {cov[1]}")


def run_toy(workdir: Path, smi: str) -> dict:
    """Phases 22-27; the kernels' rows at the toy shapes and the launches of
    the banana and sine paths."""
    rows = phase_toy_kernels()
    banana = phase_toy_banana(workdir, smi)
    phase_golden_banana(smi)
    sine = phase_toy_sine(workdir, banana["map_s_per_step"], smi)
    stochastic = phase_toy_restarts(workdir, banana["dirs"], smi)
    phase_lenet5_cov(workdir, smi)
    launches = {"banana": {**{n: banana["launches"][n] for n in TOY_KERNELS},
                           **{n: stochastic["launches"][n] for n in BANANA_STOCHASTIC}},
                "sine": {n: sine["launches"][n] for n in TOY_KERNELS}}
    return {"rows": rows, "launches": launches}


# --- phases 28-31: resume, profile, gram_chunked, the mesh ---------------------

RESUME_REL_TOL = 1e-6     # phase 28: the CLI's resumed MAP against the in-process one
CHUNKED_LOSS_TOL = 1e-6   # phase 30: gram_chunked's KL against gram's in float64, relative
CHUNKED_GRAD_TOL = 1e-5   # phase 30: its dL/dZ there, and its float32 pullback, relative L2
MESH_GRAM_TOL = 1e-6      # phase 31: sharded_gram against B1's Gram, relative
MESH_OP_TOL = 1e-5        # phase 31: the other sharded ops and the mesh predictors
MESH_CG_FACTOR = 10       # phase 31: matfree mesh draws within this x the CG residual
MESH_KERNELS = ("syrk", "matmul_nt", "matmul_nn")
CHUNKED_KERNELS = ("syrk", "matmul_nt", "syrk_backward", "matmul_nt_backward")


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic convolutions within the block (two runs of the
    same MAP steps then differ by nothing but their inputs)."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _lenet5_args(workdir: Path, config: str, tag: str) -> list[str]:
    return ["--dataset", "mnist", "--config", config, "--device", "cuda",
            "--ckpt_map", str(workdir / f"{tag}_map"), "--ckpt_induc", str(workdir / f"{tag}_ind"),
            "--data_dir", str(workdir / "data")]


def phase_resume(workdir: Path, smi: str) -> None:
    """``train_scale train_map`` (lenet5_mnist.yml, map.epochs 150 -> 1: 31 steps
    on the surrogate), then ``train_map --continue``: the restored step, the
    learning rate there (the cosine schedule past its end: its floor), and the
    weights against an in-process continuation (``load_train_state``, a fresh
    loader of the same seed, ``train_map``); then ``train_inducing --continue``
    on that MAP."""
    print("== phase 28: resumable MAP training (train_scale train_map, then --continue)",
          flush=True)
    from laplace_inducing_points_tpu_torch.cli import train_scale
    from laplace_inducing_points_tpu_torch.data.scale import get_dataloaders
    from laplace_inducing_points_tpu_torch.models.scale import LeNet5
    from laplace_inducing_points_tpu_torch.training.map import cosine_lr, train_map
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_train_state
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    config = _cut_config(workdir, CONFIG, {150: 1, 250: 3}, "lenet5_resume.yml")
    cfg = load_experiment_config(config)
    mp = cfg["optimization"]["map"]
    common = _lenet5_args(workdir, config, "resume")
    cuda = torch.device("cuda")
    with _deterministic_cudnn():
        first = _quiet(train_scale.main, ["train_map", *common], workdir / "resume_1.log")["map"]
        saved = load_train_state(str(workdir / "resume_map"), "map_mnist", LeNet5().cuda(),
                                 "classifier", cuda)
        second = _quiet(train_scale.main, ["train_map", "--continue", *common],
                        workdir / "resume_2.log")["map"]
        train_loader, test_loader, _ = get_dataloaders("mnist", mp["batch_size"],
                                                       root=str(workdir / "data"))
        with open(workdir / "resume_ref.log", "w") as f, contextlib.redirect_stdout(f):
            ref = train_map(saved, train_loader, test_loader, num_epochs=mp["epochs"],
                            alpha=cfg["optimization"]["alpha"],
                            lr=cosine_lr(mp["lr"], mp["epochs"], len(train_loader)))
    resumed = load_train_state(str(workdir / "resume_map"), "map_mnist", LeNet5().cuda(),
                               "classifier", cuda)
    rel = _rel(resumed.flat_params, ref.flat_params)
    moved = _rel(resumed.flat_params, saved.flat_params)
    print(f"first run: steps {first['start_step']} -> {first['end_step']}, lr at step 0 "
          f"{first['start_lr']:.6g}; resumed run: restored step {second['start_step']}, lr "
          f"there {second['start_lr']:.6g} (the schedule's floor 0.08 x {mp['lr']:g} = "
          f"{0.08 * mp['lr']:.6g}), steps -> {second['end_step']}; loss "
          f"{second['loss_first']:.5f} -> {second['loss_last']:.5f}; {second['s_per_step']:.5f} "
          f"s per warm step ({smi})")
    print(f"resumed weights against the in-process continuation: rel L2 {rel:.3e} (limit "
          f"{RESUME_REL_TOL:g}); the epoch moved them by rel {moved:.3e}")
    if (second["start_step"], second["end_step"]) != (first["end_step"], 2 * first["end_step"]):
        raise AssertionError(f"resume did not continue the step count: {first} {second}")
    if not math.isclose(second["start_lr"], 0.08 * mp["lr"], rel_tol=1e-6):
        raise AssertionError(f"resumed lr {second['start_lr']} is not the schedule's floor")
    if not (rel <= RESUME_REL_TOL and moved > 0):
        raise AssertionError(f"resumed MAP: rel {rel:.3e} from the in-process run, moved "
                             f"{moved:.3e}")
    result = _quiet(train_scale.main, ["train_inducing", "--continue", "--alpha_ip",
                                       str(cfg["optimization"]["alpha"]), *common],
                    workdir / "resume_3.log")
    print(f"train_inducing --continue on the resumed MAP: max |Z - Z0| = "
          f"{result['Z_moved']:.4g}; alpha {result['alpha']['alpha_ip']}")
    if not (result["Z_moved"] > 0):
        raise AssertionError("train_inducing --continue: Z did not move")


_TILED = re.compile(r"tiled_kernel<\s*(\d+),\s*(\d+),\s*([^,<>]+?),\s*([^,<>]+?),\s*(\d+),"
                    r"\s*([^,<>]+?)\s*>")
_TILED_MANGLED = re.compile(r"tiled_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])ELi(\d+)ELb([01])E")


def _wrapper_of(kernel: str):
    """The wrapper whose launch a device kernel of the trace is (its main
    kernel; the second passes of a split are part of the same launch), or
    None. The tiled kernel serves B1 (LOWER), B3 (B_KN) and B2."""
    if "nt_rows_kernel" in kernel:
        return "matmul_nt"
    if "nn_rows_kernel" in kernel or "nn_rank_kernel" in kernel:
        return "matmul_nn"
    if "tiled_kernel" not in kernel:
        return None
    m = _TILED.search(kernel) or _TILED_MANGLED.search(kernel)
    if m is None:
        raise AssertionError(f"cannot read the template arguments of {kernel!r}")
    flag = {"true": True, "1": True, "(bool)1": True, "false": False, "0": False,
            "(bool)0": False}
    b_kn, lower = flag[m.group(3)], flag[m.group(6)]
    return "syrk" if lower else ("matmul_nn" if b_kn else "matmul_nt")


def _trace_kernels(log_dir: Path) -> dict:
    """``{wrapper: (launches, device ms)}`` of B1-B3 in the one trace file in
    ``log_dir``, from its device kernel events."""
    files = list(log_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{log_dir}: {len(files)} trace files")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError(f"{files[0].name}: no device kernel in the trace")
    out = {name: [0, 0.0] for name in MESH_KERNELS}
    for e in kernels:
        name = _wrapper_of(e["name"])
        if name is not None:
            out[name][0] += 1
            out[name][1] += e["dur"] / 1e3
    return {name: tuple(v) for name, v in out.items()}


def _launched() -> dict:
    """Launches of B1-B3 by the port's counters, every path, forward and backward."""
    counts = _path_counts()
    return {name: sum(n for key, n in counts.items() if key.startswith(name + "."))
            for name in MESH_KERNELS}


def phase_profile(workdir: Path, kernel_rows: dict, smi: str) -> None:
    """``train_scale train_inducing --profile`` (lenet5_mnist.yml, gram, 2 Z
    steps on phase 7's MAP) and ``evaluate --scalable --profile --iters 2`` (one
    test batch): each trace file holds B1-B3 with the launches of the port's
    counters for the same steps, and their device ms as the trace gives them."""
    print("== phase 29: --profile (train_scale train_inducing, evaluate --scalable)",
          flush=True)
    from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale
    config = _cut_config(workdir, CONFIG, {150: 1, 250: 2}, "lenet5_profile.yml")
    common = _lenet5_args(workdir, config, "profile")
    common[common.index("--ckpt_map") + 1] = str(workdir / "train_map")    # phase 7's MAP
    trace_dir = workdir / "trace_train"
    _reset_counts()
    _quiet(train_scale.main, ["train_inducing", "--alpha_ip", "0.005", "--profile",
                              str(trace_dir), *common], workdir / "profile_train.log")
    counted = _launched()
    traced = _trace_kernels(trace_dir)
    print(f"train_inducing, 2 gram Z steps: launches by the counters {json.dumps(counted)}; "
          f"in the trace " + ", ".join(f"{k} {n} ({ms:.3f} ms on the device, "
                                       f"{ms / max(n, 1):.4f} ms per launch)"
                                       for k, (n, ms) in traced.items()) + f" ({smi})")
    for name in MESH_KERNELS:
        if not (traced[name][0] == counted[name] > 0):
            raise AssertionError(f"{name}: {traced[name][0]} launches in the trace, "
                                 f"{counted[name]} by the counters")
    trace_dir = workdir / "trace_eval"
    _reset_counts()
    evaluate_argv = ["--scalable", "--predictive", "weight", "--iters", "2", "--max_batches",
                     "1", "--profile", str(trace_dir), *common]
    evaluate_argv[evaluate_argv.index("--config") + 1] = _train_config(workdir)
    evaluate_argv[evaluate_argv.index("--ckpt_induc") + 1] = str(workdir / "train_ind")
    _quiet(evaluate.main, evaluate_argv, workdir / "profile_eval.log")
    counted = _launched()
    traced = _trace_kernels(trace_dir)
    # the factor build (one B1 launch) comes before the traced second of two
    # like repetitions
    expected = {"syrk": 0, "matmul_nt": counted["matmul_nt"] // 2,
                "matmul_nn": counted["matmul_nn"] // 2}
    print(f"evaluate, the second of 2 repetitions of one batch (S=200): launches by the "
          f"counters over the run {json.dumps(counted)}; in the trace "
          + ", ".join(f"{k} {n} ({ms / n:.4f} ms on the device per launch)"
                      for k, (n, ms) in traced.items() if n)
          + "; CUDA-event ms of the same products (phase 3): "
          + ", ".join(f"{k} {kernel_rows[k]['ms']:.4f}" for k in ("matmul_nt", "matmul_nn"))
          + f" ({smi})")
    if counted["syrk"] != 1 or counted["matmul_nt"] % 2 or counted["matmul_nn"] % 2:
        raise AssertionError(f"evaluate's launches are not one factor build and two like "
                             f"repetitions: {counted}")
    for name, n in expected.items():
        if traced[name][0] != n:
            raise AssertionError(f"{name}: {traced[name][0]} launches in the trace, {n} "
                                 f"expected from the counters")


def _timed_step(fn, reps: int = 3):
    """``(result, median host seconds, peak GiB above the base)`` of ``fn()``
    after one warm-up, the device synchronised."""
    fn()
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(reps):
        out, seconds = _host_s(fn)
        times.append(seconds)
    return out, statistics.median(times), (torch.cuda.max_memory_allocated() - base) / 2**30


def _state64(state):
    """A float64 copy of ``state`` as the operators read it (``ModelState`` is
    float32)."""
    import copy
    from types import SimpleNamespace
    return SimpleNamespace(model=copy.deepcopy(state.model).double(),
                           flat_params=state.flat_params.double(), spec=state.spec,
                           batch_stats={k: v.double() for k, v in state.batch_stats.items()},
                           model_kind=state.model_kind, logvar=state.logvar,
                           device=state.device)


def _gram_step64(state64, Z, X, alpha, beta, gamma, block):
    """``(KL, dL/dZ, the row cotangent)`` of the gram step in float64, staged as
    the port stages it: rows in blocks of ``block`` examples, the Gram algebra
    (plain products) and its backward, the row pullback in the same blocks."""
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.training.inducing import _kl_core
    with torch.no_grad():
        Rz = ops.dense_wt(state64, Z, example_block=block)
        Rx = ops.dense_wt(state64, X, example_block=block)
    rz = Rz.requires_grad_()
    kl = _kl_core(rz @ rz.T, Rx @ rz.T, torch.sum(Rx * Rx), rz.shape[1], alpha, beta, gamma)
    (ct,) = torch.autograd.grad(kl, rz)
    del Rz, Rx, rz
    return kl.detach(), ops.dense_wt_pullback(state64, Z, ct, example_block=block), ct


def phase_gram_chunked(workdir: Path, train: dict, kernel_rows: dict, backward_rows: dict,
                       smi: str) -> dict:
    """``gram_chunked`` (rows and pullback 4 examples at a time) against ``gram``
    (one block) at LeNet5's full width on phase 7's MAP, Z and X.

    The two are one function staged two ways. The staging arithmetic, in
    float64 (rows, plain Gram algebra, pullback; this file's ``_gram_step64``,
    not the port's entries): the two stagings must give the KL within
    CHUNKED_LOSS_TOL and dL/dZ within CHUNKED_GRAD_TOL. The port's entries,
    in float32 through the kernels: the rows built in chunks must be within
    REL_TOL of one block's, one cotangent pulled back in chunks within
    CHUNKED_GRAD_TOL of one block's, the chunked rows no further from float64
    than F64_RATIO times the same chunks built by PyTorch's own convolutions
    (cuDNN off), and ``kl_grad_gram_chunked``'s KL and
    dL/dZ each no further from float64 than F64_RATIO times
    ``kl_value_and_grad_gram``'s: two float32 evaluations of this step
    differ by their Gram algebra's round-off (each ~1e-3 from float64 at
    alpha 0.005), so they are held to float64, not to each other. Warm step
    time and peak memory of each, and the same at matfree1k's materialized
    size (M = 1,024, d_z = 10,240, not gated); the kernels the chunked step
    launched, and its cross-Gram product timed."""
    print("== phase 30: the gram_chunked objective against gram (LeNet5)", flush=True)
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nt, matmul_nt_plain
    from laplace_inducing_points_tpu_torch.training.inducing import (kl_grad_gram_chunked,
                                                                     kl_value_and_grad_gram)
    state, X, alpha = train["state"], train["X"], train["alpha"]
    N = round(train["beta"] * train["Z"].shape[0])
    rows = {}
    for label, Z, reps in (("M=100", train["Z"], 3), ("M=1024", None, 1)):
        if Z is None:
            x_train, _ = load_arrays("mnist", train=True, root=train["data_dir"])
            Z = torch.as_tensor(x_train[:1024]).cuda()
        (v_g, g_g), s_g, peak_g = _timed_step(
            lambda: kl_value_and_grad_gram(Z, X, state, alpha, full_set_size=N), reps)
        if label == "M=100":
            _reset_counts()
        (v_c, g_c), s_c, peak_c = _timed_step(
            lambda: kl_grad_gram_chunked(Z, X, state, alpha, full_set_size=N, chunk=4), reps)
        if label == "M=100":
            launches = {k: v // (reps + 1) for k, v in _read_counts().items()}
        print(f"{label} (d_z={10 * Z.shape[0]}, D={state.spec.num_params}, "
              f"d_x={10 * X.shape[0]}), float32 through the kernels: KL gram {float(v_g):.9g}, "
              f"gram_chunked {float(v_c):.9g} (rel "
              f"{abs(float(v_c) - float(v_g)) / abs(float(v_g)):.2e}); dL/dZ rel L2 "
              f"{_rel(g_c, g_g):.2e}; warm step gram {s_g:.4f} s, gram_chunked {s_c:.4f} s; "
              f"peak memory above the base gram {peak_g:.3f} GiB, gram_chunked "
              f"{peak_c:.3f} GiB ({smi})", flush=True)
        if label == "M=100":
            Z100, f32 = Z, {"gram": (float(v_g), g_g), "gram_chunked": (float(v_c), g_c)}
        else:
            del v_g, g_g, v_c, g_c
        torch.cuda.empty_cache()

    Z, beta, gamma = Z100, N / Z100.shape[0], N / X.shape[0]
    s64 = _state64(state)
    v64, g64, ct64 = _gram_step64(s64, Z.double(), X.double(), alpha, beta, gamma, None)
    v64c, g64c, _ = _gram_step64(s64, Z.double(), X.double(), alpha, beta, gamma, 4)
    rel_v64, rel_g64 = abs(float(v64c) - float(v64)) / abs(float(v64)), _rel(g64c, g64)
    with torch.no_grad():
        R_one, R_chunk = ops.dense_wt(state, Z), ops.dense_wt(state, Z, example_block=4)
        R64 = ops.dense_wt(s64, Z.double())
        with torch.backends.cudnn.flags(enabled=False):
            R_off = ops.dense_wt(state, Z, example_block=4)
    rel_rows = _rel(R_chunk, R_one)
    rows_err = (_rel(R_one, R64), _rel(R_chunk, R64), _rel(R_off, R64))
    del R_one, R_chunk, R64, R_off
    ct = ct64.float()
    pull_one = ops.dense_wt_pullback(state, Z, ct)
    pull_chunk = ops.dense_wt_pullback(state, Z, ct, example_block=4)
    rel_pull = _rel(pull_chunk, pull_one)
    pull_err = _rel(pull_one, ops.dense_wt_pullback(s64, Z.double(), ct64))
    del pull_one, pull_chunk, ct, ct64
    err = {key: (abs(v - float(v64)) / abs(float(v64)), _rel(g, g64))
           for key, (v, g) in f32.items()}
    print(f"M=100 in float64, the staging arithmetic (not the port's entries): KL {float(v64):.12g} against "
          f"{float(v64c):.12g} (rel {rel_v64:.2e}, limit {CHUNKED_LOSS_TOL:g}); dL/dZ rel L2 "
          f"{rel_g64:.2e} (limit {CHUNKED_GRAD_TOL:g})")
    print(f"M=100 in float32: rows in chunks of 4 against one block rel {rel_rows:.2e} (limit "
          f"{REL_TOL:g}; each against float64: one block {rows_err[0]:.2e}, chunks "
          f"{rows_err[1]:.2e}, limit {F64_RATIO} x the cuDNN-off chunks' {rows_err[2]:.2e}); "
          f"one cotangent pulled back in chunks against one block rel "
          f"{rel_pull:.2e} (limit {CHUNKED_GRAD_TOL:g}; one block against float64 "
          f"{pull_err:.2e}); the port's whole step against float64: KL gram "
          f"{err['gram'][0]:.2e}, gram_chunked {err['gram_chunked'][0]:.2e}; dL/dZ gram "
          f"{err['gram'][1]:.2e}, gram_chunked {err['gram_chunked'][1]:.2e} (each limit "
          f"{F64_RATIO} x gram's)",
          flush=True)
    del f32, g64, g64c, s64
    if not (rel_v64 <= CHUNKED_LOSS_TOL and rel_g64 <= CHUNKED_GRAD_TOL):
        raise AssertionError("the two stagings of the gram step differ in float64")
    if not (rel_rows <= REL_TOL and rel_pull <= CHUNKED_GRAD_TOL):
        raise AssertionError("gram_chunked's rows or pullback differ from gram's in float32")
    if not rows_err[1] <= F64_RATIO * rows_err[2]:
        raise AssertionError(f"gram_chunked's rows are {rows_err[1]:.2e} from float64, the "
                             f"cuDNN-off chunks {rows_err[2]:.2e}")
    for k, what in enumerate(("KL", "dL/dZ")):
        if not err["gram_chunked"][k] <= F64_RATIO * err["gram"][k]:
            raise AssertionError(f"gram_chunked's {what} is {err['gram_chunked'][k]:.2e} from "
                                 f"float64, gram's {err['gram'][k]:.2e}")
    torch.cuda.empty_cache()
    print(f"launches of one gram_chunked step (M=100): {json.dumps(launches)}")
    for name in CHUNKED_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the gram_chunked step")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    Rz, Rx = (torch.randn(n, state.spec.num_params, device="cuda", generator=gen)
              for n in (1000, 1280))
    print("  the cross-Gram of the step, timed:", flush=True)
    rows["matmul_nt"] = _check_path("matmul_nt", "tiled", matmul_nt, matmul_nt_plain,
                                    (Rx, Rz), True)
    rows["syrk"] = kernel_rows["syrk"]                      # phase 3: B1 at (1000, D)
    rows.update({k: backward_rows[k] for k in ("syrk_backward", "matmul_nt_backward")})
    return {"rows": rows, "launches": launches}


def _map_step_pair(state, batch, mesh, lr: float = 1e-3, alpha: float = 0.005):
    """One MAP step on ``batch`` without and with ``mesh`` from the same
    weights: ``[(loss, gradient, flat after, batch_stats after, the forward's
    ReLU masks over the whole batch), ...]``."""
    from laplace_inducing_points_tpu_torch.training.map import map_step, working_state
    from laplace_inducing_points_tpu_torch.utils.relu_masks import recorded_relu_masks
    outs = []
    for m in (None, mesh):
        work = working_state(state, state.flat_params.clone())
        flat = state.flat_params.clone().requires_grad_()
        record = {}
        with recorded_relu_masks(record):
            loss = map_step(work, flat, torch.optim.Adam([flat], lr=lr, eps=1e-8), batch,
                            alpha, mesh=m)
        torch.cuda.synchronize()
        # the shards' masks, in rank order, are the whole batch's
        parts = ([record[threading.current_thread().name]] if m is None else
                 [record[f"shard {r}"] for r in range(len(record))])
        masks = [torch.cat([p[i].to(flat.device) for p in parts]) for i in range(len(parts[0]))]
        outs.append((float(loss), flat.grad.detach().clone(), flat.detach(), work.batch_stats,
                     masks))
    return outs


def _map_gradient64(state, batch, alpha: float = 0.005, masks=None) -> torch.Tensor:
    """The MAP loss's gradient on one device in float64 (train-mode
    BatchNorm); with ``masks`` on those ReLU masks (``utils.relu_masks``)."""
    from laplace_inducing_points_tpu_torch.training.map import map_loss
    from laplace_inducing_points_tpu_torch.utils.relu_masks import replayed_relu_masks
    s64 = _state64(state)
    flat = s64.flat_params.clone().requires_grad_()
    x, y = (torch.as_tensor(t, device="cuda") for t in batch)
    with replayed_relu_masks(masks) if masks is not None else contextlib.nullcontext():
        loss, _ = map_loss(s64, flat, x.double(), y, alpha)
    return torch.autograd.grad(loss, flat)[0]


def _check_map_steps(label: str, state, batch, mesh) -> None:
    """The data-parallel step's loss and BatchNorm statistics against one
    device's (MESH_OP_TOL); its gradient within MESH_OP_TOL of one device's or,
    where float32 leaves the two further apart than that (their forwards
    round a ReLU input near 0 to different sides: a BatchNorm net's moments
    are summed in another order on the mesh), no further from float64 on its
    own ReLU masks than F64_RATIO times one device's is from float64 on its
    masks."""
    (l1, g1, f1, s1, m1), (l2, g2, f2, s2, m2) = _map_step_pair(state, batch, mesh)
    flips = sum(int((a != b).sum()) for a, b in zip(m1, m2))
    plain = _map_gradient64(state, batch)
    rel_l, rel_g, rel_f = abs(l2 - l1) / abs(l1), _rel(g2, g1), _rel(f2, f1)
    err1, err2 = _rel(g1, _map_gradient64(state, batch, masks=m1)), _rel(
        g2, _map_gradient64(state, batch, masks=m2))
    rel_s = max((_rel(s2[k], s1[k]) for k in s1), default=0.0)
    print(f"  data-parallel MAP step, {label}: loss {l1:.7f} on one device, {l2:.7f} on the "
          f"mesh (rel {rel_l:.2e}); gradient rel L2 {rel_g:.2e} ({flips} ReLU mask entries "
          f"differ; against float64 on each one's masks: one device {err1:.2e}, the mesh "
          f"{err2:.2e}; with plain ReLUs {_rel(g1, plain):.2e}, {_rel(g2, plain):.2e}); weights "
          f"after the Adam step rel {rel_f:.2e}; BatchNorm statistics rel {rel_s:.2e} (worst "
          f"of {len(s1)} buffers)", flush=True)
    if not (rel_l <= MESH_OP_TOL and rel_s <= MESH_OP_TOL
            and (rel_g <= MESH_OP_TOL or err2 <= F64_RATIO * err1)):
        raise AssertionError(f"data-parallel MAP step ({label}) differs from one device")


def _logits64(state, x, pred, alpha: float, eps: torch.Tensor) -> torch.Tensor:
    """The weight predictor's logit samples on noise ``eps`` with its sample
    contractions in float64 (the jvp push-forward in float32) on the factor of
    ``pred``."""
    from torch.func import vmap

    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.inference.sample import _g_weights
    g = _g_weights(pred.lam, alpha, pred.beta, pred.rank_tol, pred.range_clip_min).double()
    R, V, e = pred.R.double(), pred.V.double(), eps.double()
    w = e / math.sqrt(alpha) + ((((e @ R.T) @ V) * g) @ V.T) @ R
    lin = ops.linearize_model(state, x)
    return lin.f0[None] + vmap(lin.jvp)(w.float())


def _mesh_checks(mesh, train: dict, resnet_state, smi: str) -> dict:
    """The sharded ops, the data-parallel MAP steps and the mesh predictors on
    ``mesh`` against their unsharded versions; the launches of B1-B3 by the
    sharded Gram and the mesh predictors."""
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.data.scale import get_dataloaders
    from laplace_inducing_points_tpu_torch.inference.lla import (
        ScalableLLAPredictor, amortized_logit_samples_from_noise,
        matfree_logit_samples_from_noise)
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
    from laplace_inducing_points_tpu_torch.parallel import sharded_ops as sh
    state, Z = train["state"], train["Z"]
    N = round(train["beta"] * Z.shape[0])
    print(f"mesh {mesh} ({smi})", flush=True)
    with torch.no_grad():
        R = ops.dense_wt(state, Z)
        gram = syrk(R)
        _reset_counts()
        sharded = sh.sharded_gram(state, Z, mesh)
        launches = _read_counts()
        blocks = sh.sharded_dense_wt(state, Z, mesh)
        rel_gram, rel_rows = _rel(sharded, gram), _rel(torch.cat(blocks), R)
        del R, gram, blocks
        V = torch.randn(4, state.spec.num_params, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 31))
    Zs = Z[:32]
    ggn = sh.sharded_ggn_matmat(state, Zs, V, mesh, full_set_size=N)
    plain_ggn = ops.make_ggn_operator(state, Zs, N).matmat(V)
    rel_ggn = _rel(ggn, plain_ggn)
    print(f"  sharded_gram against B1's Gram of the same rows: rel {rel_gram:.2e} (limit "
          f"{MESH_GRAM_TOL:g}); sharded_dense_wt against dense_wt: rel {rel_rows:.2e}; "
          f"sharded_ggn_matmat (M=32, P=4) against the jvp/vjp operator: rel {rel_ggn:.2e}",
          flush=True)
    if not (rel_gram <= MESH_GRAM_TOL and rel_rows <= MESH_OP_TOL and rel_ggn <= MESH_OP_TOL):
        raise AssertionError("a sharded op differs from its unsharded version")
    del ggn, plain_ggn, V
    loader, _, _ = get_dataloaders("mnist", 256, aug=False, root=train["data_dir"])
    _check_map_steps("LeNet5, batch 256", state, next(iter(loader)), mesh)
    cifar, _, _ = get_dataloaders("cifar10", 16, aug=False, root=train["data_dir"])
    _check_map_steps("ResNet1M, batch 16 (BatchNorm)", resnet_state, next(iter(cifar)), mesh)
    x = torch.as_tensor(next(iter(loader))[0]).cuda()
    with torch.no_grad():
        # matfree at alpha 50 (lenet5_mnist_matfree4k.yml's), where a tight CG
        # converges: the two runs then differ by round-off, not by CG's exits
        for method, S, alpha, kw in (("weight", 200, train["alpha"], {}),
                                     ("matfree", 32, 50.0, dict(cg_tol=1e-6, cg_maxiter=500,
                                                                precond_rank=64))):
            if method == "weight":
                _reset_counts()
            meshed = ScalableLLAPredictor(state, Z, full_set_size=N, method=method, mesh=mesh,
                                          **kw)
            with warnings.catch_warnings():
                # tol 1e-6 is below what float32 CG reaches: it runs to maxiter
                # and the residual it reaches is printed below
                warnings.simplefilter("ignore")
                b = meshed.logit_samples(x, alpha, torch.Generator(device="cuda")
                                         .manual_seed(SEED + 32), S)
            if method == "weight":
                counts = _read_counts()
                launches.update({k: counts[k] for k in ("matmul_nt", "matmul_nn")})
            # the plain (unsharded) draws on the same factor and the same noise,
            # drawn as the predictor draws it
            gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
            eps = torch.randn(S, state.spec.num_params, generator=gen, device="cuda")
            if method == "weight":
                a = amortized_logit_samples_from_noise(
                    state, meshed.R, meshed.lam, meshed.V, alpha, meshed.beta, x, eps,
                    meshed.rank_tol, meshed.range_clip_min, meshed.sample_block)
            else:
                eta = torch.randn(S, meshed.d, generator=gen, device="cuda")
                a, res = matfree_logit_samples_from_noise(
                    state, Z, meshed.nys, alpha, N, x, eps, eta, kw["cg_tol"],
                    kw["cg_maxiter"], meshed.sample_block, meshed.cg_example_block)
            rel = _rel(b, a)
            ok = rel <= MESH_OP_TOL
            if method == "weight":
                # the draws' contractions in float64 (phase 5's yardstick): the
                # sample correction amplifies their round-off
                ref = _logits64(state, x, meshed, alpha, eps)
                err_a, err_b = _rel(a, ref), _rel(b, ref)
                ok = ok or err_b <= F64_RATIO * err_a
                # a second factor build: how far its draws move on the same noise
                other = ScalableLLAPredictor(state, Z, full_set_size=N)
                rebuilt = amortized_logit_samples_from_noise(
                    state, other.R, other.lam, other.V, alpha, other.beta, x, eps,
                    other.rank_tol, other.range_clip_min, other.sample_block)
                extra = (f"; against float64 contractions: plain {err_a:.2e}, mesh "
                         f"{err_b:.2e}; a second factor build: rows rel "
                         f"{_rel(other.R, meshed.R):.2e}, eigenvalues rel "
                         f"{_rel(other.lam, meshed.lam):.2e}, its draws' logits rel "
                         f"{_rel(rebuilt, a):.2e}")
                del ref, other, rebuilt
            else:
                # the draws' error is bounded by the CG residual (times the
                # deflated operator's small conditioning): two float32 solves
                # split differently differ by that much, not by round-off
                worst = max(meshed.last_cg_residual, float(res))
                ok = ok or rel <= MESH_CG_FACTOR * worst
                extra = (f"; CG residual mesh {meshed.last_cg_residual:.2e}, plain "
                         f"{float(res):.2e} (limit {MESH_CG_FACTOR} x the worst)")
            print(f"  ScalableLLAPredictor(method={method!r}, mesh=) against the plain draws "
                  f"on its factor, S={S}, batch {x.shape[0]}, alpha {alpha:g}: logits rel "
                  f"{rel:.2e} (limit {MESH_OP_TOL:g}){extra}", flush=True)
            if not ok:
                raise AssertionError(f"mesh predictor ({method}) differs from the plain one")
            del meshed, a, b, eps
    torch.cuda.empty_cache()
    return {name: launches[name] for name in MESH_KERNELS}


def phase_mesh(workdir: Path, train: dict, smi: str) -> dict:
    """The mesh on the card: one H100 listed twice (and the real devices where
    there are more). Listed twice, every ``.to(device)`` is the identity, so
    it checks the sharding arithmetic, not transfers between devices or
    launches on a second one: the sharded ops, the data-parallel MAP step on LeNet5 and
    on ResNet1M at batch 16 (BatchNorm: the whole batch's statistics), the
    mesh predictors; ``evaluate --mesh`` and ``train_scale`` without
    ``--no-mesh`` on one GPU; the kernels at the mesh's shapes, timed."""
    print("== phase 31: the mesh (parallel/) on the card; on one card listed twice it "
          "checks the sharding arithmetic, not transfers between devices", flush=True)
    import io
    from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale
    from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                               params_from_jax)
    from laplace_inducing_points_tpu_torch.models.scale import ResNet1M
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn, matmul_nn_plain,
                                                                   matmul_nt, matmul_nt_plain)
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain
    from laplace_inducing_points_tpu_torch.parallel.mesh import make_mesh
    model = ResNet1M(10).cuda()
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(model), SEED))
    resnet = ModelState(model, flat.cuda(), "classifier")
    meshes = [make_mesh([torch.device("cuda", 0)] * 2)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    launches = None
    for mesh in meshes:
        counted = _mesh_checks(mesh, train, resnet, smi)
        launches = launches or counted
    _check_launches("mesh", MESH_KERNELS, launches)
    del resnet, model
    torch.cuda.empty_cache()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        evaluate.main(["--dataset", "mnist", "--config", _train_config(workdir), "--scalable",
                       "--predictive", "weight", "--mesh", "--iters", "1", "--max_batches", "1",
                       "--device", "cuda", "--ckpt_map", str(workdir / "train_map"),
                       "--ckpt_induc", str(workdir / "train_ind"), "--data_dir",
                       str(workdir / "data")])
        train_scale.main(["train_map", *_lenet5_args(
            workdir, _cut_config(workdir, CONFIG, {150: 1}, "lenet5_mesh.yml"), "mesh")])
    lines = [line for line in out.getvalue().splitlines() if line.startswith("[mesh]")]
    print(f"evaluate --mesh and train_scale train_map (mesh on by default) with "
          f"{torch.cuda.device_count()} GPU(s): [mesh] lines {lines or 'none'} (the "
          f"reference prints one only with more than one device)")
    if (torch.cuda.device_count() > 1) != bool(lines):
        raise AssertionError(f"mesh lines {lines} with {torch.cuda.device_count()} GPU(s)")
    D = train["state"].spec.num_params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    print("  the kernels at the mesh's shapes (two devices: half the samples, half of D):",
          flush=True)
    Rz = randn(1000, D)
    rows = {"syrk": _check_kernel("syrk", syrk, syrk_plain, (randn(1000, D // 2),), True),
            "matmul_nt": _check_kernel("matmul_nt", matmul_nt, matmul_nt_plain,
                                       (randn(100, D), Rz), True),
            "matmul_nn": _check_kernel("matmul_nn", matmul_nn, matmul_nn_plain,
                                       (randn(100, 1000), Rz), True)}
    return {"rows": rows, "launches": launches}


def run_last_modules(workdir: Path, train: dict, kernel_rows: dict, backward_rows: dict,
                     smi: str) -> dict:
    """Phases 28-31; the kernels' rows and launches of the gram_chunked and
    mesh paths."""
    phase_resume(workdir, smi)
    phase_profile(workdir, kernel_rows, smi)
    chunked = phase_gram_chunked(workdir, train, kernel_rows, backward_rows, smi)
    mesh = phase_mesh(workdir, train, smi)
    return {"gram_chunked": chunked, "mesh": mesh}


# --- phase 32: the convolution policy ------------------------------------------

TRANSFORMS = ("winograd", "fft")      # cuDNN kernel names of the engines the policy blocks
CONV_ALPHA = 0.005
CONV_MODELS = {"LeNet5": "mnist", "ResNet1": "cifar10"}
SURROGATE_ONLY = "data/no_such_dir"   # no files there: load_arrays gives the seeded surrogate
# shapes held beside the configs': LeNet5's rows in blocks of 8, 4 and 1 and
# ResNet1M's in blocks of 1, where cuDNN took Winograd and FFT engines, and
# ResNet1M's MAP at batch 16
NAMED_BLOCKS = {"LeNet5": (8, 4, 1), "ResNet1": (1,)}


def _blocks_of(n: int, block) -> set:
    """The example counts of the calls that build ``n`` examples' rows in blocks
    of ``block`` (``None``: one call)."""
    if not block or block >= n:
        return {n}
    return {block} | ({n % block} if n % block else set())


def _conv_shapes() -> dict:
    """Per conv model, the sizes each convolution route runs at under the 13
    scale configs and ``gram_chunked`` (read from ``configs/scale/*.yml``):
    rows and pullback (M and ip.batch_size in blocks of ip.example_block, and
    of ``example_block or 4`` for gram_chunked), the MAP batch and its halves
    on a mesh of two, the matfree factor's ``cg_example_block``, the serving
    push-forward's draws per call (ip.mc_samples in sampling.sample_block),
    the cov predictive's ``jac_block``."""
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    shapes = {m: {"rows": set(NAMED_BLOCKS[m]), "map": set(), "matfree": set(),
                  "serving": set(), "cov": set()} for m in CONV_MODELS}
    for path in sorted(Path("configs/scale").glob("*.yml")):
        cfg = load_experiment_config(str(path))
        model = cfg["model"]["name"]
        if model not in CONV_MODELS:
            continue
        ip, sampling = cfg["optimization"]["ip"], cfg.get("sampling") or {}
        s = shapes[model]
        # the matfree objective builds rows of X only; the gram objectives of Z
        # and X, gram_chunked in blocks of example_block or 4
        for n in ((ip["batch_size"],) if ip["objective"] == "stochastic_matfree"
                  else (ip["m"], ip["batch_size"])):
            s["rows"] |= _blocks_of(n, ip.get("example_block"))
            if ip["objective"] != "stochastic_matfree":
                s["rows"] |= _blocks_of(n, ip.get("example_block") or 4)
        batch = cfg["optimization"]["map"]["batch_size"]
        s["map"] |= {batch, batch // 2}
        if ip.get("cg_example_block"):
            s["matfree"].add(ip["cg_example_block"])
        s["serving"] |= _blocks_of(ip["mc_samples"], sampling.get("sample_block"))
        s["cov"].add(sampling.get("jac_block"))
    shapes["ResNet1"]["map"].add(16)
    return {m: {k: sorted(v, key=lambda b: (b is None, b or 0)) for k, v in s.items()}
            for m, s in shapes.items()}


def _conv_setup(label: str, device: str = "cuda"):
    """Seeded weights of ``label`` on ``device`` and its surrogate inputs (the
    same in every process): ``(state, float64 state, images, labels)``."""
    from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                               params_from_jax)
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    from laplace_inducing_points_tpu_torch.models.scale import LeNet5, ResNet1M
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    model = LeNet5() if label == "LeNet5" else ResNet1M(10)
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(model), SEED))
    state = ModelState(model.to(device), flat.to(device), "classifier")
    with contextlib.redirect_stdout(None):
        x, y = load_arrays(CONV_MODELS[label], train=True, root=SURROGATE_ONLY)
    return (state, _state64(state), torch.as_tensor(x[:1280]).to(device),
            torch.as_tensor(y[:1280]).long().to(device))


def _map_grad(state, x, y):
    from laplace_inducing_points_tpu_torch.training.map import map_loss
    flat = state.flat_params.clone().requires_grad_()
    loss, _ = map_loss(state, flat, x, y, CONV_ALPHA)
    return torch.autograd.grad(loss, flat)[0]


def _conv_routes(label: str, setup, shapes: dict, only=None, gen=None, batch=None) -> list:
    """``(name, gated bitwise, fn)``: each route of the port's convolutions at
    each of ``shapes``; ``fn(state, cast)`` computes it on a state of either
    precision with its inputs cast to that precision. The cotangents and
    draws come from ``gen`` (a CUDA generator at SEED + 32 by default; one on
    the CPU gives every process the same), the MAP gradient's batches from
    ``batch`` (default: the images and labels of ``setup``)."""
    from torch.func import vmap

    from laplace_inducing_points_tpu_torch.core import operators as ops
    state, _, x, y = setup
    xb, yb = batch if batch is not None else (x, y)
    D, K = state.spec.num_params, 10
    gen = gen if gen is not None else torch.Generator(device="cuda").manual_seed(SEED + 32)

    def draw(*shape):
        return torch.randn(*shape, device=gen.device, generator=gen).to(x.device)

    rows_max = max(b for b in shapes["rows"] if b is not None)
    ct = draw(rows_max * K, D)
    draws = draw(max(shapes["serving"]), D) * 0.05
    probes = draw(8, max(shapes["matfree"], default=0) * K)
    # test batch of the pushed-forward
    batch_b = min(256 if label == "LeNet5" else 32, len(x))
    routes = []
    for b in shapes["rows"]:
        routes.append((f"rows, block of {b}", True,
                       lambda st, c, b=b: ops.dense_wt(st, c(x[:b]))))
        routes.append((f"row pullback, block of {b}", False,
                       lambda st, c, b=b: ops.dense_wt_pullback(st, c(x[:b]), c(ct[:b * K]))))
    for b in shapes["matfree"]:
        routes.append((f"matfree W factor (jvp + vjp), block of {b}", False,
                       lambda st, c, b=b: ops.make_w_factor(st, c(x[:b]), example_block=b)
                       .gram_matmat(c(probes[:, :b * K]))))
    for n in shapes["map"]:
        routes.append((f"MAP gradient, batch {n}", True,
                       lambda st, c, n=n: _map_grad(st, c(xb[:n]),
                                                     yb[:n].to(st.flat_params.device))))
    for s in shapes["serving"]:
        routes.append((f"serving push-forward, {s} draws on {batch_b} images", False,
                       lambda st, c, s=s: vmap(ops.linearize_model(st, c(x[:batch_b])).jvp)(
                           c(draws[:s]))))
    for jb in shapes["cov"]:
        routes.append((f"cov Jacobians, {batch_b} images, jac_block {jb}", False,
                       lambda st, c, jb=jb: torch.cat([
                           t.reshape(-1) for t in ops.predictive_jac_stats(
                               st, c(x[:batch_b]), c(ct[:K * 4]), jac_block=jb)])))
    return [r for r in routes if only is None or r[0] in only]


def _cudnn_off():
    """PyTorch's own convolutions (cuDNN off), TF32 off."""
    return torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=True,
                                      allow_tf32=False)


# Phase 32's reference check, at small sizes: rows and pullback in blocks of 1,
# 2, 4 and 10, the MAP gradient at batch 16 (train mode), 25 draws pushed
# forward, the cov Jacobians at one jac_block; on the first STEP1_IMAGES
# surrogate images and the MAP on the first 16. Each float32 result is held
# against float64 on the float32 forward's own ReLU masks
# (``utils.relu_masks``): at a kink the Jacobian jumps, and one pre-activation
# within float32 round-off of 0 (ResNet1M has ~3 x 10^5 an image; such an
# input flips in 5 of its first 64 images and in every train-mode batch of
# 16) puts the rows ~1e-3 from float64 with plain ReLUs whatever the
# arithmetic. The cov Jacobians are the rows' (the same ``jacobian_fn`` on
# the same 10 images in one block), so "rows, block of 10" holds their
# convolutions at the CPU float32 level; the cov route's own limit is set by
# the CPU's float32 contractions over D (printed beside it with them in
# float64).
STEP1 = {"rows": [1, 2, 4, 10], "map": [16], "serving": [25], "cov": [32], "matfree": []}
STEP1_IMAGES = 10
REF_TOL = 1e-12          # the card's float64 routes against the CPU's, on the CPU's masks


def _grad_mode(name: str):
    """Autograd for the routes that differentiate, ``no_grad`` for the rest."""
    return (contextlib.nullcontext() if "gradient" in name or "pullback" in name
            else torch.no_grad())


def _reference(state, s64, fn, masks_of=None) -> torch.Tensor:
    """``fn`` in float64 (``s64``) on the ReLU masks of the float32 forward of
    ``masks_of`` (default ``state``; a state on the CPU gives the CPU's)."""
    from laplace_inducing_points_tpu_torch.utils.relu_masks import replay_relu_masks
    with replay_relu_masks(masks_of or state, s64):
        return fn(s64, lambda t: t.double()).detach()


def _cpu_state(state):
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    return ModelState(copy.deepcopy(state.model).cpu(), state.flat_params.cpu(),
                      state.model_kind, {k: v.cpu() for k, v in state.batch_stats.items()})


def _step1_routes(label: str, setup, only=None) -> list:
    """Phase 32's STEP1 routes on the first STEP1_IMAGES images (the MAP
    gradient on the first 16), their draws from a CPU generator."""
    state, s64, x, y = setup
    return _conv_routes(label, (state, s64, x[:STEP1_IMAGES], y[:STEP1_IMAGES]), STEP1, only,
                        gen=torch.Generator().manual_seed(SEED + 33), batch=(x[:16], y[:16]))


def cpu_reference(path: str) -> int:
    """``chip_smoke.py --cpu-reference OUT``: the STEP1 routes on the CPU for
    both conv models, each in float64 on the CPU float32 port's ReLU masks
    and the port's float32 distance from it (the cov route's also with its
    contractions, ``pdot``, in float64), written to OUT (``torch.save``).
    Phase 32 holds the card against them. It runs beside the earlier phases
    at the lowest priority (nice 19), on the CPU time they leave idle."""
    os.nice(19)
    from laplace_inducing_points_tpu_torch.core import operators as ops
    out = {}
    for label in CONV_MODELS:
        setup = _conv_setup(label, device="cpu")
        state, s64, _, _ = setup
        for name, _, fn in _step1_routes(label, setup):
            t0 = time.perf_counter()
            with _grad_mode(name):
                ref = _reference(state, s64, fn)
                row = {"cpu64": ref, "cpu32_err": _rel(fn(state, lambda t: t).detach(), ref)}
                if name.startswith("cov"):
                    pdot = ops.pdot
                    ops.pdot = lambda a, b: (a.double() @ b.double()).to(a.dtype)
                    try:
                        row["cpu32_err_f64_pdot"] = _rel(fn(state, lambda t: t).detach(), ref)
                    finally:
                        ops.pdot = pdot
            out[f"{label} {name}"] = dict(row, seconds=time.perf_counter() - t0)
    torch.save(out, path)
    return 0


def _measure_step1(setups: dict, cpu: dict) -> dict:
    """The STEP1 routes on the card: float32 under the policy and with cuDNN
    off, each against float64 on its own ReLU masks under the same settings
    (with cuDNN off also against float64 with plain ReLUs, which shows the
    kinks); and float64 on the CPU float32 port's masks, cuDNN on and off,
    against the CPU's float64 on the same masks (``cpu``, from
    :func:`cpu_reference`), beside the CPU float32 port's distance."""
    out = {}
    for label, setup in setups.items():
        state, s64, _, _ = setup
        on_cpu = _cpu_state(state)
        for name, _, fn in _step1_routes(label, setup):
            key = f"{label} {name}"
            row = {k: v for k, v in cpu[key].items() if k != "cpu64"}
            with _grad_mode(name):
                for way, flags in (("policy", contextlib.nullcontext), ("off", _cudnn_off)):
                    with flags():
                        f32 = fn(state, lambda t: t).detach()
                        row[f"card32_{way}"] = _rel(f32, _reference(state, s64, fn))
                        row[f"card64_{way}"] = _rel(_reference(state, s64, fn, on_cpu).cpu(),
                                                    cpu[key]["cpu64"])
                        if way == "off":
                            row["card32_plain"] = _rel(f32, fn(s64, lambda t: t.double()).detach())
            out[key] = row
        torch.cuda.empty_cache()
    return out


def _wait_cpu_reference(cpu_ref) -> dict:
    proc, path = cpu_ref
    t0 = time.perf_counter()
    out = proc.communicate(timeout=900)[0]
    if proc.returncode:
        print(out[-4000:])
        raise AssertionError(f"the CPU reference exited {proc.returncode}")
    print(f"  the CPU reference (a process at nice 19 beside phases 3-31; waited "
          f"{time.perf_counter() - t0:.1f} s for it)", flush=True)
    return torch.load(path)


def _check_step1(setups: dict, cpu_ref) -> tuple[list, dict]:
    """Phase 32's STEP1 table and its gates (see :func:`phase_conv_policy`):
    the failures and the table."""
    rows = _measure_step1(setups, _wait_cpu_reference(cpu_ref))
    print(f"  STEP1 routes on the first {STEP1_IMAGES} images (the MAP gradient on the first 16, "
          f"train mode), each float32 result against float64 on its own ReLU masks; ResNet1M's "
          f"with cuDNN off gated at {F64_RATIO}x the CPU float32 port's, under the policy at "
          f"{F64_RATIO}x cuDNN off's:", flush=True)
    failures = []
    for key, row in rows.items():
        limit = F64_RATIO * row["cpu32_err"]
        pdot = row.get("cpu32_err_f64_pdot")
        print(f"  {key}: card float32 {row['card32_policy']:.2e} under the policy, "
              f"{row['card32_off']:.2e} with cuDNN off ({row['card32_plain']:.2e} against plain "
              f"ReLUs); CPU float32 {row['cpu32_err']:.2e}"
              + (f" ({pdot:.2e} with its contractions in float64)" if pdot is not None else "")
              + f"; card float64 {row['card64_policy']:.1e} (cuDNN off {row['card64_off']:.1e}) "
              f"from the CPU's on the CPU's masks; the CPU took {row['seconds']:.1f} s"
              + (f"; limit {limit:.2e}" if key.startswith("ResNet1") else ""), flush=True)
        if not max(row["card64_policy"], row["card64_off"]) <= REF_TOL:
            failures.append(f"{key}: the card's float64 {row['card64_policy']:.1e} "
                            f"(cuDNN off {row['card64_off']:.1e}) from the CPU's")
        policy, off = row["card32_policy"], row["card32_off"]
        if key.startswith("ResNet1") and not (off <= limit and policy <= F64_RATIO * off):
            failures.append(f"{key}: {policy:.2e} (cuDNN off {off:.2e}) from float64, the CPU "
                            f"float32 port {row['cpu32_err']:.2e}")
    return failures, rows


def _unrestricted_rows(before: dict, rows: dict) -> None:
    """Without the policy (``before``), ResNet1M's rows in blocks of 1 and 2
    (STEP1's images) against the absolute gate's limit (``rows``, STEP1's
    table)."""
    for mode in ("unrestricted", "deterministic"):
        for b in (1, 2):
            err = before[mode][f"ResNet1 rows, block of {b}"]["err"]
            limit = F64_RATIO * rows[f"ResNet1 rows, block of {b}"]["cpu32_err"]
            print(f"  without the policy ({mode}): ResNet1M rows, block of {b}: {err:.2e} from "
                  f"float64 on its masks; the gate's limit {limit:.2e} "
                  f"{'catches it' if err > limit else 'passes it'}", flush=True)


def _check_probe(first, smi: str) -> list:
    """The policy's probe: its error and its cost in this process (the first
    call, at the process's first convolution, and warm), and ``first``, the
    ``--conv-first`` process (a cuDNN convolution before the port), which must
    exit on the probe's error; the failures."""
    from laplace_inducing_points_tpu_torch.utils import device as policy
    stdout, stderr = first.communicate(timeout=300)
    said = [line for line in stderr.splitlines() if "convolution policy is not in force" in line]
    print(f"  a process that ran cuDNN before the port (run beside the routes above): exit "
          f"{first.returncode} ({''.join(stdout.strip().splitlines()[:1])}); "
          f"{said[-1] if said else stdout.strip()}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    err, first_s = policy.PROBED[str(dev)]
    warm = statistics.median(_host_s(lambda: policy.probe_error(dev))[1] for _ in range(5))
    print(f"  the policy's probe: {err:.2e} from float64 (limit {policy.PROBE_LIMIT:g}); its first "
          f"call {first_s * 1e3:.1f} ms (the process's first convolution), warm "
          f"{warm * 1e3:.2f} ms ({smi})", flush=True)
    if first.returncode == 0 or not said:
        print(stdout[-2000:], stderr[-2000:])
        return ["a process that ran cuDNN before the port did not fail on the probe"]
    return []


def conv_first() -> int:
    """``chip_smoke.py --conv-first``: a cuDNN convolution before the port is
    imported (no errata file named), then a LeNet5 row: the policy's probe
    must raise, so this exits non-zero. Prints the seconds of that first
    convolution (cuDNN loads) and of the probe after it."""
    import torch.nn.functional as F
    t0 = time.perf_counter()
    F.conv2d(torch.rand(2, 3, 8, 8, device="cuda"), torch.rand(4, 3, 3, 3, device="cuda"))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    setup = _conv_setup("LeNet5")
    from laplace_inducing_points_tpu_torch.core import operators as ops
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            ops.dense_wt(setup[0], setup[2][:1])
    finally:
        print(f"the process's first convolution {first:.2f} s; the probe after it "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    print("no error: the probe passed a process that ran cuDNN first")
    return 0


def _transform_names(fn) -> list:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    return sorted({n.split("(")[0].replace("void ", "")[:48] for n in names
                   if any(w in n.lower() for w in TRANSFORMS)})


def _measure_routes(label: str, setup, routes: list, with_off: bool = True) -> dict:
    """Each route's error from float64 on its own ReLU masks, whether two
    evaluations are bitwise equal, and the Winograd and FFT kernels it
    launched, under the cuDNN settings in force; with ``with_off`` also the
    error of the cuDNN-off path (PyTorch's own convolutions) on the same
    inputs, from float64 on the cuDNN-off forward's masks."""
    state, s64, _, _ = setup
    out = {}
    for name, _, fn in routes:
        with _grad_mode(name):
            ref = _reference(state, s64, fn)
            a, b = (fn(state, lambda t: t).detach() for _ in range(2))
            row = {"err": _rel(a, ref), "bitwise": bool(torch.equal(a, b)),
                   "transforms": _transform_names(lambda: fn(state, lambda t: t))}
            if with_off:
                with _cudnn_off():
                    row["err_off"] = _rel(fn(state, lambda t: t).detach(),
                                          _reference(state, s64, fn))
        out[f"{label} {name}"] = row
        del ref, a, b
    torch.cuda.empty_cache()
    return out


def _cost_steps(setups: dict) -> dict:
    """Warm host seconds (synchronised, after one warm-up: the median of 3
    MAP steps, of 2 LeNet5 steps, one of the others) of the steps the policy
    could slow: LeNet5's MAP step (batch 256), gram Z step
    (M = 100, d_x = 1,280), factor build and serving batch (S = 200, B = 256);
    ResNet1M's MAP step (256), Z step (M = 50, 32 points, blocks of 4) and
    serving batch (S = 200 in blocks of 25, B = 256); the matfree1k Z step
    (M = 1,024, the config's ip knobs), all on seeded weights."""
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
    from laplace_inducing_points_tpu_torch.training.inducing import (kl_value_and_grad_gram,
                                                                     kl_value_and_grad_matfree)
    from laplace_inducing_points_tpu_torch.training.map import map_step, working_state
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config

    def warm(fn, reps=2):
        fn()
        return statistics.median(_host_s(fn)[1] for _ in range(reps))

    def map_s(state, x, y):
        work = working_state(state, state.flat_params.clone())
        flat = state.flat_params.clone().requires_grad_()
        opt = torch.optim.Adam([flat], lr=1e-4, eps=1e-8)
        return warm(lambda: map_step(work, flat, opt, (x, y), CONV_ALPHA), 3)

    out = {}
    gen = torch.Generator(device="cuda")
    for label, M, d_x, block, sample_block in (("LeNet5", 100, 128, None, None),
                                               ("ResNet1", 50, 32, 4, 25)):
        state, _, x, y = setups[label]
        out[f"{label} MAP step"] = map_s(state, x[:256], y[:256])
        Z, X = x[:M], x[M:M + d_x]
        reps = 2 if label == "LeNet5" else 1
        out[f"{label} Z step"] = warm(lambda: kl_value_and_grad_gram(
            Z, X, state, CONV_ALPHA, full_set_size=60000, example_block=block), reps)
        with torch.no_grad():
            build = lambda: ScalableLLAPredictor(  # noqa: E731
                state, Z, full_set_size=60000, example_block=block, range_clip_min=1.0,
                sample_block=sample_block)
            if label == "LeNet5":
                out[f"{label} factor build"] = warm(build)
            pred = build()
            out[f"{label} serving batch"] = warm(lambda: pred.logit_samples(
                x[:256], CONV_ALPHA, gen.manual_seed(SEED), 200), reps)
        del pred
    ip = load_experiment_config(MATFREE["matfree1k"])["optimization"]["ip"]
    state, _, _, _ = setups["LeNet5"]
    with contextlib.redirect_stdout(None):
        images = torch.as_tensor(load_arrays("mnist", True, root=SURROGATE_ONLY)[0][:1152]).cuda()
    knobs = {k: ip[k] for k in ("st_samples", "slq_samples", "slq_num_matvecs", "cg_tol",
                                "cg_maxiter", "precond_rank", "precond_power",
                                "cg_example_block")}
    out["matfree1k Z step"] = warm(lambda: kl_value_and_grad_matfree(
        images[:1024], images[1024:], state, 1000.0, gen.manual_seed(SEED), full_set_size=8192,
        **knobs), 1)
    torch.cuda.empty_cache()
    return out


def conv_before(path: str, go: str) -> int:
    """``chip_smoke.py --conv-before OUT GO``: phase 32's measurements without
    the convolution policy, in a process of their own (cuDNN reads its errata
    file once a process), written to ``OUT`` as JSON: the named routes
    (``NAMED_BLOCKS``; ResNet1M's rows in blocks of 1 and 2 are STEP1's), with
    cuDNN unrestricted and with ``deterministic`` alone, and then, once the
    file GO exists (phase 32 leaves the card to it), the steps' times
    unrestricted."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    from laplace_inducing_points_tpu_torch.models import layers
    from laplace_inducing_points_tpu_torch.utils import device
    for module in (layers, device):     # cuDNN as PyTorch sets it: TF32 off, nothing else
        module.set_conv_policy = lambda *args: setattr(torch.backends.cudnn, "allow_tf32", False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setups = {label: _conv_setup(label) for label in CONV_MODELS}
    shapes = _conv_shapes()
    named = {"LeNet5": [f"rows, block of {b}" for b in (8, 4, 1)],
             "ResNet1": [f"rows, block of {b}" for b in (2, 1)] + ["MAP gradient, batch 16"]}
    result = {}
    for mode, deterministic in (("unrestricted", False), ("deterministic", True)):
        torch.backends.cudnn.deterministic = deterministic
        result[mode] = {}
        for label in CONV_MODELS:
            routes = _conv_routes(label, setups[label], shapes[label], named[label])
            result[mode].update(_measure_routes(label, setups[label], routes, with_off=False))
    torch.backends.cudnn.deterministic = False
    deadline = time.perf_counter() + 900
    while not Path(go).exists():
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{go} did not appear")
        time.sleep(0.05)
    result["steps"] = _cost_steps(setups)
    Path(path).write_text(json.dumps(result))
    return 0


def phase_conv_policy(workdir: Path, smi: str, cpu_ref) -> None:
    """The convolution policy (``utils.device.set_conv_policy``) on every route
    of the port's convolutions at every size the scale configs give it
    (:func:`_conv_shapes`), on seeded LeNet5 and ResNet1M and surrogate
    images: each route's float32 result against the same computation in
    float64 on its own ReLU masks (``utils.relu_masks``) no further than
    F64_RATIO times the cuDNN-off path's (PyTorch's own convolutions) on the
    same inputs; the rows and the MAP gradient bitwise
    equal in two evaluations; no Winograd or FFT kernel launched. Then the
    same routes and the steps' times without the policy (a subprocess:
    cuDNN reads its errata file once a process), and two factor builds'
    logits on the same noise. The STEP1 routes against the CPU's float64
    (``cpu_ref``: the process of :func:`cpu_reference` and its output): the
    card's float64 on the CPU's masks within REF_TOL of it, and each ResNet1M
    route's cuDNN-off float32 within F64_RATIO times the CPU float32 port's
    distance (each from float64 on its own masks). The policy's probe: its error and cost,
    and a process that ran cuDNN before the port must fail on it."""
    print("== phase 32: the convolution policy (cuDNN deterministic, Winograd and FFT "
          "engines blocked) on every convolution route", flush=True)
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
    from laplace_inducing_points_tpu_torch.utils.device import CUDNN_ERRATA
    print(f"  cuDNN {torch.backends.cudnn.version()}, CUDNN_ERRATA_JSON_FILE="
          f"{os.environ.get('CUDNN_ERRATA_JSON_FILE')}, deterministic "
          f"{torch.backends.cudnn.deterministic}, benchmark {torch.backends.cudnn.benchmark}, "
          f"allow_tf32 {torch.backends.cudnn.allow_tf32}")
    if os.environ.get("CUDNN_ERRATA_JSON_FILE") != str(CUDNN_ERRATA):
        raise AssertionError("the convolution policy's errata file is not in force")
    shapes = _conv_shapes()
    print(f"  sizes from configs/scale/*.yml (and the named ones): {json.dumps(shapes)}")
    setups = {label: _conv_setup(label) for label in CONV_MODELS}
    # the two processes without the policy run beside the routes below, which
    # are not timed; the steps' times come after, one process at a time
    out, go = workdir / "conv_before.json", workdir / "conv_before.go"
    env = {k: v for k, v in os.environ.items() if k != "CUDNN_ERRATA_JSON_FILE"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, *args], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for args in (["--conv-before", str(out), str(go)], ["--conv-first"])]
    try:
        rows = {}
        for label in CONV_MODELS:
            routes = _conv_routes(label, setups[label], shapes[label])
            gated = {f"{label} {name}" for name, bitwise, _ in routes if bitwise}
            rows.update({k: dict(v, gated_bitwise=k in gated)
                         for k, v in _measure_routes(label, setups[label], routes).items()})
        print(f"  routes measured in {time.perf_counter() - t0:.1f} s")
        failures, step1 = _check_step1(setups, cpu_ref)
        failures += _check_probe(procs[1], smi)
        go.touch()
        stdout, stderr = procs[0].communicate(timeout=600)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if procs[0].returncode:
        print(stdout[-4000:], stderr[-4000:])
        raise AssertionError(f"the measurement without the policy exited {procs[0].returncode}")
    before = json.loads(out.read_text())
    print(f"  without the policy (a subprocess): {time.perf_counter() - t0:.1f} s from the "
          f"phase's routes", flush=True)
    for key, row in rows.items():
        ref = {mode: before[mode].get(key) for mode in ("unrestricted", "deterministic")}
        extra = "".join(f"; {mode} {r['err']:.2e}{' bitwise' if r['bitwise'] else ''}"
                        f"{' ' + ','.join(r['transforms']) if r['transforms'] else ''}"
                        for mode, r in ref.items() if r)
        print(f"  {key}: policy {row['err']:.2e} against float64 (cuDNN off {row['err_off']:.2e}, "
              f"limit {F64_RATIO}x); two evaluations {'bitwise equal' if row['bitwise'] else 'differ'}"
              f"{'; Winograd/FFT: ' + ','.join(row['transforms']) if row['transforms'] else ''}"
              f"{extra}", flush=True)
        if not row["err"] <= F64_RATIO * row["err_off"]:
            failures.append(f"{key}: {row['err']:.2e} from float64, cuDNN off {row['err_off']:.2e}")
        if row["gated_bitwise"] and not row["bitwise"]:
            failures.append(f"{key}: two evaluations differ")
        if row["transforms"]:
            failures.append(f"{key}: launched {row['transforms']}")
    _unrestricted_rows(before, step1)
    after = _cost_steps(setups)
    for name, old in ((n, before["steps"][n]) for n in after):
        print(f"  {name}: {old:.4f} s without the policy, {after[name]:.4f} s with it "
              f"({after[name] / old:.2f}x) ({smi})", flush=True)
    # two factor builds on one MAP and one Z: the same logits on the same noise?
    state, _, x, _ = setups["LeNet5"]
    Z = x[:100]
    with torch.no_grad():
        preds = [ScalableLLAPredictor(state, Z, full_set_size=60000, range_clip_min=1.0)
                 for _ in range(2)]
        logits = [p.logit_samples(x[:256], CONV_ALPHA, torch.Generator(device="cuda")
                                  .manual_seed(SEED), 200) for p in preds]
    parts = {"rows": torch.equal(preds[0].R, preds[1].R),
             "Gram": torch.equal(preds[0].gram, preds[1].gram),
             "eigh": torch.equal(preds[0].lam, preds[1].lam) and torch.equal(preds[0].V, preds[1].V),
             "logits": torch.equal(logits[0], logits[1])}
    print(f"  two factor builds on one MAP and one Z (LeNet5, M = 100): bitwise equal "
          f"{json.dumps(parts)}; logits on the same noise rel {_rel(logits[1], logits[0]):.2e}",
          flush=True)
    if failures:
        raise AssertionError("the convolution policy failed its gate: " + "; ".join(failures))


# --- phase 33: the toy generators ---------------------------------------------

def phase_make_data(workdir: Path, smi: str) -> None:
    """``python -m laplace_inducing_points_tpu_torch.cli.make_data`` for each
    toy dataset (the processes run side by side), each file's shape, labels and
    finiteness; then ``cli.main_toy full_pipeline`` on banana at a seed that no
    committed fixture holds (map.epochs 250 -> 20, ip.epochs 500 -> 20): the
    port draws the data, writes it with its own generator key, and trains."""
    print("== phase 33: the toy generators (cli.make_data for each dataset, then "
          "main_toy on banana at a seed without a fixture)", flush=True)
    from laplace_inducing_points_tpu_torch.cli import main_toy
    from laplace_inducing_points_tpu_torch.data.toy import (GENERATORS, PORT_GENERATOR,
                                                            load_dataset)
    out = workdir / "make_data"
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "laplace_inducing_points_tpu_torch.cli.make_data", "--dataset",
         name, "--n_samples", "512", "--seed", "33", "--out_file", str(out / f"{name}.npz"),
         *(["--split_in_middle"] if name == "sine" else [])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in GENERATORS}
    for name, proc in procs.items():
        text = proc.communicate(timeout=300)[0]
        if proc.returncode:
            print(text)
            raise AssertionError(f"cli.make_data --dataset {name} exited {proc.returncode}")
        x, y = load_dataset(str(out / f"{name}.npz"))
        labels = "regression targets" if name == "sine" else f"labels {sorted(set(y.tolist()))}"
        print(f"  {text.strip().splitlines()[-1]}; finite {bool(np.isfinite(x).all())}, {labels}")
        if not (x.shape[0] == 512 and np.isfinite(x).all() and np.isfinite(y).all()
                and (name == "sine" or set(y.tolist()) <= {0, 1})):
            raise AssertionError(f"cli.make_data --dataset {name} wrote {x.shape}, {y.shape}")
    print(f"  {len(procs)} make_data processes side by side: {time.perf_counter() - t0:.1f} s")
    text = Path(TOY["banana"]).read_text()
    if text.count("  seed: 584848\n") != 1:
        raise AssertionError(f"{TOY['banana']} has no single data seed 584848")
    (workdir / "banana_seed33.yml").write_text(text.replace("  seed: 584848\n", "  seed: 33\n"))
    config = _cut_config(workdir, str(workdir / "banana_seed33.yml"), {250: 20, 500: 20},
                         "banana_seed33_cut.yml")
    dirs, common = _toy_dirs(workdir, "banana33")
    log = workdir / "toy_banana33.log"
    result = _quiet(main_toy.main, ["full_pipeline", "--dataset", "banana", "--config", config,
                                    "--fig_dir", dirs["fig"], *common], log)
    drawn = [line for line in log.read_text().splitlines() if "drawn by the port's generator" in line]
    with np.load(Path(dirs["data"]) / "banana.npz") as d:
        generator, seed = str(d["generator"]), int(d["seed"])
    mp, ind = result["map"], result["inducing"]
    print(f"  main_toy banana at data seed 33: {drawn[0] if drawn else 'no data line'}; "
          f"MAP {mp['steps']} steps, loss {mp['loss_head']:.4f} -> {mp['loss_tail']:.4f} "
          f"(means of the first and last 10), {mp['s_per_step']:.5f} s a step; Z "
          f"{ind['steps']} steps, loss {ind['loss_first']:.6g} -> {ind['loss_last']:.6g}, max "
          f"|Z - Z0| {ind['z_moved']:.4g}; figures {result['figures']} ({smi})", flush=True)
    if not (drawn and generator == PORT_GENERATOR and seed == 33):
        raise AssertionError("main_toy did not draw banana at seed 33 with the port's generator")
    if not (math.isfinite(mp["loss_tail"]) and mp["loss_tail"] < mp["loss_head"]
            and ind["z_moved"] > 0 and math.isfinite(ind["loss_last"])
            and all(result["figures"].values())):
        raise AssertionError(f"main_toy on banana at seed 33: {mp}, {ind}, {result['figures']}")


# --- phase 34: the public API --------------------------------------------------

def phase_public_api(workdir: Path, train: dict, last: dict, smi: str) -> dict:
    """The package's public API on the card, imported only through the
    subpackages' exports: ``count_params``/``num_curvature_params`` of LeNet5
    and ResNet1M; ``train_inducing_points`` (gram, 3 steps on phase 7's MAP,
    M = 100, X its 128 images) with the ``mnist`` image callback at every
    step, launching B1 and B2 and their backward passes (the counts reset
    just before); ``is_pd`` on the Gram of the trained Z plus α·I, and on it
    with one eigenvalue shifted negative; ``nystrom_preconditioner`` feeding
    ``cg_batched`` on that Gram plus α·I (fewer iterations than plain CG);
    ``exp_plots`` on a record of the ``cli/evaluate.py --out_json`` format
    that holds this predictor's metrics on one test batch. Then the step's
    kernels timed at its shapes (d_z = 1,000, d_x = 1,280, D = 61,706) by
    phase 12's rules."""
    print("== phase 34: the public API through the subpackages' exports", flush=True)
    from laplace_inducing_points_tpu_torch.core import (count_params, dense_wt,
                                                        num_curvature_params)
    from laplace_inducing_points_tpu_torch.data import cycling_batches
    from laplace_inducing_points_tpu_torch.evaluation import eval_dataset_extended
    from laplace_inducing_points_tpu_torch.inference import ScalableLLAPredictor
    from laplace_inducing_points_tpu_torch.models import LeNet5, ResNet1M
    from laplace_inducing_points_tpu_torch.ops import cg_batched, nystrom_preconditioner, syrk
    from laplace_inducing_points_tpu_torch.training import train_inducing_points
    from laplace_inducing_points_tpu_torch.utils import is_pd
    from laplace_inducing_points_tpu_torch.viz import exp_plots
    from laplace_inducing_points_tpu_torch.viz.nplot import make_inducing_callback
    t0 = time.perf_counter()
    state, X, alpha = train["state"], train["X"][:128], train["alpha"]
    counts = {"LeNet5": (count_params(LeNet5()), num_curvature_params(state)),
              "ResNet1M": (count_params(ResNet1M(10)), num_curvature_params(ResNet1M(10)))}
    print(f"  count_params, num_curvature_params: {json.dumps(counts)}", flush=True)
    if counts != {"LeNet5": (61706, 61706), "ResNet1M": (1084586, 1084586)}:
        raise AssertionError(f"parameter counts {counts}")
    fig_dir = workdir / "fig_public_api"
    callback = make_inducing_callback("mnist", every=1, fig_dir=str(fig_dir))
    _reset_counts()
    Z = train_inducing_points(state, train["Z"], cycling_batches([(X, torch.zeros(len(X)))]),
                              alpha=alpha, num_steps=3, lr=1e-3, full_set_size=60000,
                              callback=callback)
    launches = _read_counts()
    try:
        import matplotlib  # noqa: F401
        png = (fig_dir / "ips_mnist.png").exists()
    except ImportError:
        png = None
    print(f"  train_inducing_points: 3 gram steps, Z moved {float((Z - train['Z']).abs().max()):.3g};"
          f" launches {json.dumps({k: launches[k] for k in CHUNKED_KERNELS})}; ips_mnist.png "
          f"{'written' if png else 'not written' if png is False else 'not drawn (no matplotlib)'}",
          flush=True)
    if not (all(launches[k] > 0 for k in CHUNKED_KERNELS) and bool(torch.isfinite(Z).all())
            and not torch.equal(Z, train["Z"]) and png is not False):
        raise AssertionError(f"train_inducing_points through the exports: {launches}, png {png}")
    with torch.no_grad():
        G = syrk(dense_wt(state, Z)).double()
    C = G + alpha * torch.eye(len(G), dtype=G.dtype, device=G.device)
    lam, V = torch.linalg.eigh(C)
    C_neg = C - (float(lam[0]) + 1.0) * torch.outer(V[:, 0], V[:, 0])
    pd = (is_pd(C), is_pd(C_neg))
    print(f"  is_pd(Gram + alpha I) {pd[0]} (eigenvalues {float(lam[0]):.3g} .. "
          f"{float(lam[-1]):.3g}); one eigenvalue shifted to -1: {pd[1]}", flush=True)
    if pd != (True, False):
        raise AssertionError(f"is_pd {pd}")
    G32 = G.float()
    matmat = lambda B: B @ G32 + alpha * B  # noqa: E731
    B = torch.randn(4, len(G32), device="cuda", generator=torch.Generator(device="cuda")
                    .manual_seed(SEED + 34))
    precond = nystrom_preconditioner(lambda B: B @ G32, len(G32), 64, alpha,
                                     torch.Generator(device="cuda").manual_seed(SEED + 35))
    _, plain = cg_batched(matmat, B, tol=1e-4, maxiter=2000)
    _, pre = cg_batched(matmat, B, tol=1e-4, maxiter=2000, precond=precond)
    print(f"  nystrom_preconditioner (rank 64) into cg_batched on Gram + alpha I: "
          f"{int(pre.iterations)} iterations (residual {float(pre.rel_residual):.1e}) against "
          f"{int(plain.iterations)} unpreconditioned ({float(plain.rel_residual):.1e})",
          flush=True)
    if not int(pre.iterations) < int(plain.iterations):
        raise AssertionError("the Nystrom preconditioner did not cut CG's iterations")
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    with contextlib.redirect_stdout(None):
        xt, yt = load_arrays("mnist", train=False, root=train["data_dir"])
    with torch.no_grad():
        pred = ScalableLLAPredictor(state, Z, full_set_size=60000)
        rec = eval_dataset_extended(state, [(xt[:256], yt[:256])], Z, alpha=alpha,
                                    full_set_size=60000, num_mc_samples=200,
                                    generator=torch.Generator(device="cuda").manual_seed(SEED),
                                    predictor=pred)
    record = {"dataset": "mnist", "alpha": alpha, "iter": 0, "predictive": "weight",
              "mc": 200, "device": "cuda", "batches": 1,
              **{k: rec[k] for k in ("nll", "acc", "brier", "ece")}}
    jsonl = workdir / "public_api_eval.jsonl"
    jsonl.write_text(json.dumps(record) + "\n")
    drawn = exp_plots.plot_records(exp_plots.load_records([str(jsonl)]),
                                   str(fig_dir / "exp.png"))
    print(f"  exp_plots on its evaluate record {json.dumps(record)}: "
          f"{drawn or 'not drawn (no matplotlib)'}; phase 34 took "
          f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    if exp_plots.load_records([str(jsonl)]) != [record] or not all(
            math.isfinite(record[k]) for k in ("nll", "acc", "brier", "ece")):
        raise AssertionError(f"the evaluate record {record}")
    rows = _scale_kernels("public_api", 10 * len(Z), 10 * len(X), state.spec.num_params)
    rows["matmul_nt"] = rows["matmul_nt.cross_gram"]        # the step's matmul_nt
    return {"launches": {k: launches[k] for k in CHUNKED_KERNELS}, "rows": rows}


def start_cpu_reference(workdir: Path):
    """Phase 32's CPU reference (:func:`cpu_reference`), started to run beside
    phases 3-31: ``(process, output path)``."""
    print("== phase 32's CPU reference started beside the phases before it (nice 19)", flush=True)
    out = workdir / "cpu_reference.pt"
    proc = subprocess.Popen([sys.executable, __file__, "--cpu-reference", str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def main() -> int:
    start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        cpu_ref = start_cpu_reference(Path(tmp))
        try:
            return _phases(Path(tmp), smi, cpu_ref, start)
        finally:
            if cpu_ref[0].poll() is None:
                cpu_ref[0].kill()
                cpu_ref[0].wait()


def _phases(workdir: Path, smi: str, cpu_ref, start: float) -> int:
    def lap(phases: str):
        print(f"  [phases {phases} done {time.perf_counter() - start:.1f} s into the run]",
              flush=True)

    kernel_rows = phase_kernels()
    launches, _ = phase_main_path(workdir)
    lap("3-4")
    phase_agreement(workdir)
    backward_rows = phase_backward()
    lap("5-6")
    train = phase_training(workdir, backward_rows)
    phase_gradient_agreement(train)
    lap("7-8")
    sweep_rows = phase_sweep()
    stochastic = phase_stochastic(workdir, train)
    phase_estimator_agreement(train, stochastic["ip"])
    lap("9-11")
    print("== phase 12: the kernels at the wide MLP's shapes (mlp_mnist.yml)",
          flush=True)
    scale_rows = {"mlp_mnist": _scale_kernels(
        "mlp_mnist", 1000, 1280, 235146,
        extra=(("syrk", (lambda g: torch.randn(2560, 235146, generator=g,
                                               device="cuda"),)),))}
    scale = {"mlp_mnist": phase_scale_path(workdir, "mlp_mnist", "phase 13")}
    phase_scale_timings(scale["mlp_mnist"], "mlp_mnist")
    lap("12-13")
    del scale["mlp_mnist"]["state"], scale["mlp_mnist"]["Z"], scale["mlp_mnist"]["X"]
    print("== phase 14: the kernels at ResNet1M's shapes (resnet1m_cifar10.yml)",
          flush=True)
    scale_rows["resnet1m_cifar10"] = _scale_kernels(
        "resnet1m_cifar10", 500, 320, 1084586,
        extra=(("matmul_nn", (lambda g: torch.randn(500, 500, generator=g, device="cuda"),
                              lambda g: torch.randn(500, 1084586, generator=g,
                                                    device="cuda"))),
               ("matmul_nn", (lambda g: torch.randn(500, 320, generator=g, device="cuda"),
                              lambda g: torch.randn(320, 1084586, generator=g,
                                                    device="cuda")))))
    resnet = phase_scale_path(workdir, "resnet1m_cifar10", "phase 15")
    phase_scale_timings(resnet, "resnet1m_cifar10")
    phase_gradient_agreement(resnet, "phase 16")
    lap("14-16")
    scale["resnet1m_cifar10"] = resnet
    del resnet["state"], resnet["Z"], resnet["X"]
    torch.cuda.empty_cache()
    matfree = run_matfree(workdir, smi)
    lap("17-21")
    torch.cuda.empty_cache()
    toy = run_toy(workdir, smi)
    lap("22-27")
    torch.cuda.empty_cache()
    last = run_last_modules(workdir, train, kernel_rows, backward_rows, smi)
    lap("28-31")
    phase_conv_policy(workdir, smi, cpu_ref)
    lap("32")
    phase_make_data(workdir, smi)
    lap("33")
    public = phase_public_api(workdir, train, last, smi)
    lap("34")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [{"name": name, "route": "cuda", "source": KERNELS[name][0],
              "replaces": KERNELS[name][1], "launches": launches[name],
              **{k: kernel_rows[name][k] for k in keys}}
             for name in KERNELS]
    # backward launches: B1's and B2's on the gram path (phase 7), B3's own on
    # the stochastic path (phase 10)
    table += [{"name": name, "route": "cuda",
               "source": "laplace_inducing_points_tpu_torch/csrc/matmul_tiled.cu",
               "replaces": replaces,
               "launches": (stochastic if name == "matmul_nn_backward" else train)
               ["launches"][name],
               **{k: backward_rows[name][k] for k in keys}}
              for name, replaces in BACKWARD.items()]
    table += [{"name": name, "route": "cuda",
               "source": "laplace_inducing_points_tpu_torch/csrc/ggn_sweep.cu",
               "replaces": "laplace_inducing_points_tpu/ops/pallas/matmul.py:213",
               "launches": stochastic["launches"][name],
               **{k: sweep_rows[name][k] for k in keys}}
              for name in ("ggn_sweep", "ggn_sweep_backward")]
    # one entry per path of B2 and B3, timed at the product it serves (phase 3);
    # launches: the stochastic path's (phase 10), which runs every path
    table += [{"name": name, "route": "cuda",
               "source": ("laplace_inducing_points_tpu_torch/csrc/"
                          + ("matmul_tiled.cu" if path == "tiled" else "matmul.cu")),
               "replaces": KERNELS[kernel][1],
               "launches": stochastic["launches"][name],
               **{k: kernel_rows[name][k] for k in keys}}
              for name, (kernel, path, _) in PATHS.items()]
    # the scale paths (phases 12-16): each kernel of the gram path timed at the
    # path's shapes, launches from that path's run
    for label, rows in scale_rows.items():
        table += [{"name": f"{name}@{label}", "route": "cuda",
                   "source": (KERNELS[name][0] if name in KERNELS else
                              "laplace_inducing_points_tpu_torch/csrc/matmul_tiled.cu"),
                   "replaces": KERNELS[name][1] if name in KERNELS else BACKWARD[name],
                   "launches": scale[label]["launches"][name],
                   **{k: rows[name][k] for k in keys}}
                  for name in SCALE_KERNELS]
    # the matfree slice (phases 18-20), each kernel timed at its shapes there:
    # B4 and its backward (the P = 12 range-finder sweep) with the launches of
    # the matfree1k CLI path (phase 18), B1-B3 with those of the materialized
    # Matheron sampler (phase 20)
    table += [{"name": f"{name}@{label}", "route": "cuda",
               "source": (KERNELS[name][0] if name in KERNELS else
                          "laplace_inducing_points_tpu_torch/csrc/ggn_sweep.cu"),
               "replaces": (KERNELS[name][1] if name in KERNELS else
                            "laplace_inducing_points_tpu/ops/pallas/matmul.py:213"),
               "launches": matfree["launches"][label][name],
               **{k: matfree["rows"][name][k] for k in keys}}
              for label, names in (("matfree1k", MATFREE_KERNELS),
                                   ("matheron1k", MATHERON_KERNELS))
              for name in names]
    # the toy slice (phases 22-26): each kernel timed at the banana and sine
    # shapes, launches from that path's runs (B3's backward and B4 from banana's
    # stochastic run, phase 26)
    for label, launches in toy["launches"].items():
        for name, n in launches.items():
            row = toy["rows"][label][name]
            source, replaces = _toy_source(name, row)
            table.append({"name": f"{name}@{label}", "route": "cuda", "source": source,
                          "replaces": replaces, "launches": n,
                          **{k: row[k] for k in keys}})
    # phases 30 and 31: the gram_chunked step's kernels (launches of one step)
    # and the mesh's (the sharded Gram and the mesh predictor), each timed at
    # its shapes there
    for label, names in (("gram_chunked", CHUNKED_KERNELS), ("mesh", MESH_KERNELS)):
        for name in names:
            table.append({"name": f"{name}@{label}", "route": "cuda",
                          "source": (KERNELS[name][0] if name in KERNELS else
                                     "laplace_inducing_points_tpu_torch/csrc/matmul_tiled.cu"),
                          "replaces": KERNELS[name][1] if name in KERNELS else BACKWARD[name],
                          "launches": last[label]["launches"][name],
                          **{k: last[label]["rows"][name][k] for k in keys}})
    # phase 34: the gram Z steps of train_inducing_points imported from the
    # package's exports, each kernel timed at those steps' shapes
    table += [{"name": f"{name}@public_api", "route": "cuda",
               "source": (KERNELS[name][0] if name in KERNELS else
                          "laplace_inducing_points_tpu_torch/csrc/matmul_tiled.cu"),
               "replaces": KERNELS[name][1] if name in KERNELS else BACKWARD[name],
               "launches": public["launches"][name],
               **{k: public["rows"][name][k] for k in keys}}
              for name in CHUNKED_KERNELS]
    print(f"== smoke total {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--conv-before"]:
        sys.exit(conv_before(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--cpu-reference"]:
        sys.exit(cpu_reference(sys.argv[2]))
    if sys.argv[1:2] == ["--conv-first"]:
        sys.exit(conv_first())
    sys.exit(main())
