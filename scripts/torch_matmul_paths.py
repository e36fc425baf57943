#!/usr/bin/env python3
"""The times behind the path thresholds of the port's FP32 NT and NN
products, on one CUDA GPU. (``chip_smoke.py`` phase 3 checks every path.)

Run from the root of the repository:  python3 scripts/torch_matmul_paths.py

1. Prints the card (``nvidia-smi`` name and power limit), builds the kernels
   and prints the ptxas report and the planner's geometry.
2. The host's cost of one call (enqueue only, no synchronisation), at a
   shape too small for the device to lag: the wrapper ``matmul_nt`` without
   and with a gradient to record (the latter through its autograd Function),
   the plain-tensor entry ``nt``, ``launch_nt`` with a given plan, and
   ``torch.mm``.
3. Times each path against the other paths that could serve the same shape,
   and one cuBLAS call (``torch.mm``), at the LeNet5 widths (d = 1000,
   D = 61,706): NT at m = 1 ... 32 rows, NN at m = 1 ... 32 rows (z = 1000),
   NN at z = 1 ... 64 (m = 1000). CUDA-event time of a run of launches
   (``chip_smoke.cuda_ms``, runs of at least 20 ms).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import cuda_ms, nvidia_smi_line  # noqa: E402

SEED = 20261016


def host_cost() -> None:
    from laplace_inducing_points_tpu_torch.ops.cuda import matmul as mm
    A, B = torch.randn(1, 64, device="cuda"), torch.randn(1000, 64, device="cuda")
    Ag = A.clone().requires_grad_()
    plan = mm.nt_plan(1, 1000, 64, mm.geometry(A.device))
    calls = {"matmul_nt": lambda: mm.matmul_nt(A, B),
             "matmul_nt, graph": lambda: mm.matmul_nt(Ag, B), "nt": lambda: mm.nt(A, B),
             "launch_nt": lambda: mm.launch_nt(A, B, plan), "torch.mm": lambda: torch.mm(A, B.T)}
    print("host cost of one call, (1, 64) x (1000, 64)^T, us (median of 5 runs of 2000):")
    for name, fn in calls.items():
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            runs.append((time.perf_counter() - t0) / 2000 * 1e6)
            torch.cuda.synchronize()
        print(f"  {name:16s} {sorted(runs)[2]:.2f}", flush=True)


def sweep() -> None:
    from laplace_inducing_points_tpu_torch.ops.cuda import matmul as mm
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    d, D = 1000, 61706
    geo = mm.geometry(torch.device("cuda", torch.cuda.current_device()))
    Rz = torch.randn(d, D, generator=gen, device="cuda")

    def row(label, options, library):
        times = {name: cuda_ms(fn, min_ms=20.0) for name, fn in options.items()}
        times["cuBLAS"] = cuda_ms(library, min_ms=20.0)
        print(f"  {label:28s} " + "  ".join(f"{k}={v:.4f}" for k, v in times.items()),
              flush=True)

    print("NT (m, 61706) x (1000, 61706)^T, ms per call:")
    for m in (1, 2, 4, 8, 16, 32):
        A = torch.randn(m, D, generator=gen, device="cuda")
        tiled = mm._tiled_plan(m, d, D, geo, geo.nt_blocks)
        options = {f"tiled{tuple(tiled)[1:]}": lambda: mm.launch_nt(A, Rz, tiled)}
        if m <= geo.row_max:
            options["row"] = lambda: mm.launch_nt(A, Rz, mm.Plan("row", 0, 1))
        row(f"m={m} (plan {mm.nt_plan(m, d, D, geo).path})", options,
            lambda: torch.mm(A, Rz.T))
    print("NN (m, 1000) x (1000, 61706), ms per call:")
    for m in (1, 2, 4, 8, 16, 32):
        A = torch.randn(m, d, generator=gen, device="cuda")
        tiled = mm._tiled_plan(m, D, d, geo, geo.nn_blocks)
        options = {f"tiled{tuple(tiled)[1:]}": lambda: mm.launch_nn(A, Rz, tiled)}
        if m <= geo.row_max:
            plan = mm.nn_plan(m, d, D, geo)
            options[f"row(splits={plan.splits})"] = lambda: mm.launch_nn(A, Rz, plan)
            options["row(splits=1)"] = lambda: mm.launch_nn(A, Rz, mm.Plan("row", 0, 1))
        row(f"m={m} (plan {mm.nn_plan(m, d, D, geo).path})", options,
            lambda: torch.mm(A, Rz))
    print("NN (1000, z) x (z, 61706), ms per call:")
    for z in (1, 2, 4, 8, 16, 32, 64):
        A = torch.randn(d, z, generator=gen, device="cuda")
        B = torch.randn(z, D, generator=gen, device="cuda")
        tiled = mm._tiled_plan(d, D, z, geo, geo.nn_blocks)
        options = {f"tiled{tuple(tiled)[1:]}": lambda: mm.launch_nn(A, B, tiled)}
        if z <= geo.rank_max:
            options["rank"] = lambda: mm.launch_nn(A, B, mm.Plan("rank", 0, 1))
        row(f"z={z} (plan {mm.nn_plan(d, z, D, geo).path})", options,
            lambda: torch.mm(A, B))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script measures the GPU")
    from laplace_inducing_points_tpu_torch.ops.cuda import _build
    from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy
    print(f"nvidia-smi: {nvidia_smi_line()}  torch {torch.__version__}")
    print(set_f32_policy())
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build {time.perf_counter() - t0:.2f} s")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    from laplace_inducing_points_tpu_torch.ops.cuda import matmul as mm
    print(f"geometry: {mm.geometry(torch.device('cuda', torch.cuda.current_device()))}")
    host_cost()
    sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
