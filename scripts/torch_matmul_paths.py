#!/usr/bin/env python3
"""The times behind the path thresholds of the port's FP32 NT and NN
products, the Gram's tile shape and the sweep's probe groups and splits, on
one CUDA GPU. (``chip_smoke.py`` phases 3 and 9 check every path.)

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
4. The Gram (B1) at (1000, 61706): each tile height the kernel has at a range
   of splits (``launch_syrk`` with an explicit plan), beside its planner's plan
   and ``torch.mm(A, A.T)``.
5. The GGN probe sweep (B4) at V (240 | 16, 61706), R (1280, 61706): stage-1
   splits and probe groups (``launch_sweep`` with an explicit plan), beside its
   planner's plan and two cuBLAS TF32 products.
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


def gram() -> None:
    from laplace_inducing_points_tpu_torch.ops.cuda import matmul as mm
    from laplace_inducing_points_tpu_torch.ops.cuda import syrk as sy
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    d, D = 1000, 61706
    geo = mm.geometry(torch.device("cuda", torch.cuda.current_device()))
    A = torch.randn(d, D, generator=gen, device="cuda")
    print(f"Gram (1000, 61706), ms per call (planner: {tuple(sy.syrk_plan(d, D, geo))}):")
    for rows in geo.tile_rows:
        times = {splits: cuda_ms(lambda: sy.launch_syrk(A, mm.Plan("tiled", rows, splits)),
                                 min_ms=20.0) for splits in (1, 2, 3, 4, 5, 6, 8)}
        print(f"  {rows} x {geo.tile_cols} tiles ({sy.lower_tiles(d, rows, geo.tile_cols)}): "
              + "  ".join(f"splits={k}: {v:.4f}" for k, v in times.items()), flush=True)
    print(f"  torch.mm(A, A.T): {cuda_ms(lambda: torch.mm(A, A.T), min_ms=20.0):.4f}")


def probe_sweep() -> None:
    from laplace_inducing_points_tpu_torch.ops.cuda import sweep as sw
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    d, D, scale = 1280, 61706, 468.75
    geo = sw.sweep_geometry(torch.device("cuda", torch.cuda.current_device()))
    R = torch.randn(d, D, generator=gen, device="cuda")

    def library(V):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return scale * torch.mm(torch.mm(V, R.T), R)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    for P in (240, 16):
        V = torch.randn(P, D, generator=gen, device="cuda")
        print(f"sweep V ({P}, 61706), R (1280, 61706), ms per call (planner: "
              f"{tuple(sw.sweep_plan(P, d, D, geo))}):")
        for group in geo.groups:
            if group < P:
                continue
            times = {splits: cuda_ms(lambda: sw.launch_sweep(V, R, scale,
                                                             sw.SweepPlan(group, splits)),
                                     min_ms=20.0) for splits in (6, 8, 10, 12, 16, 24)}
            print(f"  group {group}: " + "  ".join(f"splits={k}: {v:.4f}"
                                                  for k, v in times.items()), flush=True)
        print(f"  cuBLAS TF32: {cuda_ms(lambda: library(V), min_ms=20.0):.4f}")


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
    gram()
    probe_sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
