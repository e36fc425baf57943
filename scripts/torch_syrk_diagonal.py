#!/usr/bin/env python3
"""B1 (the SYRK Gram) on one CUDA GPU: its time and the coherent error of its
diagonal against float64, at the toy, LeNet5, MLP and ResNet1M shapes.

Run from the root of the repository:

    python3 scripts/torch_syrk_diagonal.py [--root CHECKOUT] [--reps N]

``--root`` names the checkout whose ``laplace_inducing_points_tpu_torch`` is
measured (default: this one), so that two commits are compared in one
machine session: unpack the other commit with ``git archive`` into a
directory that ``.gitignore`` lists and alternate the roots. For each
``(d, D)``: CUDA-event ms of one call (median of ``--reps`` after a warm-up),
the bias (the coherent part of the error, as chip_smoke.py's ``_bias``) of the
diagonal and of the whole Gram against a float64 product, the relative
Frobenius error, and exact symmetry; normal operands from a seed. Prints the
card (``nvidia-smi`` name and power limit) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SEED = 20261017
SHAPES = ((80, 626), (40, 321), (100, 4946), (1000, 61706), (1000, 235146), (500, 1084586))


def _bias(x: torch.Tensor, ref: torch.Tensor) -> float:
    e, r = (x.double() - ref).ravel(), ref.ravel()
    return float(torch.dot(e, r) / torch.dot(r, r))


def _ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--reps", type=int, default=7)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
    from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy
    set_f32_policy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for d, D in SHAPES:
        A = torch.randn(d, D, generator=gen, device="cuda")
        C = syrk(A)
        ref = torch.mm(A.double(), A.double().T)
        diag = torch.diagonal(C)
        rows.append({"d": d, "D": D, "ms": _ms(lambda: syrk(A), args.reps),
                     "diag_bias": _bias(diag, torch.diagonal(ref)), "bias": _bias(C, ref),
                     "rel_vs_f64": float(torch.linalg.norm(C.double() - ref)
                                         / torch.linalg.norm(ref)),
                     "symmetric": bool(torch.equal(C, C.T))})
        print(f"syrk {(d, D)}: {rows[-1]['ms']:.4f} ms, diagonal bias "
              f"{rows[-1]['diag_bias']:+.2e}, bias {rows[-1]['bias']:+.2e}, rel vs f64 "
              f"{rows[-1]['rel_vs_f64']:.2e}, symmetric {rows[-1]['symmetric']}", flush=True)
        del A, C, ref
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"root": str(Path(args.root).resolve()), "card": smi, "syrk": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
