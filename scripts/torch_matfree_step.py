#!/usr/bin/env python3
"""The parts of a warm matfree Z step and of one matfree serving batch at
``lenet5_mnist_matfree1k.yml``'s shapes (M = 1,024, d_z = 10,240, a Z batch of
128, 16 probes, SLQ 2 x 64, CG on blocks of 128 with a rank-64 sketch; S = 32
draws for a batch of 256), on one CUDA GPU.

Run from the root of the repository:

    python3 scripts/torch_matfree_step.py [--root CHECKOUT] [--reps N]

``--root`` names the checkout whose ``laplace_inducing_points_tpu_torch`` is
timed (default: this one), so that two commits are compared by one script in
one machine session: unpack the other commit with ``git archive`` into a
directory that ``.gitignore`` lists and alternate the two roots.

LeNet5 weights are lecun-normal from a seed, Z and X are the first 1,024 and
the next 128 surrogate training images, alpha is 1,000 (the grid's choice on
the trained MAP). Each part is timed on the host clock with the device
synchronised, median of ``--reps`` after one warm-up: the Nystrom sketch, the
Hutch++ trace term with its CG solves, the SLQ log-det, the backward, and one
serving batch through ``ScalableLLAPredictor(method="matfree")``. Prints the
card (``nvidia-smi`` name and power limit) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SEED = 20261016
ALPHA = 1000.0


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                               params_from_jax)
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
    from laplace_inducing_points_tpu_torch.models.scale import LeNet5
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.ops import stochtrace as st
    from laplace_inducing_points_tpu_torch.training import inducing as ind
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    set_f32_policy()
    cfg = load_experiment_config(str(root / "configs/scale/lenet5_mnist_matfree1k.yml"))
    opt, ip, sampling = cfg["optimization"], cfg["optimization"]["ip"], cfg["sampling"]
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(LeNet5()),
                                                  cfg["model"]["seed"]))
    state = ModelState(LeNet5().cuda(), flat.cuda(), "classifier")
    with tempfile.TemporaryDirectory() as tmp:
        x_train, _ = load_arrays("mnist", train=True, root=tmp)
    M, N = ip["m"], opt["full_set_size"]
    Z = torch.as_tensor(x_train[:M]).cuda()
    X = torch.as_tensor(x_train[M:M + ip["batch_size"]]).cuda()
    x = torch.as_tensor(x_train[:opt["map"]["batch_size"]]).cuda()
    beta, gamma = N / M, N / X.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    parts = {key: [] for key in ("sketch", "trace", "slq", "backward", "serving")}
    for _ in range(args.reps + 1):
        torch.cuda.reset_peak_memory_stats()
        sketch, sk_s = _timed(lambda: ind.matfree_sketch(
            state, Z, ip["precond_rank"], gen, ip["precond_power"], ip["cg_example_block"]))
        probes = st.rademacher_probes(gen, ip["st_samples"], state.spec.num_params)
        z = Z.detach().requires_grad_()
        trace, tr_s = _timed(lambda: ind.matfree_trace_term(
            z, X, state, ALPHA, beta, gamma, probes, cg_tol=ip["cg_tol"],
            cg_maxiter=ip["cg_maxiter"], sketch=sketch,
            cg_example_block=ip["cg_example_block"]))
        logdet, slq_s = _timed(lambda: ind.matfree_logdet_term(
            z, state, ALPHA, beta, probes[:ip["slq_samples"]], ip["slq_num_matvecs"]))
        _, bwd_s = _timed(lambda: torch.autograd.grad(trace + logdet, z))
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch.no_grad():
            pred = ScalableLLAPredictor(state, Z, full_set_size=N, method="matfree",
                                        **{k: sampling[k] for k in (
                                            "cg_tol", "cg_maxiter", "precond_rank",
                                            "precond_power", "cg_example_block")})
            _, serve_s = _timed(lambda: pred.logit_samples(x, ALPHA, gen, ip["mc_samples"]))
        for key, val in zip(parts, (sk_s, tr_s, slq_s, bwd_s, serve_s)):
            parts[key].append(val)
        del trace, logdet, z
    print(json.dumps({"root": str(root), "device": smi, "reps": args.reps,
                      "peak_gib": peak,
                      **{f"{k}_s": statistics.median(v[1:]) for k, v in parts.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
