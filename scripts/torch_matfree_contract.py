#!/usr/bin/env python3
"""How far the matfree objective's dL/dZ is from the materialized one at
``lenet5_mnist_matfree1k.yml`` (M = 1,024, d_z = 10,240), and why, on one
CUDA GPU.

Run from the root of the repository:

    python3 scripts/torch_matfree_contract.py [--studies determinism,seeds,alpha]

It first runs ``chip_smoke.py``'s phases 1, 2 and 18 (the kernels' build and
the matfree1k pipeline: 12 MAP epochs, the alpha grid, 3 Z steps), then on
that MAP and Z:

- ``determinism``: B1-B4 and their backward passes at the path's shapes,
  called repeatedly on the same inputs: the largest difference between calls;
- ``seeds``: six probe draws at the trained alpha; per draw the materialized
  trace and log-det terms' dL/dZ (twice: their run-to-run difference), the
  matfree log-det dL/dZ, and the matfree trace dL/dZ at cg_tol 1e-3 (twice),
  1e-4 and 1e-6 with the shipped rank-64 sketch, each against the
  materialized one;
- ``alpha``: alpha at the trained value and at 268.27, 71.9686 and 19.307
  (grid points), two probe draws each: the materialized dL/dZ with and
  without its Cholesky pivot jitter, and the matfree one at cg_tol 1e-3 and
  1e-6 against both.

Prints the card (``nvidia-smi`` name and power limit) with phase 1.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from laplace_inducing_points_tpu_torch.core import operators as ops  # noqa: E402
from laplace_inducing_points_tpu_torch.ops import slq as slq_mod  # noqa: E402
from laplace_inducing_points_tpu_torch.ops import stochtrace as st  # noqa: E402
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt  # noqa: E402
from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep  # noqa: E402
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk  # noqa: E402
from laplace_inducing_points_tpu_torch.training import inducing as ind  # noqa: E402


def _same(fn, n):
    """(largest difference of n - 1 calls from the first, largest |value|)."""
    ref = fn()
    worst = 0.0
    for _ in range(n - 1):
        worst = max(worst, float((fn() - ref).abs().max()))
    return worst, float(ref.abs().max())


def _grad_of(fn, x, y):
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        (gx,) = torch.autograd.grad(torch.sum(fn(x) * y), x)
    return gx


def determinism(mf):
    state, Z, X = mf["state"], mf["Z"], mf["X"]
    with torch.no_grad():
        Rz = ops.dense_wt(state, Z)
        Rx = ops.dense_wt(state, X)
    g = torch.Generator(device="cuda").manual_seed(5)
    V = torch.randn(12, Rz.shape[1], generator=g, device="cuda")
    S = torch.randn(12, Rz.shape[0], generator=g, device="cuda")
    W4 = torch.randn(4, Rz.shape[1], generator=g, device="cuda")
    with torch.no_grad():
        print("determinism syrk", _same(lambda: syrk(Rz), 6), flush=True)
        print("determinism matmul_nt", _same(lambda: matmul_nt(V, Rz), 30), flush=True)
        print("determinism matmul_nn", _same(lambda: matmul_nn(S, Rz), 30), flush=True)
        print("determinism ggn_sweep P=12", _same(lambda: ggn_sweep(V, Rx, mf["gamma"]), 50),
              flush=True)
        print("determinism ggn_sweep P=4", _same(lambda: ggn_sweep(W4, Rx, mf["gamma"]), 50),
              flush=True)
    Y12 = torch.randn(12, Rz.shape[1], generator=g, device="cuda")
    print("determinism ggn_sweep_backward", _same(lambda: _grad_of(
        lambda w: ggn_sweep(w, Rx, mf["gamma"]), V, Y12), 30), flush=True)
    Ynt = torch.randn(12, Rz.shape[0], generator=g, device="cuda")
    print("determinism matmul_nt_backward (dRz)",
          _same(lambda: _grad_of(lambda r: matmul_nt(V, r), Rz, Ynt), 5), flush=True)
    print("determinism matmul_nn_backward (dRz)",
          _same(lambda: _grad_of(lambda r: matmul_nn(S, r), Rz, Y12), 5), flush=True)
    C = torch.randn(Rz.shape[0], Rz.shape[0], generator=g, device="cuda")
    print("determinism syrk_backward", _same(lambda: _grad_of(syrk, Rz, C), 4), flush=True)
    del Rz, Rx, C
    torch.cuda.empty_cache()


def parts_materialized(mf, probes):
    """[(trace value, its dL/dZ), (log-det value, its dL/dZ)] of the
    materialized stochastic objective on ``probes``."""
    state, Z, X, ip = mf["state"], mf["Z"], mf["X"], mf["ip"]
    alpha, beta, gamma = mf["alpha"], mf["beta"], mf["gamma"]
    with torch.no_grad():
        Rz = ops.dense_wt(state, Z)
        Rx = ops.dense_wt(state, X)

    def trace(rz, rx):
        L = ind._c_cholesky(syrk(rz), alpha, beta)
        s1, s2 = ind.probe_split(probes.shape[0])
        return st.hutchpp(ind.stochastic_composite(rz, rx, L, alpha, gamma), probes,
                          s1=s1, s2=s2)

    def logdet(rz, rx):
        a, b = ind.stacked_operator(rz, alpha, beta)
        return slq_mod.slq_logdet_product(a, probes[:ip["slq_samples"]],
                                          num_matvecs=ip["slq_num_matvecs"], t_matvec=b)
    out = []
    for f in (trace, logdet):
        v, ct = ind._rows_value_and_grad(f, Rz, Rx)
        out.append((float(v), ops.dense_wt_pullback(state, Z, ct)))
    return out


def trace_matfree(mf, probes, sketch, tol, maxiter):
    state, Z, X, ip = mf["state"], mf["Z"], mf["X"], mf["ip"]
    z = Z.detach().requires_grad_()
    with cs._cg_solves() as solves:
        tr = ind.matfree_trace_term(z, X, state, mf["alpha"], mf["beta"], mf["gamma"], probes,
                                    cg_tol=tol, cg_maxiter=maxiter, sketch=sketch,
                                    cg_example_block=ip["cg_example_block"])
        (gt,) = torch.autograd.grad(tr, z)
    return float(tr), gt, solves


def logdet_matfree(mf, probes):
    ip = mf["ip"]
    z = mf["Z"].detach().requires_grad_()
    ld = ind.matfree_logdet_term(z, mf["state"], mf["alpha"], mf["beta"],
                                 probes[:ip["slq_samples"]], ip["slq_num_matvecs"])
    (g,) = torch.autograd.grad(ld, z)
    return float(ld), g


def _solves(solves):
    return [(p, k, f"{r:.1e}") for p, k, r in solves]


def seeds(mf):
    ip, state, Z = mf["ip"], mf["state"], mf["Z"]
    D = state.spec.num_params
    print("alpha", mf["alpha"], "beta", mf["beta"], "gamma", mf["gamma"], "ip", ip, flush=True)
    for seed in range(6):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 20 + 1000 * seed)
        probes = st.rademacher_probes(gen, ip["st_samples"], D)
        (tm, gtm), (lm, glm) = parts_materialized(mf, probes)
        (_, gtm2), (_, glm2) = parts_materialized(mf, probes)
        g_mat = gtm + glm
        lf, glf = logdet_matfree(mf, probes)
        sk = ind.matfree_sketch(state, Z, ip["precond_rank"], gen, ip["precond_power"],
                                ip["cg_example_block"])
        print(f"seed {seed}: materialized trace {tm:.8g} logdet {lm:.8g}; repeated: trace dL/dZ "
              f"rel {cs._rel(gtm2, gtm):.2e}, logdet dL/dZ rel {cs._rel(glm2, glm):.2e}; "
              f"|trace dL/dZ| {float(gtm.norm()):.4g} |logdet dL/dZ| {float(glm.norm()):.4g} "
              f"|dL/dZ| {float(g_mat.norm()):.4g}; sketch lam top {float(sk[1][0]):.4g} bottom "
              f"{float(sk[1][-1]):.4g} good {int(sk[2].sum())}", flush=True)
        print(f"  matfree logdet {lf:.8g}: dL/dZ rel {cs._rel(glf, glm):.3e} cos "
              f"{cs._cos(glf, glm):.6f}", flush=True)
        for tol, maxiter in ((1e-3, 100), (1e-3, 100), (1e-4, 100), (1e-6, 500)):
            tf, gtf, solves = trace_matfree(mf, probes, sk, tol, maxiter)
            g = gtf + glf
            print(f"  tol {tol} maxiter {maxiter}: trace {tf:.8g}; trace dL/dZ rel "
                  f"{cs._rel(gtf, gtm):.3e} cos {cs._cos(gtf, gtm):.6f}; total rel "
                  f"{cs._rel(g, g_mat):.3e} cos {cs._cos(g, g_mat):.6f}; solves "
                  f"{_solves(solves)}", flush=True)


def alphas(mf):
    ip, state, Z = mf["ip"], mf["state"], mf["Z"]
    D = state.spec.num_params
    base_alpha = mf["alpha"]
    with torch.no_grad():
        Gzz = syrk(ops.dense_wt(state, Z))
    for alpha in (base_alpha, 268.27, 71.9686, 19.307):
        mf["alpha"] = alpha
        rho = alpha / mf["beta"]
        C = Gzz + rho * torch.eye(Gzz.shape[0], device="cuda")
        print(f"alpha {alpha}: rho {rho:.4g}, pivot jitter {float(ind._pivot_jitter(C)):.4g}",
              flush=True)
        del C
        for seed in range(2):
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 20 + 1000 * seed)
            probes = st.rademacher_probes(gen, ip["st_samples"], D)
            (_, gtm), (_, glm) = parts_materialized(mf, probes)
            with cs._no_pivot_jitter():
                (_, gtn), (_, gln) = parts_materialized(mf, probes)
            _, glf = logdet_matfree(mf, probes)
            sk = ind.matfree_sketch(state, Z, ip["precond_rank"], gen, ip["precond_power"],
                                    ip["cg_example_block"])
            print(f"  seed {seed}: trace dL/dZ with vs without the jitter rel "
                  f"{cs._rel(gtm, gtn):.3e}; logdet dL/dZ {cs._rel(glm, gln):.3e}; matfree "
                  f"logdet dL/dZ vs without {cs._rel(glf, gln):.3e}", flush=True)
            for tol, maxiter in ((1e-3, 100), (1e-6, 500)):
                _, gtf, solves = trace_matfree(mf, probes, sk, tol, maxiter)
                g = gtf + glf
                print(f"    tol {tol} maxiter {maxiter}: total vs with the jitter rel "
                      f"{cs._rel(g, gtm + glm):.3e} cos {cs._cos(g, gtm + glm):.6f}; vs without "
                      f"rel {cs._rel(g, gtn + gln):.3e} cos {cs._cos(g, gtn + gln):.6f}; solves "
                      f"{_solves(solves)}", flush=True)
    mf["alpha"] = base_alpha


STUDIES = {"determinism": determinism, "seeds": seeds, "alpha": alphas}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--studies", default="determinism,seeds,alpha",
                        help="comma-separated among " + ", ".join(STUDIES))
    studies = [STUDIES[name] for name in parser.parse_args().studies.split(",")]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = cs.phase_environment()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        mf = cs.phase_matfree_path(Path(tmp), smi)
        for study in studies:
            study(mf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
