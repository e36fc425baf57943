#!/usr/bin/env python3
"""The matfree KL of ``lenet5_mnist_matfree4k.yml`` against the materialized
one on the same probes, at several CG settings (chip_smoke.py phase 21's
check, repeated on its own), on one CUDA GPU.

Run from the root of the repository:

    python3 scripts/torch_matfree4k_check.py

Builds the kernels, trains phase 18's matfree1k MAP (``chip_smoke.py``'s
``phase_matfree_path``), takes phase 21's one matfree Z step at M = 4,096 and
alpha 50, then evaluates the stochastic KL on phase 21's probes: materialized
(Rz 10.1 GB, its Gram through B1) with and without its Cholesky pivot jitter,
and matrix-free at the shipped cg_tol 1e-3 (the seeded sketch and two other
sketch seeds), 1e-4 and 1e-6. Prints each value and its relative distance
from the materialized one without the jitter (the matfree objective's
function).
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    smi = cs.phase_environment()
    cs.phase_build()
    from laplace_inducing_points_tpu_torch.cli import train_scale
    from laplace_inducing_points_tpu_torch.ops import stochtrace as st
    from laplace_inducing_points_tpu_torch.training import inducing as ind
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_array
    from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        mf = cs.phase_matfree_path(workdir, smi)
        cut = cs._cut_config(workdir, cs.MATFREE["matfree4k"], {150: 1}, "matfree4k_cut.yml")
        ip = load_experiment_config(cut)["optimization"]["ip"]
        N = load_experiment_config(cut)["optimization"]["full_set_size"]
        ind_dir = str(workdir / "matfree4k_ind")
        train_scale.main(["train_inducing", "--alpha_ip", str(cs.ALPHA_4K), "--dataset", "mnist",
                          "--config", cut, "--device", "cuda", "--ckpt_map", mf["dirs"]["map"],
                          "--ckpt_induc", ind_dir, "--data_dir", mf["dirs"]["data"]])
        state, X = mf["state"], mf["X"]
        Z = torch.as_tensor(load_array(ind_dir, "ind_mnist", ip["epochs"])).cuda()
        probes = st.rademacher_probes(torch.Generator(device="cuda").manual_seed(cs.SEED + 25),
                                      ip["st_samples"], state.spec.num_params)
        knobs = dict(full_set_size=N, st_samples=ip["st_samples"],
                     slq_samples=ip["slq_samples"], slq_num_matvecs=ip["slq_num_matvecs"])
        with torch.no_grad():
            jittered = float(ind.kl_objective_stochastic(Z, X, state, cs.ALPHA_4K, probes,
                                                         **knobs))
            with cs._no_pivot_jitter():
                ref = float(ind.kl_objective_stochastic(Z, X, state, cs.ALPHA_4K, probes,
                                                        **knobs))
            print(f"materialized KL {ref:.8g} without its Cholesky pivot jitter, "
                  f"{jittered:.8g} with it (rel {abs(jittered - ref) / abs(ref):.3e}; {smi})",
                  flush=True)
            for tol, maxiter, seed in ((1e-3, 100, None), (1e-3, 100, 1), (1e-3, 100, 2),
                                       (1e-4, 200, None), (1e-6, 500, None)):
                sketch = None if seed is None else ind.matfree_sketch(
                    state, Z, ip["precond_rank"], torch.Generator(device="cuda").manual_seed(seed),
                    ip["precond_power"], ip["cg_example_block"])
                value = float(ind.kl_objective_stochastic(
                    Z, X, state, cs.ALPHA_4K, probes, materialize_w=False, cg_tol=tol,
                    cg_maxiter=maxiter, precond_rank=ip["precond_rank"],
                    precond_power=ip["precond_power"], precond_sketch=sketch,
                    cg_example_block=ip["cg_example_block"], **knobs))
                print(f"matfree KL, cg_tol {tol:g}, maxiter {maxiter}, sketch seed "
                      f"{'0x4E59' if seed is None else seed}: {value:.8g}, rel "
                      f"{abs(value - ref) / abs(ref):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
