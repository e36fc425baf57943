#!/usr/bin/env python3
"""Three CPU studies of the PyTorch port against the JAX package (needs JAX).

Run from the root of the repository:

    JAX_PLATFORMS=cpu python scripts/torch_cpu_studies.py golden
    JAX_PLATFORMS=cpu python scripts/torch_cpu_studies.py lenet5_cov
    JAX_PLATFORMS=cpu python scripts/torch_cpu_studies.py cov_sigma

``golden``: the golden banana MAP and Z (``tests/golden``) at the recorded
alpha, ``full_set_size`` 450, range clip 1.0 and S = 200 through the weight
predictor, for 6 noise seeds each: the JAX package (f32), the port (f32, its
CPU Gram a plain ``torch.matmul``) and the port's algebra with the rows, the
Gram and its eigh in float64. Prints the eigenvalues each keeps above the
``rank_tol`` mask and (NLL, AUROC at ring radius 1.05) per seed, and both
packages' dense predictive NLL.

``lenet5_cov``: LeNet5 at full width with seeded weights, Z the first 100 of
seeded inputs, alpha 0.005, N 60,000, 64 test inputs, S = 200: the NLL of the
weight and the cov predictives in both packages, two noise seeds each, and
whether the cov self-check warns.

``cov_sigma``: the golden banana's cov predictive at 5 test points: the
diagonal of ``JJᵀ/α`` (what the assembly cancels against), of Σ assembled in
f32 by the JAX package and by the port, of the port's Σ assembled in float64
from the same f32 statistics, and the variance of 20,000 weight-path draws.
"""

from __future__ import annotations

import os
import sys
import warnings

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

SEEDS = range(6)
GOLDEN = os.path.join(ROOT, "tests", "golden", "banana")


def _kept(lam) -> int:
    lam = np.asarray(lam)
    return int((lam > 1e-7 * max(float(lam.max()), 1.0)).sum())


def golden() -> None:
    from laplace_inducing_points_tpu.data.loader import ArrayDataset as JDS
    from laplace_inducing_points_tpu.data.loader import make_dataloaders as jloaders
    from laplace_inducing_points_tpu.evaluation.harness import auroc_ood as jauroc
    from laplace_inducing_points_tpu.evaluation.harness import eval_dataset_extended as jeval
    from laplace_inducing_points_tpu.inference.lla import ScalableLLAPredictor as JP
    from laplace_inducing_points_tpu.models.registry import get_model
    from laplace_inducing_points_tpu.models.state import create_train_state
    from laplace_inducing_points_tpu.utils.checkpoint import load_train_state
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.data.loader import ArrayDataset, make_dataloaders
    from laplace_inducing_points_tpu_torch.data.toy import (FIXTURE_DIR, load_dataset,
                                                            train_test_val_split)
    from laplace_inducing_points_tpu_torch.evaluation import metrics
    from laplace_inducing_points_tpu_torch.evaluation.harness import (auroc_ood,
                                                                      eval_dataset_extended)
    from laplace_inducing_points_tpu_torch.inference import lla
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_array, load_params
    from torch_twins import state64

    alpha, N, S = 0.0025, 450, 200
    splits = {name: train_test_val_split(*load_dataset(str(FIXTURE_DIR / name)))
              for name in ("banana.npz", "ring_r1p05.npz")}
    tloader = {k: make_dataloaders(*(ArrayDataset(*p) for p in v), 32)[1]
               for k, v in splits.items()}
    jloader = {k: jloaders(*(JDS(*p) for p in v), 32)[1] for k, v in splits.items()}
    Z = load_array(GOLDEN, "ind_banana", 500)

    model = get_model({"name": "classifier", "type": "classifier", "num_h": 16, "num_l": 3,
                       "num_c": 2})
    jstate = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 2)),
                                optax.adam(1e-3), model_kind="classifier")
    jstate = load_train_state(jstate, os.path.join(GOLDEN, "map"))
    jp = JP(jstate, jnp.asarray(Z), full_set_size=N, range_clip_min=1.0)
    rows = []
    for s in SEEDS:
        rec = jeval(jstate, jloader["banana.npz"], Z, alpha=alpha, full_set_size=N,
                    num_mc_samples=S, rng=jax.random.PRNGKey(2 * s), predictor=jp)
        au = jauroc(jstate, rec["probs"], jloader["ring_r1p05.npz"], Z, alpha=alpha,
                    full_set_size=N, num_mc_samples=S, rng=jax.random.PRNGKey(2 * s + 1),
                    predictor=jp)
        rows.append((round(rec["nll"], 4), round(au, 4)))
    print(f"JAX f32: kept {_kept(jp.lam)}; (nll, auroc r=1.05) {rows}", flush=True)
    dense = [round(jeval(jstate, jloader["banana.npz"], Z, alpha=alpha, full_set_size=N,
                         num_mc_samples=S, rng=jax.random.PRNGKey(2 * s),
                         scalable=False)["nll"], 4) for s in SEEDS]
    print(f"JAX f32 dense predictive: nll {dense}", flush=True)

    flat, _, _ = load_params(os.path.join(ROOT, "tests", "golden", "banana_torch"),
                             "map_banana")
    state = ModelState(SimpleClassifier(16, 3, 2, 2), flat, "classifier")
    z = torch.as_tensor(Z)
    with torch.no_grad():
        pred = lla.ScalableLLAPredictor(state, z, full_set_size=N, range_clip_min=1.0)
        rows = []
        for s in SEEDS:
            common = dict(alpha=alpha, full_set_size=N, num_mc_samples=S, predictor=pred)
            rec = eval_dataset_extended(state, tloader["banana.npz"], z,
                                        generator=torch.Generator().manual_seed(2 * s), **common)
            au = auroc_ood(state, rec["probs"], tloader["ring_r1p05.npz"], z,
                           generator=torch.Generator().manual_seed(2 * s + 1), **common)
            rows.append((round(rec["nll"], 4), round(au, 4)))
    print(f"port f32: kept {_kept(pred.lam)}; (nll, auroc r=1.05) {rows}", flush=True)
    with torch.no_grad():
        dense_pred = lla.DenseLLAPredictor(state, z, full_set_size=N)
        dense = [round(eval_dataset_extended(
            state, tloader["banana.npz"], z, alpha=alpha, full_set_size=N, num_mc_samples=S,
            predictor=dense_pred, generator=torch.Generator().manual_seed(2 * s))["nll"], 4)
            for s in SEEDS]
    print(f"port f32 dense predictive: nll {dense}", flush=True)

    # the same algebra in float64: rows, Gram, eigh and the draws' contractions
    s64 = state64(state)
    with torch.no_grad():
        R = ops.dense_wt(s64, z.double())
        lam, V = torch.linalg.eigh(ops.ensure_symmetry(R @ R.T, 0.0))
        g = lla._g_weights(lam, alpha, N / z.shape[0], 1e-7, 1.0)

        def probs(loader, gen):
            out, nll, n = [], 0.0, 0
            for x, y in loader:
                xs = torch.as_tensor(x, dtype=torch.float64)
                eps = torch.randn(S, R.shape[1], generator=gen).double()
                w = eps / alpha ** 0.5 + (((eps @ R.T) @ V) * g) @ V.T @ R
                lin = ops.linearize_model(s64, xs)
                logits = lin.f0[None] + torch.func.vmap(lin.jvp)(w)
                b_nll, _, mp = metrics.mc_predictive_nll_acc(logits.float(), torch.as_tensor(y))
                out.append(mp.numpy())
                nll += float(b_nll) * len(y)
                n += len(y)
            return np.concatenate(out), nll / n

        rows = []
        for s in SEEDS:
            p_id, nll = probs(tloader["banana.npz"], torch.Generator().manual_seed(2 * s))
            p_ood, _ = probs(tloader["ring_r1p05.npz"], torch.Generator().manual_seed(2 * s + 1))
            rows.append((round(nll, 4), round(metrics.auroc_ood(p_id, p_ood), 4)))
    print(f"port float64: kept {_kept(lam)}; (nll, auroc r=1.05) {rows}", flush=True)


def lenet5_cov() -> None:
    from laplace_inducing_points_tpu.evaluation import metrics as jm
    from laplace_inducing_points_tpu.inference.lla import ScalableLLAPredictor as JP
    from laplace_inducing_points_tpu_torch.evaluation import metrics as tm
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor as TP
    from torch_twins import inputs, make_twins

    jstate, pstate, _ = make_twins("lenet5")
    Z, x = inputs("lenet5", 100, seed=3), inputs("lenet5", 64, seed=4)
    y = np.random.default_rng(5).integers(0, 10, 64).astype(np.int32)
    alpha, N, S = 0.005, 60000, 200
    for method in ("weight", "cov"):
        jp = JP(jstate, jnp.asarray(Z), full_set_size=N, range_clip_min=1.0, method=method)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            nll = [float(jm.mc_predictive_nll_acc(
                jp.logit_samples(jnp.asarray(x), alpha, jax.random.PRNGKey(k), S),
                jnp.asarray(y))[0]) for k in range(2)]
        print(f"JAX {method}: NLL {nll}; warned {bool(caught)}", flush=True)
        with torch.no_grad():
            tp = TP(pstate, torch.from_numpy(Z), full_set_size=N, range_clip_min=1.0,
                    method=method)
            nll = [float(tm.mc_predictive_nll_acc(
                tp.logit_samples(torch.from_numpy(x), alpha, torch.Generator().manual_seed(k), S),
                torch.from_numpy(y))[0]) for k in range(2)]
        print(f"port {method}: NLL {nll}; self-check share {getattr(tp, 'cov_check_frac', None)}",
              flush=True)


def cov_sigma() -> None:
    from laplace_inducing_points_tpu.core import operators as jops
    from laplace_inducing_points_tpu.inference.lla import ScalableLLAPredictor as JP
    from laplace_inducing_points_tpu.inference.lla import _amortized_logit_samples
    from laplace_inducing_points_tpu.inference.sample import _g_weights
    from laplace_inducing_points_tpu.models.registry import get_model
    from laplace_inducing_points_tpu.models.state import create_train_state
    from laplace_inducing_points_tpu.utils.checkpoint import load_train_state
    from laplace_inducing_points_tpu_torch.data.toy import (FIXTURE_DIR, load_dataset,
                                                            train_test_val_split)
    from laplace_inducing_points_tpu_torch.inference import lla
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_array, load_params

    alpha, N = 0.0025, 450
    x = np.asarray(train_test_val_split(*load_dataset(str(FIXTURE_DIR / "banana.npz")))[1][0][:5])
    Z = load_array(GOLDEN, "ind_banana", 500)
    model = get_model({"name": "classifier", "type": "classifier", "num_h": 16, "num_l": 3,
                       "num_c": 2})
    jstate = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 2)),
                                optax.adam(1e-3), model_kind="classifier")
    jstate = load_train_state(jstate, os.path.join(GOLDEN, "map"))
    jp = JP(jstate, jnp.asarray(Z), full_set_size=N, range_clip_min=1.0, method="cov")
    _, JJt, A = jp.batch_stats(jnp.asarray(x))
    g = _g_weights(jp.lam, alpha, jp.beta, 1e-7, 1.0)
    H = jops.pdot(jp.V * g, jp.V.T)
    Hp = (2 / jnp.sqrt(alpha)) * H + jops.pdot(jops.pdot(H, jp.gram), H)
    sigma = JJt / alpha + jnp.einsum("bkd,de,ble->bkl", A, Hp, A,
                                     precision=jax.lax.Precision.HIGHEST)
    draws = _amortized_logit_samples(jstate, jp.R, jp.lam, jp.V, alpha, jp.beta,
                                      jnp.asarray(x), jax.random.PRNGKey(0), 20000, 1e-7, 1.0)
    diag = lambda m: np.round(np.diagonal(np.asarray(m), axis1=1, axis2=2)[:, 0], 1)
    print(f"JJt/alpha {diag(JJt / alpha)}", flush=True)
    print(f"JAX f32 sigma {diag(sigma)}; weight-path variance "
          f"{np.round(np.asarray(jnp.var(draws, 0))[:, 0], 1)}", flush=True)
    flat, _, _ = load_params(os.path.join(ROOT, "tests", "golden", "banana_torch"),
                             "map_banana")
    state = ModelState(SimpleClassifier(16, 3, 2, 2), flat, "classifier")
    with torch.no_grad():
        tp = lla.ScalableLLAPredictor(state, torch.as_tensor(Z), full_set_size=N,
                                      range_clip_min=1.0, method="cov")
        _, tJJt, tA = tp.batch_stats(torch.from_numpy(x))
        s32 = lla.cov_predictive_sigma(tJJt, tA, tp.gram, tp.lam, tp.V, alpha, tp.beta, 1e-7, 1.0)
        g64 = tp.gram.double()
        s64 = lla.cov_predictive_sigma(tJJt.double(), tA.double(), g64,
                                       *torch.linalg.eigh(g64), alpha, tp.beta, 1e-7, 1.0)
    print(f"port f32 sigma {diag(s32.numpy())}; port float64 assembly {diag(s64.numpy())}",
          flush=True)


if __name__ == "__main__":
    {"golden": golden, "lenet5_cov": lenet5_cov, "cov_sigma": cov_sigma}[sys.argv[1]]()
