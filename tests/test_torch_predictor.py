"""Twin tests of the port's posterior sampler, LLA predictive and metrics.

Both packages get the same weights, points and noise ε (numpy). The
eigendecompositions may place a null eigenvalue on either side of the rank
mask and rotate eigenvectors within a degenerate eigenspace, so the twins
compare the core ``V diag(g) Vᵀ`` and the logit samples, never ``V`` or
``λ``: rtol 1e-3 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.evaluation import metrics as jmet
from laplace_inducing_points_tpu.inference.sample import (apply_inv_matsqrt_rows,
                                                          inv_matsqrt_gram)
from laplace_inducing_points_tpu_torch.data.loader import ArrayDataset, DataLoader
from laplace_inducing_points_tpu_torch.evaluation import metrics as tmet
from laplace_inducing_points_tpu_torch.evaluation.harness import (auroc_ood, eval_dataset,
                                                                  eval_dataset_extended)
from laplace_inducing_points_tpu_torch.inference import sample as tsample
from laplace_inducing_points_tpu_torch.inference.lla import (
    ScalableLLAPredictor, amortized_logit_samples, amortized_logit_samples_from_noise,
    predict_lla_scalable)

from torch_twins import inputs, make_twins

ALPHA = 0.5
N_FULL = 40


@pytest.mark.parametrize("kind,range_clip_min", [("classifier", None),
                                                 ("regressor", None),
                                                 ("regressor", 1.0)])
def test_weight_predictive_matches_jax(kind, range_clip_min):
    """Same ε through JAX's inv_matsqrt_gram + apply_inv_matsqrt_rows +
    linearized jvp and through the port's predictor core.

    The classifier's Gram has an exact null space (softmax-CE kills the
    all-ones direction of every example) whose f32 eigenvalues sit at the
    rank mask, 1e-7·λ_max: either package may keep one of them. The core is
    therefore compared on the range space (λ > 1e-4·λ_max, far from the
    mask). With ``range_clip_min=1.0`` a kept null eigenvalue gets
    g ≈ (1 − α^{-1/2})/λ ~ 1e5, so that case is compared on the regressor,
    whose Gram has no null space.
    """
    jstate, pstate, _ = make_twins(kind)
    Z, X = inputs(kind, 6, seed=7), inputs(kind, 5, seed=8)
    M = Z.shape[0]
    beta = N_FULL / M
    eps = np.random.default_rng(9).standard_normal(
        (11, pstate.spec.num_params)).astype(np.float32)

    R = jops.dense_wt(jstate, jnp.asarray(Z))
    core = np.asarray(inv_matsqrt_gram(jops.pdot(R, R.T), ALPHA, beta,
                                       range_clip_min=range_clip_min))
    w = apply_inv_matsqrt_rows(jnp.asarray(eps), R, jnp.asarray(core), ALPHA)
    lin = jops.linearize_model(jstate, jnp.asarray(X))
    ref = np.asarray(lin.f0[None] + jax.vmap(lin.jvp)(w))

    with torch.no_grad():
        pred = ScalableLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N_FULL,
                                    range_clip_min=range_clip_min)
        g = tsample._g_weights(pred.lam, ALPHA, pred.beta, 1e-7, range_clip_min)
        got_core = ((pred.V * g) @ pred.V.T).numpy()
        got = amortized_logit_samples_from_noise(
            pstate, pred.R, pred.lam, pred.V, ALPHA, pred.beta, torch.from_numpy(X),
            torch.from_numpy(eps), range_clip_min=range_clip_min).numpy()
        keep = pred.lam > 1e-4 * pred.lam.max()
        P = (pred.V[:, keep] @ pred.V[:, keep].T).numpy()
    if kind == "regressor":
        assert P.shape[0] == int(keep.sum())       # full rank: nothing projected away
    np.testing.assert_allclose(P @ got_core @ P, P @ core @ P, rtol=1e-3, atol=1e-4)
    assert got.shape == ref.shape == (11, 5, 3 if kind == "classifier" else 1)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_apply_inv_matsqrt_rows_matches_jax():
    _, pstate, _ = make_twins("classifier")
    rng = np.random.default_rng(10)
    R = rng.standard_normal((12, pstate.spec.num_params)).astype(np.float32)
    core = rng.standard_normal((12, 12)).astype(np.float32) * 1e-3
    eps = rng.standard_normal((4, pstate.spec.num_params)).astype(np.float32)
    ref = apply_inv_matsqrt_rows(jnp.asarray(eps), jnp.asarray(R), jnp.asarray(core), ALPHA)
    got = tsample.apply_inv_matsqrt_rows(torch.from_numpy(eps), torch.from_numpy(R),
                                         torch.from_numpy(core), ALPHA)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_gram_eigh_sampler_matches_dense_inverse_sqrt():
    """S^{-1/2} through the Gram eigendecomposition equals the dense D×D one."""
    _, pstate, _ = make_twins("classifier")
    Z = torch.from_numpy(inputs("classifier", 4, seed=11))
    eps = torch.randn(3, pstate.spec.num_params, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = tsample.make_inv_matsqrt(pstate, Z, ALPHA, full_set_size=N_FULL)(eps)
        ref = eps @ tsample.inv_matsqrt_dense(pstate, Z, ALPHA, N_FULL).T
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4)


def test_sample_methods_and_refusals():
    _, pstate, _ = make_twins("classifier")
    Z = torch.from_numpy(inputs("classifier", 4, seed=12))
    with torch.no_grad():
        draws = {m: tsample.sample(pstate, Z, ALPHA, torch.Generator().manual_seed(1),
                                   num_samples=2, full_set_size=N_FULL, method=m)
                 for m in ("gram_eigh", "dense", "lanczos")}
    torch.testing.assert_close(draws["gram_eigh"], draws["dense"], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(draws["lanczos"], draws["dense"], rtol=1e-3, atol=1e-4)
    with torch.no_grad():
        matheron = tsample.sample(pstate, Z, ALPHA, torch.Generator().manual_seed(1),
                                  num_samples=2, full_set_size=N_FULL, method="matheron")
    assert matheron.shape == draws["dense"].shape and torch.isfinite(matheron).all()
    with torch.no_grad():
        cov = ScalableLLAPredictor(pstate, Z, method="cov")
    assert cov.method == "cov" and torch.equal(cov.gram, cov.gram.T)


def test_sample_block_and_generator_wrapper_match_the_core():
    _, pstate, _ = make_twins("classifier")
    Z = torch.from_numpy(inputs("classifier", 5, seed=13))
    X = torch.from_numpy(inputs("classifier", 4, seed=14))
    with torch.no_grad():
        pred = ScalableLLAPredictor(pstate, Z, full_set_size=N_FULL)
        args = (pstate, pred.R, pred.lam, pred.V, ALPHA, pred.beta, X)
        drawn = amortized_logit_samples(*args, torch.Generator().manual_seed(3), 7)
        eps = torch.randn(7, pstate.spec.num_params, generator=torch.Generator().manual_seed(3))
        core = amortized_logit_samples_from_noise(*args, eps)
        blocked = amortized_logit_samples_from_noise(*args, eps, sample_block=3)
        one_shot = predict_lla_scalable(pstate, X, Z, ALPHA, torch.Generator().manual_seed(3),
                                        full_set_size=N_FULL, num_samples=7)
    torch.testing.assert_close(drawn, core, rtol=0, atol=0)
    # chunks change BLAS blocking, hence the order of f32 sums
    torch.testing.assert_close(blocked, core, rtol=1e-5, atol=1e-5)
    # one-shot path: same noise, rows through make_inv_matsqrt's core
    torch.testing.assert_close(one_shot, core, rtol=1e-3, atol=1e-4)


def _logit_samples(seed=15, S=9, B=13, C=4):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((S, B, C))).astype(np.float32)
    labels = rng.integers(0, C, size=B).astype(np.int32)
    return logits, labels


def test_mc_nll_acc_match_jax():
    logits, labels = _logit_samples()
    ref = jmet.mc_predictive_nll_acc(jnp.asarray(logits), jnp.asarray(labels))
    got = tmet.mc_predictive_nll_acc(torch.from_numpy(logits), torch.from_numpy(labels))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_brier_ece_auroc_match_jax():
    logits, labels = _logit_samples(seed=16, B=200)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1).mean(0))
    ood = np.asarray(jax.nn.softmax(0.3 * jnp.asarray(logits), axis=-1).mean(0))
    assert abs(tmet.brier_score(probs, labels) - jmet.brier_score(probs, labels)) <= 1e-6
    assert abs(tmet.ece(probs, labels) - jmet.ece(probs, labels)) <= 1e-6
    assert abs(tmet.auroc_ood(probs, ood) - jmet.auroc_ood(probs, ood)) <= 1e-6
    ties = np.array([0.1, 0.5, 0.5, 0.9, 0.5])
    lab = np.array([0, 1, 0, 1, 1])
    assert tmet.roc_auc(ties, lab) == jmet.roc_auc(ties, lab)


def test_mc_gaussian_nll_matches_jax():
    rng = np.random.default_rng(17)
    mu = rng.standard_normal((8, 6, 1)).astype(np.float32)
    y = rng.standard_normal((6, 1)).astype(np.float32)
    ref = jmet.mc_gaussian_nll(jnp.asarray(mu), jnp.asarray(y), -0.7)
    got = tmet.mc_gaussian_nll(torch.from_numpy(mu), torch.from_numpy(y), -0.7)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_harness_records(kind):
    _, pstate, _ = make_twins(kind)
    X = inputs(kind, 10, seed=18)
    y = (np.arange(10) % 3).astype(np.int32) if kind == "classifier" else \
        np.random.default_rng(0).standard_normal((10, 1)).astype(np.float32)
    loader = DataLoader(ArrayDataset(X, y), 4, drop_last=False)
    Z = torch.from_numpy(inputs(kind, 4, seed=19))
    with torch.no_grad():
        pred = ScalableLLAPredictor(pstate, Z, full_set_size=N_FULL)
        common = dict(alpha=ALPHA, full_set_size=N_FULL, num_mc_samples=5, predictor=pred)
        rec = eval_dataset_extended(pstate, loader, Z, generator=torch.Generator(), **common)
        nll, score = eval_dataset(pstate, loader, Z, generator=torch.Generator(), **common)
    assert np.isfinite(nll) and np.isfinite(score)
    if kind == "classifier":
        assert rec["probs"].shape == (10, 3) and rec["labels"].shape == (10,)
        assert all(np.isfinite(rec[k]) for k in ("nll", "acc", "brier", "ece"))
        with torch.no_grad():
            auroc = auroc_ood(pstate, rec["probs"], loader, Z, generator=torch.Generator(),
                              **common)
        assert 0.0 <= auroc <= 1.0
    else:
        assert rec["means"].shape == (10,) and 0.0 <= rec["picp90"] <= 1.0
        assert np.isfinite(rec["rmse"])
