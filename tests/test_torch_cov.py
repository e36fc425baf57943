"""Twin tests of the port's ``cov`` predictive: the per-image statistics
``(f0, JJᵀ, J Rᵀ)``, the covariance Σ each image's draws come from, the
self-check and the statistics cache.

The per-image factor of Σ comes from an ``eigh``, unique only up to column
signs, so the draws of the two packages differ on the same noise; Σ is
compared instead. JAX's Σ is read off its own sampler: its noise is
``jax.random.normal(key, (S, B, K))``, drawn here from the same key, and the
factor ``L`` solves ``samples − f0 = η Lᵀ``. Tolerances: the statistics
relative 1e-5 (f32 sums in another order); Σ relative 1e-4 at α = 1, where
its f32 assembly is well conditioned (at the toy configs' α it cancels terms
~JJᵀ/α by 46–137× in both packages, which the self-check is for).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.inference import lla as jlla
from laplace_inducing_points_tpu_torch.core import operators as tops
from laplace_inducing_points_tpu_torch.evaluation import harness as tharness
from laplace_inducing_points_tpu_torch.inference import lla as tlla
from laplace_inducing_points_tpu_torch.data.loader import ArrayDataset, DataLoader

from torch_twins import inputs, make_twins

M, N, ALPHA = 6, 60, 1.0


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def twins():
    jstate, pstate, _ = make_twins("banana")
    return jstate, pstate, inputs("banana", M, seed=21)


@pytest.mark.parametrize("jac_block", [None, 3, 16])
def test_predictive_jac_stats_match_jax(twins, jac_block):
    jstate, pstate, Z = twins
    x = inputs("banana", 7, seed=22)
    R = np.asarray(jops.dense_wt(jstate, jnp.asarray(Z)))
    ref = jops.predictive_jac_stats(jstate, jnp.asarray(x), jnp.asarray(R), jac_block=jac_block)
    with torch.no_grad():
        got = tops.predictive_jac_stats(pstate, torch.from_numpy(x), torch.from_numpy(R),
                                        jac_block=jac_block)
    for g, r, name in zip(got, ref, ("f0", "JJt", "A")):
        assert g.shape == r.shape, name
        assert _rel(g, r) <= 1e-5, name


def _jax_sigma(jpred, x, alpha, S=16, key=jax.random.PRNGKey(5)):
    f0, JJt, A = jpred.batch_stats(jnp.asarray(x))
    out = jlla._joint_logit_samples(f0, JJt, A, jpred.gram, jpred.lam, jpred.V, alpha,
                                    jpred.beta, key, S, jpred.rank_tol, jpred.range_clip_min)
    eta = np.asarray(jax.random.normal(key, (S,) + f0.shape), np.float64)
    dev = np.asarray(out, np.float64) - np.asarray(f0, np.float64)[None]
    sig = []
    for b in range(f0.shape[0]):
        Lt = np.linalg.lstsq(eta[:, b], dev[:, b], rcond=None)[0]       # (K, K) = Lᵀ
        sig.append(Lt.T @ Lt)
    return np.stack(sig)


@pytest.mark.parametrize("range_clip", [None, 1.0])
def test_cov_sigma_matches_jax(twins, range_clip):
    jstate, pstate, Z = twins
    x = inputs("banana", 5, seed=23)
    jpred = jlla.ScalableLLAPredictor(jstate, jnp.asarray(Z), full_set_size=N,
                                      range_clip_min=range_clip, method="cov")
    ref = _jax_sigma(jpred, x, ALPHA)
    with torch.no_grad():
        tpred = tlla.ScalableLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N,
                                          range_clip_min=range_clip, method="cov")
        _, JJt, A = tpred.batch_stats(torch.from_numpy(x))
        sigma = tlla.cov_predictive_sigma(JJt, A, tpred.gram, tpred.lam, tpred.V, ALPHA,
                                          tpred.beta, tpred.rank_tol, range_clip)
    assert torch.equal(sigma, sigma.transpose(1, 2))
    assert _rel(sigma, ref) <= 1e-4


def test_joint_logit_samples_draw_from_sigma(twins):
    """The port's draws on given noise are ``f0 + L η`` with ``L Lᵀ = Σ``."""
    _, pstate, Z = twins
    x = torch.from_numpy(inputs("banana", 4, seed=24))
    with torch.no_grad():
        pred = tlla.ScalableLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N,
                                         method="cov")
        f0, JJt, A = pred.batch_stats(x)
        args = (JJt, A, pred.gram, pred.lam, pred.V, ALPHA, pred.beta)
        sigma = tlla.cov_predictive_sigma(*args)
        eta = torch.randn(4000, 4, 2, generator=torch.Generator().manual_seed(1))
        draws = tlla.joint_logit_samples_from_noise(f0, *args[:-2], ALPHA, pred.beta, eta)
    dev = (draws - f0[None]).double()
    emp = torch.einsum("sbk,sbl->bkl", dev, dev) / dev.shape[0]
    assert _rel(emp, sigma) <= 0.06                # 4,000 draws: ~2/sqrt(4000) per entry


def _warned(fn) -> bool:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return any("f32 covariance-assembly range" in str(w.message) for w in caught)


@pytest.mark.parametrize("gram_scale,fires", [(1.0, False), (100.0, True)])
def test_cov_self_check_agrees_with_jax(twins, gram_scale, fires):
    """Silent where Σ is right; with the Gram the cov path reads scaled by
    100 (its variances off by far more than 3×) both packages warn."""
    jstate, pstate, Z = twins
    x = inputs("banana", 16, seed=25)
    jpred = jlla.ScalableLLAPredictor(jstate, jnp.asarray(Z), full_set_size=N, method="cov")
    jpred.gram = jpred.gram * gram_scale
    with torch.no_grad():
        tpred = tlla.ScalableLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N,
                                          method="cov")
        tpred.gram = tpred.gram * gram_scale
        got = _warned(lambda: tpred.logit_samples(torch.from_numpy(x), ALPHA,
                                                  torch.Generator().manual_seed(0), 8))
    ref = _warned(lambda: jpred.logit_samples(jnp.asarray(x), ALPHA, jax.random.PRNGKey(0), 8))
    assert got == ref == fires
    assert (tpred.cov_check_frac > tlla.COV_CHECK_TAIL) == fires
    with torch.no_grad():                # once per predictor
        assert not _warned(lambda: tpred.logit_samples(torch.from_numpy(x), ALPHA,
                                                       torch.Generator().manual_seed(1), 8))


def test_batch_stats_cache_and_its_shape_guard(twins):
    _, pstate, Z = twins
    x = torch.from_numpy(inputs("banana", 6, seed=26))
    with torch.no_grad():
        pred = tlla.ScalableLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N,
                                         method="cov")
        first = pred.batch_stats(x, cache_key=("eval", 1, 0))
        again = pred.batch_stats(x, cache_key=("eval", 1, 0))
        assert pred.cache_hits == 1 and all(a is b for a, b in zip(first, again))
        # another batch shape under the same key is computed anew, not served
        other = pred.batch_stats(x[:4], cache_key=("eval", 1, 0))
        assert pred.cache_hits == 1 and other[0].shape == (4, 2)
        fresh = pred.batch_stats(x[:4])
        for a, b in zip(other, fresh):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_eval_reuses_the_statistics_across_repetitions(twins):
    """The harness names each batch, so a second pass over the same loader
    hits the cache once a batch."""
    _, pstate, Z = twins
    x = inputs("banana", 10, seed=27)
    loader = DataLoader(ArrayDataset(x, (x[:, 0] > 0).astype(np.int32)), 4, drop_last=False)
    with torch.no_grad():
        pred = tlla.ScalableLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N,
                                         method="cov")
        recs = [tharness.eval_dataset_extended(pstate, loader, torch.from_numpy(Z),
                                               alpha=ALPHA, full_set_size=N, num_mc_samples=5,
                                               generator=torch.Generator().manual_seed(i),
                                               predictor=pred) for i in range(2)]
    assert pred.cache_hits == 3           # three batches; the self-check keys none
    assert all(np.isfinite(r["nll"]) for r in recs)


@pytest.mark.parametrize("scalable", [True, False])
def test_batch_logit_samples_is_the_sampler_built_for_one_batch(twins, scalable):
    """The one-shot ``batch_logit_samples`` draws what ``make_batch_sampler``
    draws from the same generator state (the factor built for one batch)."""
    _, pstate, Z = twins
    x = torch.from_numpy(inputs("banana", 5, seed=28))
    z = torch.from_numpy(Z)
    with torch.no_grad():
        one = tharness.batch_logit_samples(pstate, x, z, alpha=ALPHA, full_set_size=N,
                                           num_mc_samples=4, scalable=scalable,
                                           generator=torch.Generator().manual_seed(3))
        sampler = tharness.make_batch_sampler(pstate, z, alpha=ALPHA, full_set_size=N,
                                              num_mc_samples=4, scalable=scalable)
        loop = sampler(x, torch.Generator().manual_seed(3))
    assert one.shape == (4, 5, 2)
    torch.testing.assert_close(one, loop, rtol=1e-5, atol=1e-5)
