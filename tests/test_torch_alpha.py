"""Twin tests of the port's α selection: the log evidence and its derivative
in log α, one ``update_alpha`` step, the evidence MAP loop, the
validation-NLL grid search, and the weight predictive and grid search on the
committed real digits (``data/fixtures/digits_mini``) from a MAP and a Z that
the JAX package trained.

Trap C4: seeded draws are never compared. The port draws its noise from a
``torch.Generator``; the JAX side gets the very same noise through a
predictor that takes it from the same generator (:class:`FixedNoise`), and
runs its own harness, metrics and grid search on it. Tolerances:

* log evidence: absolute 1e-5 of the magnitude of its two terms (the prior
  term and the log-det term, each ~D·|log α|, cancel in f32); its derivative
  in log α: relative 1e-4;
* one Adam step on log α: absolute 1e-6 (the step is ~lr·sign);
* the grid search's NLL curve: absolute 1e-4 at every point, and the same α;
* the real-digits metrics (NLL, ACC, Brier, ECE): absolute 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.evaluation import harness as jharness
from laplace_inducing_points_tpu.inference.lla import ScalableLLAPredictor as JaxPredictor
from laplace_inducing_points_tpu.inference.sample import _g_weights as jax_g_weights
from laplace_inducing_points_tpu.training import alpha as jalpha
from laplace_inducing_points_tpu.training import grid_search as jgrid
from laplace_inducing_points_tpu_torch.core.params import params_from_jax
from laplace_inducing_points_tpu_torch.data.loader import ArrayDataset, DataLoader
from laplace_inducing_points_tpu_torch.evaluation.harness import eval_dataset_extended
from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
from laplace_inducing_points_tpu_torch.models.scale import LargeClassifier
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.training import alpha as talpha
from laplace_inducing_points_tpu_torch.training.grid_search import grid_search_alpha

from torch_twins import inputs, make_twins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "results", "digits_baseline_r5.jsonl")


class FixedNoise:
    """A JAX predictor whose per-batch noise ε (S, D) is the port's: drawn
    from a ``torch.Generator`` as ``inference.lla.amortized_logit_samples``
    draws it; the weight draws and the push-forward are the JAX package's
    (``inference/lla.py:149-174``) on its own factor."""

    def __init__(self, state, Z, full_set_size, range_clip_min=None):
        self.state = state
        self.pred = JaxPredictor(state, jnp.asarray(Z), full_set_size=full_set_size,
                                 range_clip_min=range_clip_min)
        self.reseed(0)

    def reseed(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def logit_samples(self, x, alpha, key, num_samples, cache_key=None):
        p = self.pred
        eps = jnp.asarray(torch.randn(num_samples, p.R.shape[1],
                                      generator=self.generator).numpy())
        g = jax_g_weights(p.lam, alpha, p.beta, p.rank_tol, p.range_clip_min)
        lin = jops.linearize_model(self.state, jnp.asarray(x, dtype=jnp.float32))
        mixed = jops.pdot(jops.pdot(eps, p.R.T), p.V) * g
        w = eps / jnp.sqrt(alpha) + jops.pdot(jops.pdot(mixed, p.V.T), p.R)
        return lin.f0[None] + jax.vmap(lin.jvp)(w)


# --- the log evidence and update_alpha ----------------------------------------

@pytest.mark.parametrize("kind,n,N", [("classifier", 12, 100), ("lenet5", 4, 60000)])
def test_log_marginal_likelihood_and_slope_match_jax(kind, n, N):
    jstate, pstate, _ = make_twins(kind)
    X = inputs(kind, n, seed=21)
    log_alpha = np.float32(np.log(0.3))

    def jax_lml(la):
        return jalpha.log_marginal_likelihood(jnp.exp(la), jnp.asarray(X), jstate, N)

    ref_v, ref_g = jax.value_and_grad(jax_lml)(jnp.asarray(log_alpha))
    la = torch.tensor(log_alpha, requires_grad=True)
    got_v = talpha.log_marginal_likelihood(torch.exp(la), torch.from_numpy(X), pstate, N)
    (got_g,) = torch.autograd.grad(got_v, la)
    flat = pstate.flat_params
    D = flat.shape[0]
    scale = abs(0.3 * float(flat @ flat)) + D * abs(float(log_alpha))
    assert abs(float(got_v.detach()) - float(ref_v)) <= 1e-5 * scale
    np.testing.assert_allclose(float(got_g), float(ref_g), rtol=1e-4)
    # blocked row build: the same value
    blocked = talpha.log_marginal_likelihood(0.3, torch.from_numpy(X), pstate, N,
                                             example_block=3)
    assert abs(float(blocked) - float(got_v.detach())) <= 1e-6 * scale


def test_update_alpha_matches_one_optax_step():
    jstate, pstate, _ = make_twins("classifier")
    X = inputs("classifier", 10, seed=22)
    opt = optax.adam(5e-2)
    la0 = jnp.asarray(np.float32(np.log(2.0)))
    new_ref, _ = jalpha.update_alpha(la0, opt.init(la0), opt, jnp.asarray(X), jstate, 80)
    la = torch.tensor(np.float32(np.log(2.0)), requires_grad=True)
    value, slope = talpha.update_alpha(la, talpha.make_alpha_optimizer(la), torch.from_numpy(X),
                                       pstate, 80)
    assert abs(float(la.detach()) - float(new_ref)) <= 1e-6
    ref_v, ref_g = jax.value_and_grad(
        lambda a: jalpha.log_marginal_likelihood(jnp.exp(a), jnp.asarray(X), jstate, 80))(la0)
    np.testing.assert_allclose(float(slope), float(ref_g), rtol=1e-4)
    np.testing.assert_allclose(float(value), float(ref_v), rtol=1e-5)


def test_train_map_then_alpha_moves_alpha_and_keeps_the_state():
    _, pstate, _ = make_twins("classifier")
    rng = np.random.default_rng(23)
    x = rng.standard_normal((64, 2)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    loader = DataLoader(ArrayDataset(x, y), 16, shuffle=True)
    before = pstate.flat_params.clone()
    losses = []
    trained, alpha = talpha.train_map_then_alpha(
        pstate, loader, loader, num_epochs=4, alpha0=1.0, lr=1e-2, alpha_every=1,
        burnin=1, full_set_size=64, callback=lambda step, loss: losses.append(float(loss)))
    assert len(losses) == 4 * len(loader) and np.isfinite(losses).all()
    assert alpha != 1.0 and np.isfinite(alpha)
    # three α steps of Adam at lr 0.05 move log α by at most 0.15
    assert abs(np.log(alpha)) <= 3 * 0.05 + 1e-6
    torch.testing.assert_close(pstate.flat_params, before, rtol=0, atol=0)
    assert not torch.equal(trained.flat_params, before)


# --- the grid search ------------------------------------------------------------

def _jax_grid(jstate, Z, loader, N, S, range_clip_min, **grid):
    """JAX's grid search on the port's noise: every α reseeds the noise, as
    the port's search reseeds its generator."""
    pred = FixedNoise(jstate, Z, N, range_clip_min)
    curve = []

    def eval_fn(state, loader, Z, alpha, full_set_size, num_mc_samples, rng):
        pred.reseed(0)
        nll, acc = jharness.eval_dataset(state, loader, Z, alpha=alpha,
                                         full_set_size=full_set_size,
                                         num_mc_samples=num_mc_samples, rng=rng,
                                         predictor=pred)
        curve.append((alpha, nll))
        return nll, acc

    best = jgrid.grid_search_alpha(jstate, jnp.asarray(Z), loader, full_set_size=N,
                                   num_mc_samples=S, eval_fn=eval_fn, verbose=False, **grid)
    return best, curve


def test_grid_search_matches_jax_on_the_same_noise():
    jstate, pstate, _ = make_twins("classifier")
    Z = inputs("classifier", 5, seed=24)
    xv = inputs("classifier", 11, seed=25)
    yv = (np.arange(11) % 3).astype(np.int32)
    loader = DataLoader(ArrayDataset(xv, yv), 4, drop_last=False)
    grid = dict(log10_min=-2.0, log10_max=1.0, n_coarse=5)
    ref_best, ref_curve = _jax_grid(jstate, Z, loader, 40, 16, None, **grid)
    curve = []
    best = grid_search_alpha(pstate, torch.from_numpy(Z), loader, full_set_size=40,
                             num_mc_samples=16, verbose=False, history=curve,
                             sample_block=5, **grid)
    assert len(curve) == len(ref_curve) == 8
    for (a, v), (a_ref, v_ref) in zip(curve, ref_curve):
        assert a == pytest.approx(a_ref, rel=1e-12)
        assert abs(v - v_ref) <= 1e-4, (a, v, v_ref)
    assert best == pytest.approx(ref_best, rel=1e-12)


# --- the real digits ---------------------------------------------------------------

@pytest.fixture(scope="module")
def digits():
    """The JAX package's held-out-class MAP on the real digits and its Z
    (``tests/test_real_data.py``, ``scripts/digits_baseline.py``: seed 0,
    M = 12, α = 0.1, 15 gram steps), converted into the port."""
    from laplace_inducing_points_tpu.training.inducing import train_inducing_points
    from test_real_data import _digits_heldout_map

    jstate, xtr, ytr, xte, yte, _, _ = _digits_heldout_map(0)
    Z = train_inducing_points(jstate, xtr[:12], optax.adam(5e-2),
                              batches=iter(lambda: (xtr, ytr), None), alpha=0.1,
                              num_steps=15, full_set_size=int(xtr.shape[0]),
                              objective="gram", verbose=False)
    model = LargeClassifier((8, 8, 1), [32], 1, 5)
    flat, _ = params_from_jax(jax.tree.map(np.asarray, dict(jstate.params)))
    pstate = ModelState(model, flat, "classifier")
    loader = DataLoader(ArrayDataset(np.asarray(xte), np.asarray(yte)), 20, drop_last=False)
    return jstate, pstate, np.array(Z), int(xtr.shape[0]), loader


def test_real_digits_predictive_matches_jax_and_the_baseline(digits):
    """Same MAP, Z and noise: the port's weight predictive and the JAX
    package's agree on every metric; against ``results/digits_baseline_r5.
    jsonl`` (the JAX package's own noise, 3 repetitions per α) the port's
    metrics lie within MC noise of the recorded mean."""
    import json

    jstate, pstate, Z, N, loader = digits
    baseline = [json.loads(line) for line in open(BASELINE)]
    ref_pred = FixedNoise(jstate, Z, N)
    with torch.no_grad():
        pred = ScalableLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N)
    for i, alpha in enumerate((0.01, 0.1, 1.0)):
        ref_pred.reseed(100 + i)
        ref = jharness.eval_dataset_extended(jstate, loader, jnp.asarray(Z), alpha=alpha,
                                             full_set_size=N, num_mc_samples=128,
                                             rng=jax.random.PRNGKey(0), predictor=ref_pred)
        with torch.no_grad():
            got = eval_dataset_extended(pstate, loader, torch.from_numpy(Z), alpha=alpha,
                                        full_set_size=N, num_mc_samples=128,
                                        generator=torch.Generator().manual_seed(100 + i),
                                        predictor=pred)
        for key in ("nll", "acc", "brier", "ece"):
            assert abs(got[key] - float(ref[key])) <= 1e-4, (alpha, key, got[key], ref[key])
        rows = [r for r in baseline if r["predictive"] == "weight" and r["alpha"] == alpha]
        assert len(rows) == 3
        nlls = [r["nll"] for r in rows]
        spread = max(nlls) - min(nlls)
        assert abs(got["nll"] - np.mean(nlls)) <= max(2 * spread, 0.05), (alpha, got, nlls)
        assert got["acc"] > 0.4


def test_real_digits_grid_search_matches_jax(digits):
    jstate, pstate, Z, N, loader = digits
    grid = dict(log10_min=-2.0, log10_max=0.0, n_coarse=3)
    ref_best, ref_curve = _jax_grid(jstate, Z, loader, N, 64, None, **grid)
    curve = []
    best = grid_search_alpha(pstate, torch.from_numpy(Z), loader, full_set_size=N,
                             num_mc_samples=64, verbose=False, history=curve, **grid)
    for (a, v), (a_ref, v_ref) in zip(curve, ref_curve):
        assert a == pytest.approx(a_ref, rel=1e-12)
        assert abs(v - v_ref) <= 1e-4, (a, v, v_ref)
    assert best == pytest.approx(ref_best, rel=1e-12)
    # the NLL falls towards the larger α, as in the baseline's table
    assert curve[2][1] < curve[0][1]
