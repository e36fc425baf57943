"""Twin tests of the port's dense paths: the GGN operator and the dense
curvature, the dense KL objective, the dense LLA predictive and its
sampling, and the restart selection, on the toy configs' own models (banana:
tanh MLP 3×16, 2 classes, D = 626; sine: GELU MLP 2×16, D = 321).

The dense algebra inverts ``GGN + αI``, whose condition number reaches
1e5–1e7 at the configs' α, so f32 results of any two implementations differ
by about κ·ε. The objective and the predictive are therefore held in float64
in both packages (JAX under ``jax.enable_x64``), at rtol 1e-8: round-off of
float64 amplified by κ. The GGN itself is a product without an inverse: f32,
relative 1e-5 (sums in another order). One Adam step of the dense objective
in f32 is held at α = 1 as the gram twins hold theirs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.inference import lla as jlla
from laplace_inducing_points_tpu.training import inducing as jind
from laplace_inducing_points_tpu_torch.core import operators as tops
from laplace_inducing_points_tpu_torch.inference import lla as tlla
from laplace_inducing_points_tpu_torch.training import inducing as tind

from torch_twins import inputs, jax_state64, make_twins, state64

# kind -> (M, |X|, the config's alpha, full_set_size)
CASES = {"banana": (8, 20, 2.5e-3, 450), "sine": (6, 16, 5e-3, 240)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _case(kind):
    M, nx, alpha, N = CASES[kind]
    jstate, pstate, _ = make_twins(kind)
    return jstate, pstate, inputs(kind, M, seed=11), inputs(kind, nx, seed=12), alpha, N


@pytest.mark.parametrize("kind", sorted(CASES))
def test_ggn_operator_and_curvature_dense_match_jax(kind):
    jstate, pstate, Z, _, alpha, N = _case(kind)
    D = pstate.spec.num_params
    V = np.random.default_rng(13).standard_normal((3, D)).astype(np.float32)
    jg = jops.make_ggn_operator(jstate, jnp.asarray(Z), N)
    with torch.no_grad():
        tg = tops.make_ggn_operator(pstate, torch.from_numpy(Z), N)
        mv, mm, dense = tg.matvec(torch.from_numpy(V[0])), tg.matmat(torch.from_numpy(V)), tg.dense()
        curv = tops.curvature_dense(pstate, torch.from_numpy(Z), alpha, N)
        op = tops.make_curvature_operator(pstate, torch.from_numpy(Z), alpha, N)
        sv = op(torch.from_numpy(V[1]))
    assert tg.num_params == D and dense.shape == (D, D)
    assert _rel(mv, jg.matvec(jnp.asarray(V[0]))) <= 1e-5
    assert _rel(mm, jg.matmat(jnp.asarray(V))) <= 1e-5
    assert _rel(dense, jg.dense()) <= 1e-5
    assert _rel(curv, jops.curvature_dense(jstate, jnp.asarray(Z), alpha, N)) <= 1e-5
    assert _rel(sv, jops.make_curvature_operator(jstate, jnp.asarray(Z), alpha, N)(
        jnp.asarray(V[1]))) <= 1e-5
    # the dense GGN is the operator, column by column
    assert _rel(dense @ torch.from_numpy(V[2]), tg.matvec(torch.from_numpy(V[2]))) <= 1e-5


@pytest.mark.parametrize("kind", sorted(CASES))
def test_kl_objective_dense_value_and_grad_match_jax_in_float64(kind):
    jstate, pstate, Z, X, alpha, N = _case(kind)
    Z64, X64 = Z.astype(np.float64), X.astype(np.float64)
    with jax.enable_x64(True):
        ref_v, ref_g = jax.value_and_grad(jind.kl_objective_dense)(
            jnp.asarray(Z64), jnp.asarray(X64), jax_state64(jstate), alpha, full_set_size=N)
        ref_v, ref_g = float(ref_v), np.asarray(ref_g)
    z = torch.from_numpy(Z64).requires_grad_()
    value = tind.kl_objective_dense(z, torch.from_numpy(X64), state64(pstate), alpha,
                                    full_set_size=N)
    (grad,) = torch.autograd.grad(value, z)
    assert abs(float(value.detach()) - ref_v) <= 1e-8 * abs(ref_v)
    assert _rel(grad, ref_g) <= 1e-8


@pytest.mark.parametrize("kind", sorted(CASES))
def test_kl_objective_dense_equals_the_gram_kl(kind, monkeypatch):
    """The port's own gram KL (constants kept, its Cholesky pivot jitter off:
    the same function) equals its dense KL, value and dL/dZ. The gram KL runs
    on the f32 kernels, so both are taken in f32 at α = 1, where the dense
    inverse is well conditioned: relative 1e-5 on the value, 1e-4 on dL/dZ."""
    _, pstate, Z, X, _, N = _case(kind)
    monkeypatch.setattr(tind, "_pivot_jitter", lambda C: torch.zeros((), dtype=C.dtype))
    out = {}
    for name, fn in (("dense", tind.kl_objective_dense), ("gram", tind.kl_objective_gram)):
        z = torch.from_numpy(Z).requires_grad_()
        value = fn(z, torch.from_numpy(X), pstate, 1.0, full_set_size=N)
        out[name] = (float(value.detach()), torch.autograd.grad(value, z)[0])
    assert abs(out["gram"][0] - out["dense"][0]) <= 1e-5 * abs(out["dense"][0])
    assert _rel(out["gram"][1], out["dense"][1]) <= 1e-4


def test_optimize_step_dense_matches_jax():
    """One Adam step on the dense objective in f32 at α = 1: the loss at the
    old Z and the step over the learning rate (the gram twins' rule)."""
    jstate, pstate, Z, X, _, N = _case("banana")
    lr, alpha = 0.01, 1.0
    opt = optax.adam(lr)
    new_ref, _, loss_ref = jind.optimize_step(
        jnp.asarray(Z), jnp.asarray(X), jstate, alpha, opt.init(jnp.asarray(Z)),
        jax.random.PRNGKey(0), objective="dense", optimizer=opt, full_set_size=N)
    z = torch.from_numpy(Z.copy())
    loss = tind.optimize_step(z, torch.from_numpy(X), pstate, alpha,
                              tind.make_optimizer(z, lr), objective="dense", full_set_size=N)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    u, u_ref = (z.numpy() - Z) / lr, (np.asarray(new_ref) - Z) / lr
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-2)
    assert _rel(u, u_ref) <= 1e-4


@pytest.mark.parametrize("kind", sorted(CASES))
def test_predict_lla_dense_and_posterior_match_jax_in_float64(kind):
    jstate, pstate, Z, X, alpha, N = _case(kind)
    xnew = inputs(kind, 7, seed=14).astype(np.float64)
    with jax.enable_x64(True):
        j64 = jax_state64(jstate)
        ref = jlla.predict_lla_dense(j64, jnp.asarray(xnew), jnp.asarray(Z.astype(np.float64)),
                                     alpha, full_set_size=N)
        post = jlla.posterior_lla_dense(j64, jnp.asarray(X.astype(np.float64)), alpha, N)
        ref_mean, ref_cov, ref_std = map(np.asarray, (ref.mean, ref.cov, ref.stddev()))
        post_mean, post_cov = np.asarray(post.mean), np.asarray(post.cov)
    s64 = state64(pstate)
    with torch.no_grad():
        got = tlla.predict_lla_dense(s64, torch.from_numpy(xnew),
                                     torch.from_numpy(Z.astype(np.float64)), alpha,
                                     full_set_size=N)
        gpost = tlla.posterior_lla_dense(s64, torch.from_numpy(X.astype(np.float64)), alpha, N)
    assert _rel(got.mean, ref_mean) <= 1e-8
    assert _rel(got.cov, ref_cov) <= 1e-8
    assert _rel(got.stddev(), ref_std) <= 1e-8
    np.testing.assert_array_equal(gpost.mean.numpy(), post_mean)
    assert _rel(gpost.cov, post_cov) <= 1e-8


def test_dense_predictor_hoists_the_ggn():
    """``DenseLLAPredictor``'s per-batch predictive is ``predict_lla_dense``'s."""
    _, pstate, Z, _, alpha, N = _case("banana")
    x = torch.from_numpy(inputs("banana", 5, seed=15))
    with torch.no_grad():
        pred = tlla.DenseLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N)
        got = pred.predictive(x, 1.0)
        ref = tlla.predict_lla_dense(pstate, x, torch.from_numpy(Z), 1.0, full_set_size=N)
        draws = pred.logit_samples(x, alpha, torch.Generator().manual_seed(0), 4)
    assert _rel(got.mean, ref.mean) <= 1e-6 and _rel(got.cov, ref.cov) <= 1e-4
    assert draws.shape == (4, 5, 2) and torch.isfinite(draws).all()


def test_gaussian_sample_on_the_same_noise_matches_jax():
    """The Cholesky sampler draws the same samples from the same ε (its
    factor is unique); the JAX ε is drawn from its key and passed on."""
    rng = np.random.default_rng(16)
    A = rng.standard_normal((5, 3, 3))
    cov = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    mean = rng.standard_normal((5, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jlla.Gaussian(jnp.asarray(mean), jnp.asarray(cov)).sample(key, 6)
    eps = jax.random.normal(key, (6, 5, 3), dtype=jnp.float32)
    got = tlla.Gaussian(torch.from_numpy(mean), torch.from_numpy(cov)).sample_from_noise(
        torch.from_numpy(np.asarray(eps)))
    assert _rel(got, ref) <= 1e-6
    np.testing.assert_allclose(
        tlla.Gaussian(torch.from_numpy(mean), torch.from_numpy(cov)).stddev().numpy(),
        np.asarray(jlla.Gaussian(jnp.asarray(mean), jnp.asarray(cov)).stddev()), rtol=1e-6)
    bad = tlla.Gaussian(torch.zeros(3), -torch.eye(3)).sample(torch.Generator().manual_seed(0), 2)
    assert torch.isnan(bad).all()       # a failed factor is NaN, as the reference's


@pytest.mark.parametrize("kind", sorted(CASES))
def test_la_samples_dense_factor_product_matches_jax_in_float64(kind):
    """The SVD factor is unique up to column signs, so its product ``F Fᵀ``
    is held against JAX's posterior covariance; the draws are the network at
    ``θ_MAP + F ε``."""
    jstate, pstate, Z, _, alpha, N = _case(kind)
    Z64 = Z.astype(np.float64)
    with jax.enable_x64(True):
        S = jops.curvature_dense(jax_state64(jstate), jnp.asarray(Z64), alpha, N)
        ref_cov = np.asarray(jnp.linalg.solve(S, jnp.eye(S.shape[0])))
    s64 = state64(pstate)
    with torch.no_grad():
        F = tlla.la_covariance_factor(s64, torch.from_numpy(Z64), alpha, N)
        x = torch.from_numpy(inputs(kind, 4, seed=17).astype(np.float64))
        eps = torch.from_numpy(np.random.default_rng(18).standard_normal((3, F.shape[0])))
        draws = tlla.predict_la_samples_dense_from_noise(s64, x, F, eps)
        one = tops.model_outputs(s64, s64.flat_params + F @ eps[1], x)
        gen = tlla.predict_la_samples_dense(s64, x, torch.from_numpy(Z64), alpha,
                                            torch.Generator().manual_seed(0), N, 5)
    assert _rel(F @ F.T, ref_cov) <= 1e-8
    assert draws.shape == (3, 4, one.shape[-1]) and _rel(draws[1], one) <= 1e-12
    assert gen.shape == (5, 4, one.shape[-1]) and torch.isfinite(gen).all()


def test_materialize_covariance_matches_jax():
    rng = np.random.default_rng(19)
    A = rng.standard_normal((6, 6)).astype(np.float32)
    C = A @ A.T
    for mode in ("diag", "full"):
        ref = jlla.materialize_covariance(lambda v: jnp.asarray(C) @ v, 3, 2, mode)
        got = tlla.materialize_covariance(lambda v: torch.from_numpy(C) @ v, 3, 2, mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        tlla.materialize_covariance(lambda v: v, 3, 2, "half")


def test_full_set_kl_matches_jax_on_banana():
    """The restart criterion in f32 at α = 1 (at the config's α the f32 value,
    a difference of terms ~γ/α·tr Gxx, differs by ~κ·ε between any two
    implementations): relative 2e-5, the gram twins' value tolerance."""
    jstate, pstate, Z, X, _, N = _case("banana")
    ref = float(jind.full_set_kl(jnp.asarray(Z), jnp.asarray(X), jstate, 1.0, N))
    got = tind.full_set_kl(torch.from_numpy(Z), torch.from_numpy(X), pstate, 1.0, N)
    assert abs(got - ref) <= 2e-5 * abs(ref)


def test_restarts_select_the_lowest_full_set_kl():
    """Three restarts: restart 0 from z_init is the plain run with its
    generator; the winner is the lowest exact full-set KL, and it is
    returned."""
    _, pstate, Z, X, _, N = _case("banana")
    x = torch.from_numpy(X)
    batches = [(X[:8], None), (X[8:16], None)]

    def cycle():
        while True:
            yield from batches

    knobs = dict(alpha=1.0, num_steps=3, lr=0.05, full_set_size=N)
    Zb, best, kls = tind.train_inducing_points_restarts(
        pstate, torch.from_numpy(Z), cycle(), selection_X=x, n_restarts=3, seed=9, **knobs)
    assert len(kls) == 3 and best == min(kls) and len(set(kls)) == 3
    assert tind.full_set_kl(Zb, x, pstate, 1.0, N) == pytest.approx(best, rel=1e-6)
    Z0 = tind.train_inducing_points(
        pstate, torch.from_numpy(Z), cycle(),
        generator=torch.Generator().manual_seed(9 * 1000003), **knobs)
    assert tind.full_set_kl(Z0, x, pstate, 1.0, N) == pytest.approx(kls[0], rel=1e-6)
    # a pool smaller than M draws with replacement
    _, _, kls_small = tind.train_inducing_points_restarts(
        pstate, torch.from_numpy(Z), cycle(), selection_X=x, candidate_pool=x[:3],
        n_restarts=2, seed=1, **knobs)
    assert len(kls_small) == 2 and all(np.isfinite(kls_small))
