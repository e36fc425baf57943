"""Twin tests of the port's stochastic slice: the trace estimators, the Krylov
layer, the SLQ log-dets, the materialized GGN sweep, the stochastic KL
objective with its dL/dZ and one Adam step, and the Lanczos sampler.

Both packages get the same numpy inputs; the probes come from
``jax.random.rademacher`` and are handed to the port (it cannot draw JAX's
bits). The JAX objectives run under ``jax.jit`` (one compile instead of many
op-by-op ones). Tolerances, each with its reason:

* estimators, Krylov coefficients and SLQ on explicit matrices: relative
  1e-4 (value) and relative L2 1e-4 (gradient) — f32 sums in another order
  through QR, eigh and SVD of small matrices;
* the stochastic KL: value within 1e-4 relative and dL/dZ within 1e-3
  relative L2 — the objective goes through a Cholesky of the Gram, a QR of
  the range-finder sweep and Krylov recurrences, each amplifying summation
  order differences by its conditioning (the gram twins' LeNet5 tolerances);
* the Lanczos sampler: rtol 1e-3 / atol 1e-4, as the other sampler twins.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.inference import sample as jsample
from laplace_inducing_points_tpu.ops import lanczos as jlz
from laplace_inducing_points_tpu.ops import slq as jslq
from laplace_inducing_points_tpu.ops import stochtrace as jst
from laplace_inducing_points_tpu.training import inducing as jind
from laplace_inducing_points_tpu_torch.core import operators as tops
from laplace_inducing_points_tpu_torch.core.params import params_from_jax
from laplace_inducing_points_tpu_torch.inference import sample as tsample
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier
from laplace_inducing_points_tpu_torch.ops import lanczos as tlz
from laplace_inducing_points_tpu_torch.ops import slq as tslq
from laplace_inducing_points_tpu_torch.ops import stochtrace as tst
from laplace_inducing_points_tpu_torch.training import inducing as tind

from fixtures import classifier_state
from torch_twins import TOY_IN, inputs, make_twins


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _spd(n: int, seed: int) -> np.ndarray:
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a @ a.T / n + 0.1 * np.eye(n)).astype(np.float32)


def _rademacher(seed: int, num: int, dim: int) -> np.ndarray:
    return np.asarray(jax.random.rademacher(jax.random.PRNGKey(seed), (num, dim),
                                            dtype=jnp.float32))


def _value_and_grad_both(jax_fn, torch_fn, A: np.ndarray):
    """``(value, dvalue/dA)`` of the same function in both packages."""
    ref_v, ref_g = jax.value_and_grad(jax_fn)(jnp.asarray(A))
    a = torch.from_numpy(A).requires_grad_()
    got_v = torch_fn(a)
    (got_g,) = torch.autograd.grad(got_v, a)
    return (float(got_v), got_g.numpy()), (float(ref_v), np.asarray(ref_g))


# --- trace estimators on an explicit SPD matmat --------------------------------

ESTIMATORS = {   # name -> (JAX estimator, port estimator)
    "hutchinson": (jst.hutchinson, tst.hutchinson),
    "hutchpp": (functools.partial(jst.hutchpp, s1=14, s2=6),
                functools.partial(tst.hutchpp, s1=14, s2=6)),
    "hutchpp_default_split": (jst.hutchpp, tst.hutchpp),
    "na_hutchpp": (jst.na_hutchpp, tst.na_hutchpp),
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_trace_estimators_match_jax(name):
    A, probes = _spd(40, 1), _rademacher(2, 20, 40)
    jax_est, port_est = ESTIMATORS[name]
    got, ref = _value_and_grad_both(
        lambda a: jax_est(lambda V: V @ a.T, jnp.asarray(probes)),
        lambda a: port_est(lambda V: V @ a.T, torch.from_numpy(probes)), A)
    assert abs(got[0] - ref[0]) <= 1e-4 * abs(ref[0])
    assert _rel(got[1], ref[1]) <= 1e-4


def test_hutchpp_clips_the_range_finder_to_d():
    """With more range-finder probes than D, s1 is cut to D and the estimate
    is exact, as in the reference."""
    A, probes = _spd(8, 3), _rademacher(4, 24, 8)
    got = float(tst.hutchpp(lambda V: V @ torch.from_numpy(A).T, torch.from_numpy(probes),
                            s1=18, s2=6))
    ref = float(jst.hutchpp(lambda V: V @ jnp.asarray(A).T, jnp.asarray(probes), s1=18, s2=6))
    assert abs(got - ref) <= 1e-5 * abs(ref)
    assert abs(got - float(np.trace(A))) <= 1e-4 * float(np.trace(A))


def test_probes_and_unported_estimator():
    gen = torch.Generator().manual_seed(0)
    p = tst.rademacher_probes(gen, 5, 300)
    assert p.shape == (5, 300) and p.dtype == torch.float32
    assert set(np.unique(p.numpy())) == {-1.0, 1.0}
    assert tst.normal_probes(gen, 3, 7).shape == (3, 7)
    # trace_of_inverse runs on the batched CG now: exact with a full range finder
    A = torch.from_numpy(_spd(6, 8)).double()
    got = tst.trace_of_inverse(lambda V: V @ A.T, tst.rademacher_probes(gen, 12, 6,
                                                                        dtype=torch.float64))
    assert float(got) == pytest.approx(float(torch.trace(torch.linalg.inv(A))), rel=1e-6)


# --- Krylov layer ---------------------------------------------------------------

@pytest.mark.parametrize("reorthogonalize", [True, False])
def test_lanczos_sym_matches_jax(reorthogonalize):
    A, v0 = _spd(30, 5), np.random.default_rng(6).standard_normal(30).astype(np.float32)
    ref = jlz.lanczos_sym(lambda v: jnp.asarray(A) @ v, jnp.asarray(v0), 10,
                          reorthogonalize=reorthogonalize)
    got = tlz.lanczos_sym(lambda v: torch.from_numpy(A) @ v, torch.from_numpy(v0), 10,
                          reorthogonalize=reorthogonalize)
    assert _rel(got.alphas, ref.alphas) <= 1e-4
    assert _rel(got.betas, ref.betas) <= 1e-4
    assert got.basis.shape == (10, 30)
    np.testing.assert_allclose(got.basis.numpy(), np.asarray(ref.basis), atol=1e-4)


@pytest.mark.parametrize("clip_min", [None, 1.0])
def test_funm_lanczos_sym_matches_jax(clip_min):
    A, v = 3.0 * _spd(30, 7), np.random.default_rng(8).standard_normal(30).astype(np.float32)
    ref = jlz.funm_lanczos_sym(lambda t: 1.0 / jnp.sqrt(t), lambda u: jnp.asarray(A) @ u,
                               jnp.asarray(v), 12, clip_min=clip_min)
    got = tlz.funm_lanczos_sym(lambda t: 1.0 / torch.sqrt(t),
                               lambda u: torch.from_numpy(A) @ u, torch.from_numpy(v), 12,
                               clip_min=clip_min)
    assert _rel(got.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("with_adjoint,reorthogonalize", [(True, True), (False, True),
                                                          (True, False)])
def test_golub_kahan_bidiag_matches_jax(with_adjoint, reorthogonalize):
    """Without ``t_matvec`` the adjoint comes from the vjp of the linear map
    (JAX: ``linear_transpose``)."""
    rng = np.random.default_rng(9)
    G, v0 = rng.standard_normal((50, 30)).astype(np.float32), rng.standard_normal(30).astype(np.float32)
    ref = jlz.golub_kahan_bidiag(lambda v: jnp.asarray(G) @ v, jnp.asarray(v0), 9,
                                 t_matvec=lambda u: jnp.asarray(G).T @ u,
                                 reorthogonalize=reorthogonalize)
    Gt = torch.from_numpy(G)
    got = tlz.golub_kahan_bidiag(lambda v: Gt @ v, torch.from_numpy(v0), 9,
                                 t_matvec=(lambda u: Gt.T @ u) if with_adjoint else None,
                                 reorthogonalize=reorthogonalize)
    assert _rel(got.alphas, ref.alphas) <= 1e-4
    assert _rel(got.betas, ref.betas) <= 1e-4
    np.testing.assert_allclose(got.right.numpy(), np.asarray(ref.right), atol=1e-4)
    B = tlz.bidiag_dense(got.alphas, got.betas).numpy()
    np.testing.assert_allclose(B, np.asarray(jlz.bidiag_dense(ref.alphas, ref.betas)),
                               rtol=1e-4, atol=1e-5)


def test_slq_logdet_sym_matches_jax():
    A, probes = _spd(24, 10), _rademacher(11, 3, 24)
    got, ref = _value_and_grad_both(
        lambda a: jslq.slq_logdet_sym(lambda v: a @ v, jnp.asarray(probes), 8),
        lambda a: tslq.slq_logdet_sym(lambda v: a @ v, torch.from_numpy(probes), 8), A)
    assert abs(got[0] - ref[0]) <= 1e-4 * abs(ref[0])
    assert _rel(got[1], ref[1]) <= 1e-4


def test_slq_logdet_product_matches_jax():
    """logdet(GᵀG) of a stacked ``[√α I; G]`` operator, as the KL uses it."""
    G, probes = np.random.default_rng(12).standard_normal((6, 24)).astype(np.float32), \
        _rademacher(13, 2, 24)
    sa = float(np.sqrt(0.3))

    def jax_fn(g):
        mv = lambda v: jnp.concatenate([sa * v, g @ v])         # noqa: E731
        mvt = lambda w: sa * w[:24] + g.T @ w[24:]              # noqa: E731
        return jslq.slq_logdet_product(mv, jnp.asarray(probes), 10, t_matvec=mvt)

    def torch_fn(g):
        mv = lambda v: torch.cat([sa * v, g @ v])               # noqa: E731
        mvt = lambda w: sa * w[:24] + g.T @ w[24:]              # noqa: E731
        return tslq.slq_logdet_product(mv, torch.from_numpy(probes), 10, t_matvec=mvt)

    got, ref = _value_and_grad_both(jax_fn, torch_fn, G)
    assert abs(got[0] - ref[0]) <= 1e-4 * abs(ref[0])
    assert _rel(got[1], ref[1]) <= 1e-4


# --- the GGN sweep through materialized rows -------------------------------------

@functools.lru_cache(maxsize=1)
def _fixture_twins():
    """The trained ``classifier_state`` fixture (tanh MLP 1×6, 2 classes) and
    its port twin, with the fixture's 2-blob points."""
    _, jstate, (x, _) = classifier_state()
    flat, _ = params_from_jax(jax.tree.map(np.asarray, jax.device_get(jstate.params)))
    return jstate, ModelState(SimpleClassifier(6, 1, 2, TOY_IN), flat, "classifier"), \
        np.asarray(x)


def test_ggn_matmat_materialized_matches_jax():
    jstate, pstate, x = _fixture_twins()
    V = np.random.default_rng(14).standard_normal((5, pstate.spec.num_params)).astype(np.float32)
    ref = jops.ggn_matmat_materialized(jstate, jnp.asarray(x[:6]), jnp.asarray(V),
                                       full_set_size=30)
    got = tops.ggn_matmat_materialized(pstate, torch.from_numpy(x[:6]), torch.from_numpy(V),
                                       full_set_size=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    R = tops.dense_wt(pstate, torch.from_numpy(x[:6]))
    torch.testing.assert_close(tops.ggn_matmat_materialized(pstate, torch.from_numpy(x[:6]),
                                                            torch.from_numpy(V), 30, R=R), got)


# --- the stochastic KL objective ---------------------------------------------------

# kind -> (M, |X|, alpha, full_set_size, st_samples, slq_samples, slq_num_matvecs):
# the toy at the sizes of tests/test_variational.py's gradient test, LeNet5 at
# full width with the shipped config's alpha and N and small M, batch and probes
CASES = {
    "classifier": (4, 8, 0.6, 16, 24, 2, 6),
    "lenet5": (2, 4, 0.005, 60000, 8, 2, 8),
}
VALUE_RTOL, GRAD_RTOL = 1e-4, 1e-3


def _case(kind):
    M, nx, alpha, N, st, slq, k = CASES[kind]
    if kind == "classifier":
        jstate, pstate, x = _fixture_twins()
        Z, X = x[:M], x[:nx]
    else:
        jstate, pstate, _ = make_twins("lenet5")
        Z, X = inputs("lenet5", M, seed=5), inputs("lenet5", nx, seed=6)
    knobs = dict(full_set_size=N, st_samples=st, slq_samples=slq, slq_num_matvecs=k)
    return jstate, pstate, Z, X, alpha, knobs


_JAX_KL = jax.jit(jax.value_and_grad(jind.kl_objective_stochastic),
                  static_argnames=("full_set_size", "st_samples", "slq_samples",
                                   "slq_num_matvecs"))


@pytest.mark.parametrize("kind", sorted(CASES))
def test_kl_objective_stochastic_value_and_grad_match_jax(kind):
    """The port's staged value and dL/dZ against
    ``jax.value_and_grad(kl_objective_stochastic)`` on the same probes."""
    jstate, pstate, Z, X, alpha, knobs = _case(kind)
    key = jax.random.PRNGKey(3)
    probes = _rademacher(3, knobs["st_samples"], pstate.spec.num_params)
    ref_v, ref_g = _JAX_KL(jnp.asarray(Z), jnp.asarray(X), jstate, alpha, key, **knobs)
    got_v, got_g = tind.kl_value_and_grad_stochastic(
        torch.from_numpy(Z), torch.from_numpy(X), pstate, alpha, torch.from_numpy(probes),
        **knobs)
    assert got_g.shape == Z.shape
    assert abs(float(got_v) - float(ref_v)) <= VALUE_RTOL * abs(float(ref_v))
    assert _rel(got_g.numpy(), ref_g) <= GRAD_RTOL


def test_monolithic_stochastic_autograd_equals_staged_gradient():
    """``kl_objective_stochastic`` is differentiable end to end, and its
    autograd gradient is the staged one (the same operations)."""
    _, pstate, Z, X, alpha, knobs = _case("classifier")
    probes = torch.from_numpy(_rademacher(7, knobs["st_samples"], pstate.spec.num_params))
    z = torch.from_numpy(Z).requires_grad_()
    value = tind.kl_objective_stochastic(z, torch.from_numpy(X), pstate, alpha, probes,
                                         **knobs)
    (grad,) = torch.autograd.grad(value, z)
    staged_v, staged_g = tind.kl_value_and_grad_stochastic(
        torch.from_numpy(Z), torch.from_numpy(X), pstate, alpha, probes, **knobs)
    torch.testing.assert_close(value.detach(), staged_v, rtol=1e-6, atol=0)
    torch.testing.assert_close(grad, staged_g, rtol=1e-5, atol=1e-6)


def test_stochastic_draws_probes_from_a_generator():
    _, pstate, Z, X, alpha, knobs = _case("classifier")
    args = (torch.from_numpy(Z), torch.from_numpy(X), pstate, alpha)
    D = pstate.spec.num_params
    a = tind.kl_objective_stochastic(*args, torch.Generator().manual_seed(5), **knobs)
    b = tind.kl_objective_stochastic(
        *args, tst.rademacher_probes(torch.Generator().manual_seed(5), knobs["st_samples"], D),
        **knobs)
    assert float(a) == float(b)
    with pytest.raises(ValueError, match="st_samples"):
        tind.kl_objective_stochastic(*args, torch.ones(3, D), **knobs)


def test_materialize_w_false_raises():
    """``materialize_w=False`` is the matfree objective now: on the same
    probes and a tight CG it gives the materialized value."""
    _, pstate, Z, X, alpha, knobs = _case("classifier")
    args = (torch.from_numpy(Z), torch.from_numpy(X), pstate, alpha)
    with torch.no_grad():
        probes = tst.rademacher_probes(torch.Generator().manual_seed(2), knobs["st_samples"],
                                       pstate.spec.num_params)
        free = tind.kl_objective_stochastic(*args, probes, materialize_w=False, cg_tol=1e-8,
                                            precond_rank=4, **knobs)
        mat = tind.kl_objective_stochastic(*args, probes, **knobs)
    assert float(free) == pytest.approx(float(mat), rel=1e-4)
    assert set(tind.OBJECTIVES) == {"dense", "gram", "gram_chunked", "stochastic",
                                    "stochastic_matfree"}


def test_optimize_step_stochastic_matches_jax():
    """One Adam step on Z with the same probes: the loss at the old Z and the
    step ``(Z_new − Z)/lr = g/(|g|+ε)``, compared as the gram twins compare
    it (elementwise atol 1e-2, relative L2 1e-4)."""
    jstate, pstate, Z, X, alpha, knobs = _case("classifier")
    lr, key = 0.05, jax.random.PRNGKey(4)
    probes = _rademacher(4, knobs["st_samples"], pstate.spec.num_params)
    opt = optax.adam(lr)
    new_ref, _, loss_ref = jind.optimize_step(
        jnp.asarray(Z), jnp.asarray(X), jstate, alpha, opt.init(jnp.asarray(Z)), key,
        objective="stochastic", optimizer=opt, **knobs)
    z = torch.from_numpy(Z.copy())
    loss = tind.optimize_step(z, torch.from_numpy(X), pstate, alpha, tind.make_optimizer(z, lr),
                              objective="stochastic", probes=torch.from_numpy(probes), **knobs)
    assert abs(float(loss) - float(loss_ref)) <= VALUE_RTOL * abs(float(loss_ref))
    u, u_ref = (z.numpy() - Z) / lr, (np.asarray(new_ref) - Z) / lr
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-2)
    assert _rel(u, u_ref) <= 1e-4
    with pytest.raises(ValueError, match="probes"):
        tind.optimize_step(z, torch.from_numpy(X), pstate, alpha, tind.make_optimizer(z, lr),
                           objective="stochastic", **knobs)


def test_train_inducing_points_stochastic_moves_z():
    _, pstate, Z, X, alpha, knobs = _case("classifier")
    losses = []
    batches = [(X, np.zeros(len(X)))] * 3
    out = tind.train_inducing_points(
        pstate, torch.from_numpy(Z), iter(batches), alpha=alpha, num_steps=3, lr=0.01,
        objective="stochastic", generator=torch.Generator().manual_seed(2),
        callback=lambda step, z, loss: losses.append(loss), **knobs)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert len(set(losses)) == 3              # fresh probes (and a new Z) each step
    assert float(torch.max(torch.abs(out - torch.from_numpy(Z)))) > 0


# --- the Lanczos sampler -------------------------------------------------------------

@pytest.mark.parametrize("eig_clip_min", [None, 1.0])
def test_lanczos_sampler_matches_jax(eig_clip_min):
    """The same ε through both packages' reference-parity sampler; the
    regressor's Gram has no null space, so the pseudo-inverse's rank mask
    cannot fall differently in the two. Its d = M = 5: the default depth 2M
    runs past Krylov breakdown, where both packages return NaN without the
    clip, so the depth is d."""
    jstate, pstate, _ = make_twins("regressor")
    Z = inputs("regressor", 5, seed=15)
    eps = np.random.default_rng(16).standard_normal((3, pstate.spec.num_params)).astype(np.float32)
    ref = jax.jit(jsample.make_inv_matsqrt_lanczos(jstate, jnp.asarray(Z), 0.5, 40,
                                                   num_matvecs=5,
                                                   eig_clip_min=eig_clip_min))(jnp.asarray(eps))
    with torch.no_grad():
        got = tsample.make_inv_matsqrt_lanczos(pstate, torch.from_numpy(Z), 0.5, 40,
                                               num_matvecs=5, eig_clip_min=eig_clip_min)(
            torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)
