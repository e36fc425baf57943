"""Twin tests of the port's matfree slice: the matrix-free ``WFactor``
(against the reference's ``WFactor`` and ``BlockedWFactor``), the
``stochastic_matfree`` objective with its dL/dZ (whole, and route by route),
the Golub–Kahan recompute, the Matheron sampler both ways, the matfree
predictive, the CG healthcheck and the trainer.

Both packages get the same numpy inputs; probes, ε and η come from
``jax.random`` and are handed to the port (it cannot draw JAX's bits), as are
the Nyström starts. The toy classifier (tanh MLP 3×32, 3 classes,
D = 2,307) carries the objective; LeNet5 at full width (D = 61,706) the
operators at M ≤ 3. Tolerances, each with its reason:

* operator actions and their dL/dZ: relative 1e-5 (one jvp/vjp in f32, sums
  in another order);
* the objective at ``cg_tol`` 1e-8 and ``maxiter`` 10·d on both sides:
  value relative 1e-4, dL/dZ relative L2 1e-3 and cosine ≥ 0.9999 (Hutch++'s
  QR, the CG and Krylov recurrences, as the materialized twins');
* Matheron draws and predictive logits: relative L2 1e-4 (a solve of
  condition ~1e3 in f32).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.inference import lla as jlla
from laplace_inducing_points_tpu.inference import sample as jsample
from laplace_inducing_points_tpu.ops import cg as jcg
from laplace_inducing_points_tpu.ops import slq as jslq
from laplace_inducing_points_tpu.ops import stochtrace as jst
from laplace_inducing_points_tpu.training import inducing as jind
from laplace_inducing_points_tpu_torch.core import operators as tops
from laplace_inducing_points_tpu_torch.inference import lla as tlla
from laplace_inducing_points_tpu_torch.inference import sample as tsample
from laplace_inducing_points_tpu_torch.ops import cg as tcg
from laplace_inducing_points_tpu_torch.ops import lanczos as tlz
from laplace_inducing_points_tpu_torch.ops import stochtrace as tst
from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep
from laplace_inducing_points_tpu_torch.training import inducing as tind

from fixtures import classifier_state
from laplace_inducing_points_tpu_torch.core.params import params_from_jax
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier
from torch_twins import inputs, make_twins

ALPHA, N = 0.6, 24
KNOBS = dict(full_set_size=N, st_samples=16, slq_samples=2, slq_num_matvecs=6)
M_TOY, X_TOY, K_TOY = 5, 12, 3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Toy-sized twins beside other test workers: one intra-op thread keeps
    them from oversubscribing the cores (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cos(a, b) -> float:
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def toy():
    jstate, pstate, _ = make_twins("classifier")
    Z, X = inputs("classifier", M_TOY, seed=3), inputs("classifier", X_TOY, seed=4)
    key = jax.random.PRNGKey(3)
    probes = np.array(jst.rademacher_probes(key, KNOBS["st_samples"], pstate.spec.num_params))
    return jstate, pstate, Z, X, key, probes


# --- the matrix-free operators -------------------------------------------------

@pytest.mark.parametrize("kind,M", [("classifier", 5), ("lenet5", 3)])
def test_w_factor_actions_match_jax(kind, M):
    jstate, pstate, _ = make_twins(kind)
    Z = inputs(kind, M, seed=5)
    K = 3 if kind == "classifier" else 10
    D = pstate.spec.num_params
    v, U = _normal(6, D), _normal(7, M, K)
    V, UU, G = _normal(8, 3, D), _normal(9, 3, M, K), _normal(10, 3, M * K)
    jw = jops.make_w_factor(jstate, jnp.asarray(Z), full_set_size=4 * M)

    @jax.jit
    def jax_actions(v, U, V, UU, G):
        return {"t_matvec": jw.t_matvec(v), "matvec": jw.matvec(U), "t_matmat": jw.t_matmat(V),
                "matmat": jw.matmat(UU), "gram_matmat": jw.gram_matmat(G)}

    with torch.no_grad():
        tw = tops.make_w_factor(pstate, torch.from_numpy(Z), full_set_size=4 * M)
        got = {"t_matvec": tw.t_matvec(torch.from_numpy(v)),
               "matvec": tw.matvec(torch.from_numpy(U)),
               "t_matmat": tw.t_matmat(torch.from_numpy(V), block=2),
               "matmat": tw.matmat(torch.from_numpy(UU)),
               "gram_matmat": tw.gram_matmat(torch.from_numpy(G), block=2)}
    want = jax_actions(*(jnp.asarray(a) for a in (v, U, V, UU, G)))
    for name in got:
        assert _rel(got[name].numpy(), want[name]) <= 1e-5, name
    assert (tw.d, tw.inner_shape, tw.num_params) == (jw.d, jw.inner_shape, jw.num_params)


@pytest.mark.parametrize("block", [2, 4, 5])
def test_blocked_factor_matches_monolithic_and_jax(toy, block):
    """Blocks of 2 pad 5 points to 6 and blocks of 4 pad them to 8 (the
    padding contract), blocks of 5 are one; every action equals the
    one-block factor's and JAX's blocked one's."""
    jstate, pstate, Z, _, _, _ = toy
    D = pstate.spec.num_params
    v, U, G = _normal(11, D), _normal(12, M_TOY, K_TOY), _normal(13, 4, M_TOY * K_TOY)
    jb = jops.make_w_factor_blocked(jstate, jnp.asarray(Z), block, full_set_size=N)
    with torch.no_grad():
        tb = tops.make_w_factor(pstate, torch.from_numpy(Z), N, example_block=block)
        tm = tops.make_w_factor(pstate, torch.from_numpy(Z), full_set_size=N)
        for name, arg, ref in (("t_matvec", v, jb.t_matvec), ("matvec", U, jb.matvec),
                               ("gram_matmat", G, jb.gram_matmat),
                               ("t_matmat", _normal(40, 2, D), jb.t_matmat)):
            got = getattr(tb, name)(torch.from_numpy(arg))
            mono = getattr(tm, name)(torch.from_numpy(arg))
            assert _rel(got.numpy(), mono.numpy()) <= 1e-5, name
            assert _rel(got.numpy(), ref(jnp.asarray(arg))) <= 1e-5, name
    assert tb.pad == (-M_TOY) % block and tb.d == M_TOY * K_TOY


@pytest.mark.parametrize("blocked", [False, True])
def test_factor_dz_matches_jax(toy, blocked):
    """dL/dZ of <Y, gram_matmat(X)> + <u, Wᵀv> + <w, W U>: every action of the
    factor is differentiable in Z, as JAX's."""
    jstate, pstate, Z, _, _, _ = toy
    D, d = pstate.spec.num_params, M_TOY * K_TOY
    Xg, Yg, v, u = _normal(14, 3, d), _normal(15, 3, d), _normal(16, D), _normal(17, M_TOY, K_TOY)
    U, w = _normal(18, M_TOY, K_TOY), _normal(19, D)

    def jax_loss(z):
        f = (jops.make_w_factor_blocked(jstate, z, 2) if blocked
             else jops.make_w_factor(jstate, z))
        return (jnp.sum(jnp.asarray(Yg) * f.gram_matmat(jnp.asarray(Xg)))
                + jnp.sum(jnp.asarray(u) * f.t_matvec(jnp.asarray(v)))
                + jnp.sum(jnp.asarray(w) * f.matvec(jnp.asarray(U))))

    ref = jax.jit(jax.grad(jax_loss))(jnp.asarray(Z))
    z = torch.from_numpy(Z).requires_grad_()
    f = tops.make_w_factor(pstate, z, example_block=2 if blocked else None)
    loss = (torch.sum(torch.from_numpy(Yg) * f.gram_matmat(torch.from_numpy(Xg)))
            + torch.sum(torch.from_numpy(u) * f.t_matvec(torch.from_numpy(v)))
            + torch.sum(torch.from_numpy(w) * f.matvec(torch.from_numpy(U))))
    (got,) = torch.autograd.grad(loss, z)
    assert _rel(got.numpy(), ref) <= 1e-5


# --- the stochastic_matfree objective ------------------------------------------

@pytest.fixture(scope="module")
def jax_objective(toy):
    """JAX's stochastic_matfree value and dL/dZ at cg_tol 1e-8, maxiter 10·d,
    no preconditioner (one compile)."""
    jstate, _, Z, X, key, _ = toy
    fn = jax.jit(jax.value_and_grad(lambda z, x: jind.kl_objective_stochastic(
        z, x, jstate, ALPHA, key, materialize_w=False, cg_tol=1e-8,
        cg_maxiter=10 * M_TOY * K_TOY, precond_rank=None, **KNOBS)))
    value, grad = fn(jnp.asarray(Z), jnp.asarray(X))
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("variant", ["monolithic", "blocked_preconditioned"])
def test_matfree_objective_matches_jax(toy, jax_objective, variant):
    """Value (rtol 1e-4) and dL/dZ (relative L2 1e-3, cosine ≥ 0.9999) against
    JAX's; the preconditioner and the example blocks change the solve's path,
    not its fixed point."""
    _, pstate, Z, X, key, probes = toy
    extra = dict(precond_rank=None)
    if variant == "blocked_preconditioned":
        d, k = M_TOY * K_TOY, 4
        omega = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, 0x4E59),
                                                            (d, k), dtype=jnp.float32)))
        extra = dict(precond_rank=k, cg_example_block=2,
                     precond_sketch=tind.matfree_sketch(pstate, torch.from_numpy(Z), k, omega,
                                                        cg_example_block=2))
    value, grad = tind.kl_value_and_grad_matfree(
        torch.from_numpy(Z), torch.from_numpy(X), pstate, ALPHA, torch.from_numpy(probes),
        cg_tol=1e-8, cg_maxiter=10 * M_TOY * K_TOY, **extra, **KNOBS)
    ref_value, ref_grad = jax_objective
    assert abs(float(value) - ref_value) <= 1e-4 * abs(ref_value)
    assert _rel(grad.numpy(), ref_grad) <= 1e-3 and _cos(grad.numpy(), ref_grad) >= 0.9999


def test_matfree_objective_equals_the_materialized_one(toy):
    """Same probes, tight CG: the matfree objective equals the materialized
    (Cholesky-Woodbury) one in value and dL/dZ, and its OBJECTIVES entry is
    the same function."""
    _, pstate, Z, X, _, probes = toy
    z, x, p = torch.from_numpy(Z), torch.from_numpy(X), torch.from_numpy(probes)
    v_mat, g_mat = tind.kl_value_and_grad_stochastic(z, x, pstate, ALPHA, p, **KNOBS)
    v_free, g_free = tind.kl_value_and_grad_matfree(z, x, pstate, ALPHA, p, cg_tol=1e-8,
                                                    cg_maxiter=150, precond_rank=None, **KNOBS)
    with torch.no_grad():
        v_obj = tind.OBJECTIVES["stochastic_matfree"](z, x, pstate, ALPHA, p, cg_tol=1e-8,
                                                      cg_maxiter=150, precond_rank=None, **KNOBS)
    assert abs(float(v_free - v_mat)) <= 1e-4 * abs(float(v_mat))
    assert float(v_obj) == pytest.approx(float(v_free), rel=1e-6)
    assert _rel(g_free.numpy(), g_mat.numpy()) <= 1e-3


def _jax_routes(jstate, X, probes, key):
    """The matfree KL with Z split by route: the CG operator, U = WzᵀV,
    corr = Wz X and the SLQ operator each read their own copy of Z."""
    M, K, P, d = M_TOY, K_TOY, None, M_TOY * K_TOY
    rho, a_inv, beta = ALPHA / (N / M), 1.0 / ALPHA, N / M
    s_vp = jops.make_curvature_operator(jstate, jnp.asarray(X), ALPHA, full_set_size=N)

    def fn(z_cg, z_u, z_corr, z_slq):
        w_cg, w_u, w_corr = (jops.make_w_factor(jstate, z) for z in (z_cg, z_u, z_corr))
        w_slq = jops.make_w_factor(jstate, z_slq)

        def composite(V):
            P = V.shape[0]
            U = w_u.t_matmat(V).reshape(P, d)
            Xs = jcg.cg_batched(lambda Xm: w_cg.gram_matmat(Xm) + rho * Xm, U, tol=1e-8,
                                maxiter=10 * d)
            corr = w_corr.matmat(Xs.reshape(P, M, K))
            return jax.vmap(s_vp)(a_inv * V - a_inv * corr)

        trace = jst.hutchpp(composite, jnp.asarray(probes), s1=12, s2=4)
        D = probes.shape[1]

        def stacked(v):
            return jnp.concatenate([jnp.sqrt(ALPHA) * v,
                                    jnp.sqrt(beta) * w_slq.t_matvec(v).reshape(-1)])

        def stacked_t(w):
            return (jnp.sqrt(ALPHA) * w[:D]
                    + jnp.sqrt(beta) * w_slq.matvec(w[D:].reshape(M, K)))

        logdet = jslq.slq_logdet_product(stacked, jnp.asarray(probes[:2]), num_matvecs=6,
                                         t_matvec=stacked_t)
        return trace + logdet

    return jax.jit(jax.grad(fn, argnums=(0, 1, 2, 3)))


def test_matfree_dz_routes_match_jax(toy, jax_objective):
    """dL/dZ has four routes: the CG solve (implicitly), U = WzᵀV,
    corr = Wz X and the SLQ stacked operator. With each route reading its own
    copy of Z (the others turned off), each route's gradient matches JAX's,
    none vanishes, and they sum to the package's dL/dZ."""
    jstate, pstate, Z, X, key, probes = toy
    ref = _jax_routes(jstate, X, probes, key)(*(jnp.asarray(Z),) * 4)
    zs = [torch.from_numpy(Z.copy()).requires_grad_() for _ in range(4)]
    rho, a_inv, beta, gamma = ALPHA / (N / M_TOY), 1.0 / ALPHA, N / M_TOY, N / X_TOY
    w_cg, w_u, w_corr = (tops.make_w_factor(pstate, z) for z in zs[:3])
    with torch.no_grad():
        Rx = tops.dense_wt(pstate, torch.from_numpy(X))
    d = M_TOY * K_TOY

    def composite(V):
        P = V.shape[0]
        U = w_u.t_matmat(V).reshape(P, d)
        Xs, _ = tcg.cg_batched(lambda Xm: w_cg.gram_matmat(Xm) + rho * Xm, U, tol=1e-8,
                               maxiter=10 * d, operator_inputs=(zs[0],))
        W = a_inv * V - a_inv * w_corr.matmat(Xs.reshape(P, M_TOY, K_TOY))
        return ggn_sweep(W.contiguous(), Rx, gamma) + ALPHA * W

    p = torch.from_numpy(probes)
    loss = (tst.hutchpp(composite, p, s1=12, s2=4)
            + tind.matfree_logdet_term(zs[3], pstate, ALPHA, beta, p[:2], 6))
    got = torch.autograd.grad(loss, zs)
    total = sum(g.numpy() for g in got)
    for name, g, r in zip(("cg", "U", "corr", "slq"), got, ref):
        assert _rel(g.numpy(), r) <= 1e-3, name
        assert np.linalg.norm(g.numpy()) >= 1e-3 * np.linalg.norm(total), name
    assert _rel(total, jax_objective[1]) <= 1e-3


class _Shapes(TorchDispatchMode):
    """Every shape an operation outputs, forward and backward."""

    def __init__(self):
        super().__init__()
        self.shapes, self.ops = set(), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def test_matfree_objective_never_materializes_d_z_by_d(toy):
    """No (d_z, D), (D, d_z), (d_z, d_z) or (M, K, D) tensor anywhere in the
    value and dL/dZ of the matfree objective, its Nyström sketch included
    (the rank sits below d_z, as at production shapes)."""
    _, pstate, Z, X, _, probes = toy
    D, d = pstate.spec.num_params, M_TOY * K_TOY
    with _Shapes() as seen:
        loss, grad = tind.kl_value_and_grad_matfree(
            torch.from_numpy(Z), torch.from_numpy(X), pstate, ALPHA, torch.from_numpy(probes),
            cg_maxiter=20, precond_rank=4, cg_example_block=2, **KNOBS)
    banned = {(d, D), (D, d), (d, d), (M_TOY, K_TOY, D), (M_TOY, D, K_TOY)}
    assert seen.ops > 500 and torch.isfinite(grad).all()
    assert not banned & seen.shapes, banned & seen.shapes
    # the materialized objective does build them: the recorder sees them
    with _Shapes() as seen:
        tind.kl_value_and_grad_stochastic(torch.from_numpy(Z), torch.from_numpy(X), pstate,
                                          ALPHA, torch.from_numpy(probes), **KNOBS)
    assert banned & seen.shapes


def test_golub_kahan_recompute_equals_plain(toy):
    """golub_kahan_bidiag(remat_body=True) on the matrix-free stacked operator
    equals remat_body=False in value and in dL/dZ."""
    _, pstate, Z, _, _, probes = toy
    D, beta = pstate.spec.num_params, N / M_TOY
    out = {}
    for remat in (False, True):
        z = torch.from_numpy(Z).requires_grad_()
        w = tops.make_w_factor(pstate, z)

        def stacked(v):
            return torch.cat([ALPHA ** 0.5 * v, beta ** 0.5 * w.t_matvec(v).reshape(-1)])

        def stacked_t(u):
            return ALPHA ** 0.5 * u[:D] + beta ** 0.5 * w.matvec(u[D:].reshape(M_TOY, K_TOY))

        bi = tlz.golub_kahan_bidiag(stacked, torch.from_numpy(probes[0]), 6,
                                    t_matvec=stacked_t, remat_body=remat)
        value = torch.sum(bi.alphas ** 2) + torch.sum(bi.betas) + torch.sum(bi.right[-1])
        out[remat] = (bi, value, torch.autograd.grad(value, z)[0])
    (b0, v0, g0), (b1, v1, g1) = out[False], out[True]
    for a, b in zip(b0, b1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert float(v1) == pytest.approx(float(v0), rel=1e-6)
    torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-7)


# --- the Matheron sampler and the matfree predictive ---------------------------

@pytest.mark.parametrize("materialize_w", [True, False])
def test_matheron_sampler_matches_jax(toy, materialize_w):
    """The same ε, η through both packages' samplers; the matfree one at a
    tight tolerance, its rank-4 sketch from the same Ω, blocks of 2."""
    jstate, pstate, Z, _, _, _ = toy
    D, d, S = pstate.spec.num_params, M_TOY * K_TOY, 6
    eps, eta = _normal(30, S, D), _normal(31, S, d)
    cg = {} if materialize_w else dict(cg_tol=1e-8, cg_maxiter=300, precond_rank=4,
                                       cg_example_block=2)
    japply, jd = jsample.make_matheron_sampler(jstate, jnp.asarray(Z), ALPHA, N,
                                               materialize_w=materialize_w, **cg)
    ref, ref_res = jax.jit(lambda e, h: japply(e, h, with_info=True))(jnp.asarray(eps),
                                                                      jnp.asarray(eta))
    if not materialize_w:
        cg["precond_omega"] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(0x4E59), (d, 4), dtype=jnp.float32)))
    with torch.no_grad():
        apply, td = tsample.make_matheron_sampler(pstate, torch.from_numpy(Z), ALPHA, N,
                                                  materialize_w=materialize_w, **cg)
        got, res = apply(torch.from_numpy(eps), torch.from_numpy(eta), with_info=True)
        plain = apply(torch.from_numpy(eps), torch.from_numpy(eta))
    assert td == jd == d
    assert _rel(got.numpy(), ref) <= 1e-4
    torch.testing.assert_close(plain, got, rtol=0, atol=0)
    assert float(res) <= 1e-5 and float(ref_res) <= 1e-5


def test_sample_matheron_dispatches(toy):
    """sample(method="matheron") draws ε then η from the generator and runs
    the sampler; its draws have the posterior's covariance S⁻¹ in the mean
    of many (checked against the dense inverse square root)."""
    jstate, pstate, Z, _, _, _ = toy
    D, d = pstate.spec.num_params, M_TOY * K_TOY
    with torch.no_grad():
        draws = tsample.sample(pstate, torch.from_numpy(Z), ALPHA,
                               torch.Generator().manual_seed(4), num_samples=3,
                               full_set_size=N, method="matheron")
        gen = torch.Generator().manual_seed(4)
        eps, eta = torch.randn(3, D, generator=gen), torch.randn(3, d, generator=gen)
        apply, _ = tsample.make_matheron_sampler(pstate, torch.from_numpy(Z), ALPHA, N)
        torch.testing.assert_close(draws, apply(eps, eta), rtol=0, atol=0)
        # Matheron's rule: E[θθᵀ] = S⁻¹, so E[(aᵀθ)²] = aᵀS⁻¹a for any a
        gen = torch.Generator().manual_seed(5)
        many = apply(torch.randn(4000, D, generator=gen), torch.randn(4000, d, generator=gen))
        S = torch.from_numpy(np.array(jops.curvature_dense(jstate, jnp.asarray(Z), ALPHA,
                                                             N))).double()
        a = torch.from_numpy(_normal(32, D)).double()
        want = float(a @ torch.linalg.solve(S, a))
        assert float(torch.mean((many.double() @ a) ** 2)) == pytest.approx(want, rel=0.1)


def test_matfree_predictive_matches_jax(toy):
    """One evaluation batch: JAX's jitted matfree step (its ε, η drawn from the
    key, its sketch from PRNGKey(0x4E59)) against the port's on the same
    arrays."""
    jstate, pstate, Z, _, _, _ = toy
    D, d, S, rank = pstate.spec.num_params, M_TOY * K_TOY, 4, 4
    beta = N / M_TOY
    x = inputs("classifier", 7, seed=33)
    sk_key, key = jax.random.PRNGKey(0x4E59), jax.random.PRNGKey(11)
    nys = jlla._jitted_nystrom_sketch(jstate, jnp.asarray(Z), beta, rank, sk_key, power=1)
    ref, ref_res = jlla._matfree_logit_samples(jstate, jnp.asarray(Z), *nys, ALPHA, beta,
                                               jnp.asarray(x), key, S, 1e-8, 300)
    k1, k2 = jax.random.split(key)
    eps = np.array(jax.random.normal(k1, (S, D)))
    eta = np.array(jax.random.normal(k2, (S, d)))
    omega = torch.from_numpy(np.array(jax.random.normal(sk_key, (d, rank), dtype=jnp.float32)))
    with torch.no_grad():
        sketch = tind.matfree_sketch(pstate, torch.from_numpy(Z), rank, omega, power=1,
                                     scale=beta)
        got, res = tlla.matfree_logit_samples_from_noise(
            pstate, torch.from_numpy(Z), sketch, ALPHA, N, torch.from_numpy(x),
            torch.from_numpy(eps), torch.from_numpy(eta), 1e-8, 300, sample_block=3,
            example_block=2)
    np.testing.assert_allclose(sketch[1].numpy(), np.asarray(nys[1]), rtol=1e-4)
    assert got.shape == (S, 7, K_TOY)
    assert _rel(got.numpy(), ref) <= 1e-4
    assert float(res) <= 1e-5 and float(ref_res) <= 1e-5


def test_matfree_predictor_draws_and_warns_once_on_stall(toy):
    _, pstate, Z, _, _, _ = toy
    x = torch.from_numpy(inputs("classifier", 6, seed=34))
    with torch.no_grad():
        pred = tlla.ScalableLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N,
                                         method="matfree", precond_rank=4, cg_tol=1e-6)
        out = pred.logit_samples(x, ALPHA, torch.Generator().manual_seed(0), 5)
        assert out.shape == (5, 6, K_TOY) and torch.isfinite(out).all()
        assert pred.d == M_TOY * K_TOY and pred.nys[0].shape == (M_TOY * K_TOY, 4)
        assert pred.last_cg_residual <= 5e-6
        stalled = tlla.ScalableLLAPredictor(pstate, torch.from_numpy(Z), full_set_size=N,
                                            method="matfree", precond_rank=None,
                                            cg_tol=1e-8, cg_maxiter=1)
        with pytest.warns(UserWarning, match="maxiter"):
            stalled.logit_samples(x, ALPHA, torch.Generator().manual_seed(0), 5)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            stalled.logit_samples(x, ALPHA, torch.Generator().manual_seed(0), 5)
    with torch.no_grad():               # the cov predictor builds the same factor
        cov = tlla.ScalableLLAPredictor(pstate, torch.from_numpy(Z), method="cov")
        assert torch.isfinite(cov.logit_samples(x, ALPHA, torch.Generator().manual_seed(0),
                                                5)).all()


# --- healthcheck and trainer ---------------------------------------------------

def test_healthcheck_warns_on_a_maxiter_stall(toy):
    _, pstate, Z, _, _, _ = toy
    z = torch.from_numpy(Z)
    with pytest.warns(UserWarning, match="exiting on maxiter"):
        hc = tind.matfree_cg_healthcheck(pstate, z, ALPHA, full_set_size=N, cg_tol=1e-8,
                                         cg_maxiter=2, precond_rank=None)
    assert not hc["converged"] and hc["cg_iterations"] == 2 and hc["cg_rel_residual"] > 1e-3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hc = tind.matfree_cg_healthcheck(pstate, z, ALPHA, full_set_size=N, cg_tol=1e-5,
                                         precond_rank=4, cg_example_block=2)
    assert hc["converged"] and hc["cg_rel_residual"] <= 5e-5
    assert hc["kappa"] >= hc["kappa_deflated"] >= 1.0 and hc["lam_max"] > 0
    assert hc["predicted_iters"] > 0 and 0 < hc["cg_iterations"] <= 10 * M_TOY * K_TOY
    assert "MAXITER" not in tind.healthcheck_line(hc)


def test_matfree_trainer_descends_the_exact_kl(capsys):
    """The trainer on the matfree objective (the healthcheck before step 0, a
    fresh sketch each step) lowers the exact dense KL, as the JAX package's
    own test does from the same clearly bad init: the trained 2-blob
    classifier fixture, Z = the first 4 points + 1, Adam steps of 8e-2 (8
    with 32 probes here, 15 with 64 there)."""
    _, jstate, (x, _) = classifier_state()
    dense = jax.jit(lambda z: jops.curvature_dense(jstate, z, ALPHA, N))
    flat, _ = params_from_jax(jax.tree.map(np.asarray, jax.device_get(jstate.params)))
    pstate = ModelState(SimpleClassifier(6, 1, 2, 2), flat, "classifier")
    x = np.asarray(x)
    Z0, X = torch.from_numpy(x[:4] + 1.0), torch.from_numpy(x[:12])

    def dense_kl(Z):
        with torch.no_grad():
            S = torch.from_numpy(np.array(dense(jnp.asarray(X.detach().numpy())))).double()
            Sz = torch.from_numpy(np.array(dense(jnp.asarray(Z.detach().numpy())))).double()
            return float(torch.trace(torch.linalg.solve(Sz, S)) + torch.linalg.slogdet(Sz)[1])

    losses = []
    Z = tind.train_inducing_points(
        pstate, Z0, iter([(X, None)] * 8), alpha=ALPHA, num_steps=8, lr=8e-2,
        full_set_size=N, objective="stochastic_matfree",
        generator=torch.Generator().manual_seed(9), st_samples=32, slq_samples=2,
        slq_num_matvecs=6, precond_rank=4,
        callback=lambda s, z, loss: losses.append(loss))
    assert "matfree CG healthcheck" in capsys.readouterr().out
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert dense_kl(Z) < dense_kl(Z0) - 1.0
