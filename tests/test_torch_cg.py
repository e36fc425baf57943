"""Twin tests of the port's batched CG (``ops/cg.py``) and of
``trace_of_inverse`` on it: values and implicit gradients against the JAX
package's ``cg_batched`` (``lax.custom_linear_solve``) and against a direct
solve in float64, on explicit SPD matrices built once in numpy.

Tolerances: relative 1e-4 (the issue's contract for the solve and its
gradient) at tol 1e-7 on matrices of condition 1e2, where the f32 attainable
residual is ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.ops import cg as jcg
from laplace_inducing_points_tpu.ops import stochtrace as jst
from laplace_inducing_points_tpu_torch.ops import cg as tcg
from laplace_inducing_points_tpu_torch.ops import stochtrace as tst

RTOL = 1e-4


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


def _spd(seed: int, d: int, cond: float = 100.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    A = (Q * np.logspace(0, np.log10(cond), d)) @ Q.T
    return (0.5 * (A + A.T)).astype(np.float32)


def _normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_cg_batched_matches_jax_and_a_direct_solve(precond):
    A, B = _spd(0, 24), _normal(1, 5, 24)
    inv_diag = (1.0 / np.diag(A)).astype(np.float32)
    ref = jcg.cg_batched(lambda X: X @ jnp.asarray(A).T, jnp.asarray(B), tol=1e-7, maxiter=400,
                         precond=(jcg.rowwise(lambda r: r * jnp.asarray(inv_diag))
                                  if precond == "jacobi" else None))
    At = torch.from_numpy(A)
    got, info = tcg.cg_batched(lambda X: X @ At.T, torch.from_numpy(B), tol=1e-7, maxiter=400,
                               precond=((lambda R: R * torch.from_numpy(inv_diag))
                                        if precond == "jacobi" else None))
    exact = np.linalg.solve(A.astype(np.float64), B.T.astype(np.float64)).T
    assert _rel(got.numpy(), np.asarray(ref)) <= RTOL
    assert _rel(got.numpy(), exact) <= RTOL
    assert 0 < info.iterations < 400 and info.rel_residual <= 1e-6


def test_cg_rows_stop_at_their_own_tolerance():
    """Rows of norms 1e-3, 1 and 1e3 each reach their relative tolerance: a
    shared stopping rule would let the large row mask the small one."""
    A = _spd(2, 16)
    B = _normal(3, 3, 16) * np.array([1e-3, 1.0, 1e3], dtype=np.float32)[:, None]
    At = torch.from_numpy(A)
    X, info = tcg.cg_batched(lambda V: V @ At.T, torch.from_numpy(B), tol=1e-6, maxiter=2000)
    res = (np.linalg.norm(X.numpy() @ A.T - B, axis=1) / np.linalg.norm(B, axis=1))
    assert np.all(res < 5e-5), res
    assert info.rel_residual <= 1e-6


def test_cg_info_reports_a_maxiter_exit():
    A, B = _spd(4, 32, cond=1e4), _normal(5, 2, 32)
    At = torch.from_numpy(A)
    X, info = tcg.cg_batched(lambda V: V @ At.T, torch.from_numpy(B), tol=1e-8, maxiter=3)
    ref = jcg.cg_batched(lambda V: V @ jnp.asarray(A).T, jnp.asarray(B), tol=1e-8, maxiter=3)
    assert info.iterations == 3 and info.rel_residual > 1e-3
    np.testing.assert_allclose(X.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)
    # the default budget is 10·d
    _, info = tcg.cg_batched(lambda V: V @ At.T, torch.from_numpy(B), tol=1e-12)
    assert info.iterations <= 320


def _operator(L: np.ndarray):
    """``A(L) = L Lᵀ + I`` from a factor ``L``: PSD, differentiable in ``L``."""
    return lambda Lm, lib: Lm @ Lm.T + lib.eye(Lm.shape[0], dtype=Lm.dtype)


def test_cg_implicit_gradient_matches_jax_and_the_direct_solve():
    """dL/dB and dL/dL for L = <W, A(L)⁻¹ B>: the implicit gradients against
    JAX's custom_linear_solve and against autograd through a float64 solve."""
    d, P = 12, 3
    Lf = (_normal(6, d, d) / np.sqrt(d)).astype(np.float32)
    B, W = _normal(7, P, d), _normal(8, P, d)
    make = _operator(Lf)

    def jax_loss(b, lm):
        A = make(lm, jnp)
        return jnp.sum(jnp.asarray(W) * jcg.cg_batched(lambda X: X @ A.T, b, tol=1e-8,
                                                        maxiter=400))

    ref_b, ref_l = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(B), jnp.asarray(Lf))

    b = torch.from_numpy(B).requires_grad_()
    lm = torch.from_numpy(Lf).requires_grad_()
    X, _ = tcg.cg_batched(lambda V: V @ make(lm, torch).T, b, tol=1e-8, maxiter=400,
                          operator_inputs=(lm,))
    got_b, got_l = torch.autograd.grad(torch.sum(torch.from_numpy(W) * X), (b, lm))

    b64 = torch.from_numpy(B).double().requires_grad_()
    l64 = torch.from_numpy(Lf).double().requires_grad_()
    X64 = torch.linalg.solve(make(l64, torch), b64.T).T
    ex_b, ex_l = torch.autograd.grad(torch.sum(torch.from_numpy(W).double() * X64), (b64, l64))

    assert _rel(got_b, np.asarray(ref_b)) <= RTOL and _rel(got_l, np.asarray(ref_l)) <= RTOL
    assert _rel(got_b, ex_b) <= RTOL and _rel(got_l, ex_l) <= RTOL


def test_cg_operator_gradient_needs_the_operator_inputs():
    """The operator's tensors reach the gradient only through
    ``operator_inputs``: a closure alone gives them none."""
    d = 8
    Lf, B = (_normal(9, d, d) / np.sqrt(d)).astype(np.float32), _normal(10, 2, d)
    make = _operator(Lf)
    lm = torch.from_numpy(Lf).requires_grad_()
    X, _ = tcg.cg_batched(lambda V: V @ make(lm, torch).T, torch.from_numpy(B), tol=1e-8)
    assert not X.requires_grad
    X, _ = tcg.cg_batched(lambda V: V @ make(lm, torch).T, torch.from_numpy(B), tol=1e-8,
                          operator_inputs=(lm,))
    (g,) = torch.autograd.grad(X.sum(), lm)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


ESTIMATORS = ["hutchpp", "hutchinson", "na_hutchpp"]


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_trace_of_inverse_matches_jax(estimator):
    """tr(A⁻¹) through batched CG, value and gradient in the operator, against
    JAX's trace_of_inverse on the same probes; hutchpp with a range finder
    of d probes or more is exact."""
    d = 20
    Lf = (_normal(11, d, d) / np.sqrt(d)).astype(np.float32)
    probes = np.array(jax.random.rademacher(jax.random.PRNGKey(3), (48, d),
                                              dtype=jnp.float32))
    make = _operator(Lf)

    def jax_fn(lm):
        A = make(lm, jnp)
        return jst.trace_of_inverse(lambda V: V @ A.T, jnp.asarray(probes), cg_tol=1e-8,
                                    estimator=estimator)

    ref_v, ref_g = jax.value_and_grad(jax_fn)(jnp.asarray(Lf))
    lm = torch.from_numpy(Lf).requires_grad_()
    got_v = tst.trace_of_inverse(lambda V: V @ make(lm, torch).T, torch.from_numpy(probes),
                                 cg_tol=1e-8, estimator=estimator, operator_inputs=(lm,))
    (got_g,) = torch.autograd.grad(got_v, lm)
    assert abs(float(got_v) - float(ref_v)) <= RTOL * abs(float(ref_v))
    assert _rel(got_g, np.asarray(ref_g)) <= 1e-3
    if estimator == "hutchpp":
        A64 = make(Lf.astype(np.float64), np)
        assert abs(float(got_v) - np.trace(np.linalg.inv(A64))) <= 1e-4 * float(got_v)
    with pytest.raises(ValueError, match="unknown estimator"):
        tst.trace_of_inverse(lambda V: V, torch.from_numpy(probes), estimator="nope")
