"""Twin tests of the port's Nyström preconditioner (``ops/nystrom.py``)
against the JAX package's on the same start ``Ω``: the JAX sketch draws it
from ``jax.random.normal(key, (d, k))``, which the test hands to the port.

Tolerances: eigenvalues relative 1e-4 and eigenvector columns within 1e-4
of ±1 in alignment (the issue's contract for the sketch), on Grams whose
kept spectrum is well separated; the preconditioner's action relative 1e-5
on the same sketch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.ops import nystrom as jny
from laplace_inducing_points_tpu_torch.ops import nystrom as tny
from laplace_inducing_points_tpu_torch.ops.cg import cg_batched


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Toy-sized twins beside other test workers: one intra-op thread keeps
    them from oversubscribing the cores (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gram(seed: int, d: int, rank: int, zero_modes: int = 0) -> np.ndarray:
    """A PSD Gram with a front-loaded, well-separated spectrum (and exact
    zero modes), as a GGN Gram's."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.concatenate([np.logspace(2, 0, rank), np.full(d - rank - zero_modes, 1e-3),
                          np.zeros(zero_modes)])
    return ((Q * lam) @ Q.T).astype(np.float32)


def _omega(d: int, k: int, seed: int = 7) -> np.ndarray:
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (d, k), dtype=jnp.float32))


def _sketch_both(G: np.ndarray, k: int, power: int):
    d = G.shape[0]
    ref = jny.nystrom_sketch(lambda V: V @ jnp.asarray(G).T, d, k, jax.random.PRNGKey(7),
                             power=power)
    Gt = torch.from_numpy(G)
    got = tny.nystrom_sketch(lambda V: V @ Gt.T, d, k, torch.from_numpy(_omega(d, k)),
                             power=power)
    return [np.asarray(a) for a in ref], [t.numpy() for t in got]


def test_sketch_probe_block_matches_jax():
    for n_examples, n_probes in ((1024, 64), (4096, 64), (4096, 12), (128, 12), (100, 1000)):
        assert (tny.sketch_probe_block(n_examples, n_probes)
                == jny.sketch_probe_block(n_examples, n_probes))
    assert tny.sketch_probe_block(1024, 1 << 30) == 32


@pytest.mark.parametrize("power", [0, 1])
def test_nystrom_sketch_eigenpairs_match_jax(power):
    d, k = 48, 8
    (U_ref, lam_ref, good_ref), (U, lam, good) = _sketch_both(_gram(0, d, k), k, power)
    np.testing.assert_array_equal(good, good_ref)
    np.testing.assert_allclose(lam, lam_ref, rtol=1e-4)
    assert np.all(np.diff(lam) <= 0)                      # sorted descending
    align = np.abs(np.sum(U * U_ref, axis=0))             # columns up to sign
    np.testing.assert_allclose(align[good], 1.0, atol=1e-4)
    np.testing.assert_allclose(U.T @ U, np.eye(k), atol=1e-5)


def test_sketch_columns_stay_aligned_with_zero_modes():
    """Rank-deficient Gram with k beyond its rank: the zeroed columns sort
    last and every kept column keeps its eigenvalue (as in the reference)."""
    d, k = 40, 12
    (U_ref, lam_ref, good_ref), (U, lam, good) = _sketch_both(_gram(1, d, 6, zero_modes=30),
                                                              k, 0)
    np.testing.assert_array_equal(good, good_ref)
    kept = lam_ref > 1.0
    np.testing.assert_allclose(lam[kept], lam_ref[kept], rtol=1e-4)


@pytest.mark.parametrize("inv_sqrt", [False, True])
def test_preconditioner_action_matches_jax(inv_sqrt):
    """P⁻¹v and P^{-1/2}v from one stored sketch (the port's, handed to both)."""
    d, k, rho = 48, 8, 0.5
    G = _gram(2, d, k)
    Gt = torch.from_numpy(G)
    U, lam, good = tny.nystrom_sketch(lambda V: V @ Gt.T, d, k, torch.from_numpy(_omega(d, k)))
    v = np.random.default_rng(3).standard_normal((5, d)).astype(np.float32)
    port = tny.precond_inv_sqrt_from_sketch if inv_sqrt else tny.precond_from_sketch
    ref = jny.precond_inv_sqrt_from_sketch if inv_sqrt else jny.precond_from_sketch
    got = port(U, lam, good, rho)(torch.from_numpy(v)).numpy()
    want = np.asarray(ref(*(jnp.asarray(t.numpy()) for t in (U, lam, good)), rho)(
        jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if inv_sqrt:   # P^{-1/2} P^{-1/2} = P⁻¹
        half = port(U, lam, good, rho)
        full = tny.precond_from_sketch(U, lam, good, rho)
        x = torch.from_numpy(v)
        torch.testing.assert_close(half(half(x)), full(x), rtol=1e-5, atol=1e-5)


def test_preconditioner_deflates_and_speeds_up_cg():
    """P is SPD, the preconditioned operator's condition number falls by an
    order of magnitude or more, and CG on C = G + ρI needs fewer iterations."""
    d, k, rho = 64, 10, 0.1
    G = _gram(4, d, k)
    Gt = torch.from_numpy(G)
    C = Gt + rho * torch.eye(d)
    gen = torch.Generator().manual_seed(0)
    U, lam, good = tny.nystrom_sketch(lambda V: V @ Gt.T, d, k, gen)
    apply = tny.precond_from_sketch(U, lam, good, rho)
    Pinv = apply(torch.eye(d))
    ev = torch.linalg.eigvalsh(0.5 * (Pinv + Pinv.T))
    assert float(ev.min()) > 0
    half = tny.precond_inv_sqrt_from_sketch(U, lam, good, rho)(torch.eye(d))
    S = half @ C @ half
    kappa = torch.linalg.cond(C)
    assert float(torch.linalg.cond(0.5 * (S + S.T))) < 0.1 * float(kappa)
    B = torch.randn(3, d, generator=gen)
    _, plain = cg_batched(lambda V: V @ C.T, B, tol=1e-6)
    _, prec = cg_batched(lambda V: V @ C.T, B, tol=1e-6, precond=apply)
    assert prec.iterations < plain.iterations
