"""Twin tests of the port's loss Hessians, linearization and row factor.

The rows of ``dense_wt`` are compared column by column in the shared flat
layout; rtol 1e-4 / atol 1e-6 allows for a different summation order in the
two frameworks' backward passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from laplace_inducing_points_tpu.core import loss_hessians as jlh
from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu_torch.core import loss_hessians as tlh
from laplace_inducing_points_tpu_torch.core import operators as tops

from torch_twins import inputs, make_twins

HESSIAN_FNS = ["sqrt_h_apply", "sqrt_h_t_apply", "h_apply", "h_dense"]


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
@pytest.mark.parametrize("fn", HESSIAN_FNS)
def test_loss_hessians_match_jax(fn, kind):
    rng = np.random.default_rng(0)
    K = 4 if kind == "classifier" else 1
    f = (3.0 * rng.standard_normal((6, K))).astype(np.float32)
    v = rng.standard_normal((6, K)).astype(np.float32)
    logvar = -0.7
    if fn == "h_dense":
        ref = getattr(jlh, fn)(kind, jnp.asarray(f), logvar)
        got = getattr(tlh, fn)(kind, torch.from_numpy(f), logvar)
    else:
        ref = getattr(jlh, fn)(kind, jnp.asarray(f), jnp.asarray(v), logvar)
        got = getattr(tlh, fn)(kind, torch.from_numpy(f), torch.from_numpy(v), logvar)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_loss_hessians_refuse_unknown_kind():
    with pytest.raises(ValueError, match="model_kind"):
        tlh.sqrt_h_apply("ranker", torch.zeros(2, 3), torch.zeros(2, 3))


@pytest.mark.parametrize("kind,M", [("classifier", 4), ("regressor", 4), ("lenet5", 2)])
def test_dense_wt_matches_jax(kind, M):
    jstate, pstate, _ = make_twins(kind)
    Z = inputs(kind, M, seed=5)
    ref = np.asarray(jops.dense_wt(jstate, jnp.asarray(Z), scale=1.5))
    with torch.no_grad():
        got = tops.dense_wt(pstate, torch.from_numpy(Z), scale=1.5).numpy()
    assert got.shape == ref.shape == (M * (10 if kind == "lenet5" else
                                           3 if kind == "classifier" else 1),
                                      pstate.spec.num_params)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_dense_wt_example_block_equals_one_sweep():
    _, pstate, _ = make_twins("classifier")
    Z = torch.from_numpy(inputs("classifier", 7, seed=2))
    with torch.no_grad():
        full = tops.dense_wt(pstate, Z)
        blocked = tops.dense_wt(pstate, Z, example_block=3)
    torch.testing.assert_close(blocked, full, rtol=0, atol=1e-7)


def test_linearization_matches_jax():
    jstate, pstate, _ = make_twins("classifier")
    X = inputs("classifier", 5, seed=3)
    rng = np.random.default_rng(4)
    V = rng.standard_normal((3, pstate.spec.num_params)).astype(np.float32)
    ct = rng.standard_normal((5, 3)).astype(np.float32)
    jlin = jops.linearize_model(jstate, jnp.asarray(X))
    with torch.no_grad():
        tlin = tops.linearize_model(pstate, torch.from_numpy(X))
        jv = vmap(tlin.jvp)(torch.from_numpy(V)).numpy()
        vj = tlin.vjp(torch.from_numpy(ct)).numpy()
    np.testing.assert_allclose(tlin.f0.numpy(), np.asarray(jlin.f0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jv, np.asarray(jax.vmap(jlin.jvp)(jnp.asarray(V))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vj, np.asarray(jlin.vjp(jnp.asarray(ct))),
                               rtol=1e-5, atol=1e-5)


def test_ensure_symmetry_and_pdot_match_jax():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((5, 5)).astype(np.float32)
    B = rng.standard_normal((5, 7)).astype(np.float32)
    np.testing.assert_allclose(tops.ensure_symmetry(torch.from_numpy(A)).numpy(),
                               np.asarray(jops.ensure_symmetry(jnp.asarray(A))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tops.pdot(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
                               np.asarray(jops.pdot(jnp.asarray(A), jnp.asarray(B))),
                               rtol=1e-5, atol=1e-6)
