"""Twin tests of the ``gram_chunked`` objective: ``kl_grad_gram_chunked``, and
``optimize_step(objective="gram_chunked")`` against the JAX package's
``optimize_step_chunked``, at M = 6 with chunk 4
(the reference pads the last chunk, the port runs it ragged), and the port's
``gram_chunked`` against its ``gram``.

Tolerances are the gram twins' (``tests/test_torch_training.py``): the KL
value relative 2e-5 and dL/dZ relative L2 1e-4 for the toy MLPs, the Adam
step ``(Z_new − Z)/lr`` elementwise 1e-2 and relative L2 1e-4; the port's two
objectives run the same operations and agree to round-off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_inducing_points_tpu.training import inducing as jind
from laplace_inducing_points_tpu_torch.training import inducing as tind

from torch_twins import inputs, make_twins

M, NX, ALPHA, N, CHUNK = 6, 9, 0.5, 100, 4


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def _case(kind):
    jstate, pstate, _ = make_twins(kind)
    return jstate, pstate, inputs(kind, M, seed=5), inputs(kind, NX, seed=6)


@pytest.mark.parametrize("include_constants", [True, False])
@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_kl_grad_gram_chunked_matches_jax(kind, include_constants):
    jstate, pstate, Z, X = _case(kind)
    ref_v, ref_g = jind.kl_grad_gram_chunked(
        jnp.asarray(Z), jnp.asarray(X), jstate, ALPHA, full_set_size=N, chunk=CHUNK,
        include_constants=include_constants)
    got_v, got_g = tind.kl_grad_gram_chunked(
        torch.from_numpy(Z), torch.from_numpy(X), pstate, ALPHA, full_set_size=N,
        chunk=CHUNK, include_constants=include_constants)
    assert got_g.shape == Z.shape
    assert abs(float(got_v) - float(ref_v)) <= 2e-5 * abs(float(ref_v))
    assert _rel(got_g.numpy(), ref_g) <= 1e-4


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_optimize_step_chunked_matches_jax(kind):
    """One Adam step on Z with the chunk from ``example_block``."""
    jstate, pstate, Z, X = _case(kind)
    lr = 0.01
    opt = optax.adam(lr)
    new_ref, _, loss_ref = jind.optimize_step_chunked(
        jnp.asarray(Z), jnp.asarray(X), jstate, ALPHA, opt.init(jnp.asarray(Z)),
        jax.random.PRNGKey(0), optimizer=opt, full_set_size=N, example_block=CHUNK)
    z = torch.from_numpy(Z.copy())
    loss = tind.optimize_step(z, torch.from_numpy(X), pstate, ALPHA, tind.make_optimizer(z, lr),
                              objective="gram_chunked", full_set_size=N,
                              example_block=CHUNK)
    assert abs(float(loss) - float(loss_ref)) <= 2e-5 * abs(float(loss_ref))
    u, u_ref = (z.numpy() - Z) / lr, (np.asarray(new_ref) - Z) / lr
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-2)
    assert _rel(u, u_ref) <= 1e-4


def test_gram_chunked_trains_as_gram():
    """Three steps of the trainer on ``gram_chunked`` (default chunk 4) and on
    ``gram`` (one block) from the same Z: the same losses and Z."""
    _, pstate, Z, _ = _case("classifier")
    batches = [(inputs("classifier", NX, seed=20 + i), np.zeros(NX)) for i in range(3)]
    runs = {}
    for objective in ("gram_chunked", "gram"):
        losses = []
        z = tind.train_inducing_points(pstate, torch.from_numpy(Z), iter(batches), alpha=ALPHA,
                                       num_steps=3, lr=0.01, full_set_size=N,
                                       objective=objective,
                                       callback=lambda s, _z, loss: losses.append(loss))
        runs[objective] = (z, losses)
    np.testing.assert_allclose(runs["gram_chunked"][1], runs["gram"][1], rtol=1e-6)
    torch.testing.assert_close(runs["gram_chunked"][0], runs["gram"][0], rtol=1e-5, atol=1e-6)
    assert tind.OBJECTIVES["gram_chunked"] is tind.kl_objective_gram
