"""Twin tests of the port's training half: the gram KL and its dL/dZ, the row
pullback, one Adam step on Z, the Z trainer's divergence guard and
checkpoints, and MAP training (loss, one step, the cosine schedule).

The JAX package and the port get the same numpy inputs (weights through
``params_from_jax``, points, batches). Tolerances, each with its reason:

* KL value: relative 2e-5 for the toy MLPs, 1e-4 for LeNet5 — f32 sums in
  another order, in a value that is a difference of terms up to ~10⁷;
* dL/dZ and Adam steps: relative L2 1e-4 for the toys, 1e-3 for LeNet5 — the
  f32 Cholesky of the Gram amplifies the summation-order differences by its
  condition number;
* the row pullback: relative L2 1e-5 (second-order autodiff in another order);
* Adam's first step divided by the learning rate is ``u = g/(|g|+ε)``; a
  relative difference δ in one gradient element moves it by at most δ/4, and
  δ reaches 1e-2 in f32 for the elements 10⁵ below the largest ones of a
  LeNet5 weight gradient: ``u`` atol 1e-2 elementwise, relative L2 1e-4 as a
  whole. MAP loss rtol 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.data import loader as jloader
from laplace_inducing_points_tpu.training import inducing as jind
from laplace_inducing_points_tpu.training import map as jmap
from laplace_inducing_points_tpu.utils import checkpoint as jckpt
from laplace_inducing_points_tpu_torch.core import operators as tops
from laplace_inducing_points_tpu_torch.data import scale as tscale
from laplace_inducing_points_tpu_torch.data.loader import (ArrayDataset, DataLoader,
                                                           cycling_batches)
from laplace_inducing_points_tpu_torch.training import inducing as tind
from laplace_inducing_points_tpu_torch.training import map as tmap
from laplace_inducing_points_tpu_torch.utils import checkpoint as tckpt

from torch_twins import inputs, make_twins

# kind -> (M, |X|, alpha, full_set_size); LeNet5 at the shipped config's alpha
# and N, at M = 2 and a batch of 4
CASES = {
    "classifier": (5, 12, 0.5, 100),
    "regressor": (4, 9, 0.3, 50),
    "lenet5": (2, 4, 0.005, 60000),
}
VALUE_RTOL = {"classifier": 2e-5, "regressor": 2e-5, "lenet5": 1e-4}
GRAD_RTOL = {"classifier": 1e-4, "regressor": 1e-4, "lenet5": 1e-3}


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def _case(kind):
    M, nx, alpha, N = CASES[kind]
    jstate, pstate, _ = make_twins(kind)
    return jstate, pstate, inputs(kind, M, seed=5), inputs(kind, nx, seed=6), alpha, N


@pytest.mark.parametrize("include_constants", [True, False])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_kl_objective_gram_value_and_grad_match_jax(kind, include_constants):
    """The staged value and dL/dZ of the port against
    ``jax.value_and_grad(kl_objective_gram)``; with the loss-Hessian factor
    evaluated at a detached f0 the gradient would be off by far more."""
    jstate, pstate, Z, X, alpha, N = _case(kind)
    ref_v, ref_g = jax.value_and_grad(jind.kl_objective_gram)(
        jnp.asarray(Z), jnp.asarray(X), jstate, alpha, full_set_size=N,
        include_constants=include_constants)
    got_v, got_g = tind.kl_value_and_grad_gram(
        torch.from_numpy(Z), torch.from_numpy(X), pstate, alpha, full_set_size=N,
        include_constants=include_constants)
    assert got_g.shape == Z.shape
    assert abs(float(got_v) - float(ref_v)) <= VALUE_RTOL[kind] * abs(float(ref_v))
    assert _rel(got_g.numpy(), ref_g) <= GRAD_RTOL[kind]


@pytest.mark.parametrize("kind", ["classifier", "lenet5"])
def test_monolithic_autograd_equals_staged_gradient(kind):
    """``kl_objective_gram`` is differentiable end to end, and its autograd
    gradient is the staged one (the same operations)."""
    _, pstate, Z, X, alpha, N = _case(kind)
    z = torch.from_numpy(Z).requires_grad_()
    value = tind.kl_objective_gram(z, torch.from_numpy(X), pstate, alpha, full_set_size=N)
    (grad,) = torch.autograd.grad(value, z)
    staged_v, staged_g = tind.kl_value_and_grad_gram(
        torch.from_numpy(Z), torch.from_numpy(X), pstate, alpha, full_set_size=N)
    torch.testing.assert_close(value.detach(), staged_v, rtol=1e-6, atol=0)
    torch.testing.assert_close(grad, staged_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_row_pullback_matches_jax_vjp(kind):
    jstate, pstate, Z, _, _, _ = _case(kind)
    R, pull = jax.vjp(lambda z: jops.dense_wt(jstate, z), jnp.asarray(Z))
    ct = np.random.default_rng(3).standard_normal(R.shape).astype(np.float32)
    (ref,) = pull(jnp.asarray(ct))
    got = tops.dense_wt_pullback(pstate, torch.from_numpy(Z), torch.from_numpy(ct))
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("example_block", [1, 2, 3])
def test_chunked_pullback_equals_one_chunk(example_block):
    _, pstate, _ = make_twins("classifier")
    Z = torch.from_numpy(inputs("classifier", 7, seed=2))
    ct = torch.randn(7 * 3, pstate.spec.num_params, generator=torch.Generator().manual_seed(0))
    one = tops.dense_wt_pullback(pstate, Z, ct)
    chunked = tops.dense_wt_pullback(pstate, Z, ct, example_block=example_block)
    torch.testing.assert_close(chunked, one, rtol=1e-5, atol=1e-6)


def test_chunked_pullback_equals_one_chunk_lenet5():
    _, pstate, _ = make_twins("lenet5")
    Z = torch.from_numpy(inputs("lenet5", 3, seed=2))
    ct = torch.randn(30, pstate.spec.num_params, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(tops.dense_wt_pullback(pstate, Z, ct, example_block=2),
                               tops.dense_wt_pullback(pstate, Z, ct), rtol=1e-5, atol=1e-7)


def test_dense_wt_scale_does_not_touch_the_tape():
    """Scaling the rows is out of place, so the scaled rows stay differentiable."""
    _, pstate, _ = make_twins("classifier")
    z = torch.from_numpy(inputs("classifier", 3, seed=4)).requires_grad_()
    (g2,) = torch.autograd.grad(tops.dense_wt(pstate, z, scale=2.0).sum(), z)
    (g1,) = torch.autograd.grad(tops.dense_wt(pstate, z).sum(), z)
    torch.testing.assert_close(g2, 2.0 * g1, rtol=1e-6, atol=1e-6)


def test_kl_core_and_pivot_jitter_match_jax():
    rng = np.random.default_rng(7)
    Rz = rng.standard_normal((6, 40)).astype(np.float32)
    Rx = rng.standard_normal((9, 40)).astype(np.float32)
    Gzz, Gxz = Rz @ Rz.T, Rx @ Rz.T
    np.testing.assert_allclose(float(tind._pivot_jitter(torch.from_numpy(Gzz))),
                               float(jind._pivot_jitter(jnp.asarray(Gzz))), rtol=1e-6)
    args = (40, 0.2, 3.0, 5.0)
    ref = jind._kl_core(jnp.asarray(Gzz), jnp.asarray(Gxz), jnp.asarray(np.sum(Rx * Rx)),
                        *args)
    got = tind._kl_core(torch.from_numpy(Gzz), torch.from_numpy(Gxz),
                        torch.tensor(np.sum(Rx * Rx)), *args)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_failed_cholesky_gives_a_nan_loss_not_an_exception():
    """Where the Gram algebra is not positive definite the reference's loss is
    NaN (its Cholesky returns NaN); the port's must be too, for the guard."""
    Gzz = -np.eye(4, dtype=np.float32)
    Gxz = np.ones((3, 4), dtype=np.float32)
    ref = jind._kl_core(jnp.asarray(Gzz), jnp.asarray(Gxz), 1.0, 10, 0.1, 1.0, 1.0)
    got = tind._kl_core(torch.from_numpy(Gzz), torch.from_numpy(Gxz), torch.tensor(1.0),
                        10, 0.1, 1.0, 1.0)
    assert math.isnan(float(ref)) and math.isnan(float(got))


def _assert_adam_steps_agree(u, u_ref):
    """First Adam steps over the learning rate, ``g/(|g|+ε)`` (module note)."""
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-2)
    assert _rel(u, u_ref) <= 1e-4


@pytest.mark.parametrize("kind", ["classifier", "lenet5"])
def test_optimize_step_matches_jax(kind):
    """One Adam step on Z: the loss at the old Z and the new Z."""
    jstate, pstate, Z, X, alpha, N = _case(kind)
    lr = 0.008
    opt = optax.adam(lr)
    new_ref, _, loss_ref = jind.optimize_step(
        jnp.asarray(Z), jnp.asarray(X), jstate, alpha, opt.init(jnp.asarray(Z)),
        jax.random.PRNGKey(0), optimizer=opt, full_set_size=N)
    z = torch.from_numpy(Z.copy())
    loss = tind.optimize_step(z, torch.from_numpy(X), pstate, alpha,
                              tind.make_optimizer(z, lr), full_set_size=N)
    assert abs(float(loss) - float(loss_ref)) <= VALUE_RTOL[kind] * abs(float(loss_ref))
    _assert_adam_steps_agree((z.numpy() - Z) / lr, (np.asarray(new_ref) - Z) / lr)


def test_full_set_kl_matches_jax():
    jstate, pstate, Z, X, alpha, N = _case("classifier")
    ref = float(jind.full_set_kl(jnp.asarray(Z), jnp.asarray(X), jstate, alpha, N))
    got = tind.full_set_kl(torch.from_numpy(Z), torch.from_numpy(X), pstate, alpha, N)
    assert abs(got - ref) <= VALUE_RTOL["classifier"] * abs(ref)


def _batches(kind, n, size, seed=10):
    return [(inputs(kind, size, seed=seed + i), np.zeros(size)) for i in range(n)]


def test_train_inducing_points_keeps_the_last_finite_z():
    """A batch with a NaN makes the loss NaN: the trainer stops and returns
    the Z of the last step that passed its check, never a NaN Z."""
    _, pstate, Z, _, alpha, N = _case("classifier")
    batches = _batches("classifier", 4, 8)
    batches[2] = (np.full_like(batches[2][0], np.nan), batches[2][1])
    seen = []
    out = tind.train_inducing_points(
        pstate, torch.from_numpy(Z), iter(batches), alpha=alpha, num_steps=4, lr=0.01,
        full_set_size=N, callback=lambda step, z, loss: seen.append((step, z.clone())))
    assert [s for s, _ in seen] == [0, 1]
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, seen[-1][1], rtol=0, atol=0)
    assert not torch.equal(out, torch.from_numpy(Z))


def test_train_inducing_points_moves_z_and_writes_checkpoints(tmp_path):
    _, pstate, Z, _, alpha, N = _case("classifier")
    losses = []
    out = tind.train_inducing_points(
        pstate, torch.from_numpy(Z), cycling_batches(_batches("classifier", 2, 8)),
        alpha=alpha, num_steps=5, lr=0.01, full_set_size=N, example_block=2,
        callback=lambda step, z, loss: losses.append(loss),
        checkpoint_dir=str(tmp_path), checkpoint_name="ind", checkpoint_every=2)
    assert len(losses) == 5 and all(math.isfinite(v) for v in losses)
    assert float(torch.max(torch.abs(out - torch.from_numpy(Z)))) > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ind_2.npz", "ind_4.npz"]
    np.testing.assert_array_equal(jckpt.load_array(str(tmp_path), "ind", 2).shape, Z.shape)


# --- MAP ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["classifier", "lenet5"])
def test_map_step_matches_jax(kind):
    jstate, pstate, _ = make_twins(kind)
    rng = np.random.default_rng(8)
    x = inputs(kind, 16, seed=9)
    y = rng.integers(0, 10 if kind == "lenet5" else 3, 16).astype(np.int32)
    lr, alpha = 1e-3, 0.005
    jstate = jstate.replace(tx=optax.adam(lr), opt_state=optax.adam(lr).init(jstate.params))
    new_jstate, loss_ref = jmap.map_step(jstate, (jnp.asarray(x), jnp.asarray(y)), alpha)
    ref_flat = jops.flatten_nn_params(new_jstate.params)[0]
    flat = pstate.flat_params.clone().requires_grad_()
    loss = tmap.map_step(pstate, flat, torch.optim.Adam([flat], lr=lr, eps=1e-8),
                         (x, y), alpha)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    before = pstate.flat_params.numpy()
    _assert_adam_steps_agree((flat.detach().numpy() - before) / lr,
                             (np.asarray(ref_flat) - before) / lr)


def test_l2_prior_and_eval_match_jax():
    jstate, pstate, _ = make_twins("lenet5")
    ref = float(jmap.l2_prior(jstate.params, 0.3, 0.7))
    got = float(tmap.l2_prior(pstate, pstate.flat_params, 0.3, 0.7))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    x = inputs("lenet5", 8, seed=3)
    y = np.arange(8, dtype=np.int32)
    ref_nll, ref_acc = jmap.eval_classification(jstate, (jnp.asarray(x), jnp.asarray(y)))
    nll, acc = tmap.eval_classification(pstate, (x, y))
    np.testing.assert_allclose(nll, float(ref_nll), rtol=1e-5)
    assert acc == float(ref_acc)


@pytest.mark.parametrize("init,epochs,steps,fraction", [
    (5e-4, 150, 31, 0.08), (1e-3, 3, 7, 0.08), (0.1, 1, 1, 0.5)])
def test_cosine_lr_matches_optax(init, epochs, steps, fraction):
    ref = jmap.cosine_lr(init, epochs, steps, fraction)
    got = tmap.cosine_lr(init, epochs, steps, fraction)
    for count in list(range(0, epochs * steps + 3, max(1, epochs * steps // 50))) + \
            [epochs * steps, epochs * steps + 10]:
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6)


def test_train_map_lowers_the_loss_and_keeps_the_state_apart():
    _, pstate, _ = make_twins("classifier")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 2)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    loader = DataLoader(ArrayDataset(x, y), 16, shuffle=True)
    losses = []
    before = pstate.flat_params.clone()
    trained = tmap.train_map(pstate, loader, loader, num_epochs=5, alpha=1e-3,
                             lr=tmap.cosine_lr(0.01, 5, len(loader)),
                             callback=lambda step, loss: losses.append(float(loss)))
    assert len(losses) == 5 * len(loader)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert not trained.flat_params.requires_grad
    torch.testing.assert_close(pstate.flat_params, before, rtol=0, atol=0)



# --- data and checkpoints ----------------------------------------------------

def test_cycling_batches_restarts_like_jax():
    ds = ArrayDataset(np.arange(10, dtype=np.float32)[:, None], np.arange(10))
    loader = DataLoader(ds, 4)                       # 2 full batches per pass
    got, ref = cycling_batches(loader), jloader.cycling_batches(loader)
    for first in [0, 4, 0, 4, 0]:
        x, y = next(got)
        x_ref, y_ref = next(ref)
        assert y[0] == first
        np.testing.assert_array_equal(x, np.asarray(x_ref))
        np.testing.assert_array_equal(y, np.asarray(y_ref))
    with pytest.raises(ValueError, match="no batch"):
        next(cycling_batches(DataLoader(ds, 16)))     # drop_last: no full batch


def test_get_dataloaders_augmentation(tmp_path):
    """Train-time augmentation is CIFAR-10's only, as in the reference."""
    train, _, _ = tscale.get_dataloaders("mnist", 64, aug=True, root=str(tmp_path))
    assert len(train) == 8029 // 64 and not isinstance(train, tscale.AugmentedLoader)
    cifar, _, _ = tscale.get_dataloaders("cifar10", 64, aug=True, root=str(tmp_path))
    assert isinstance(cifar, tscale.AugmentedLoader) and len(cifar) == 8029 // 64


def test_run_meta_reads_in_both_packages(tmp_path):
    meta = {"alpha_ip": 0.005, "alpha_src": "cli", "objective": "gram"}
    tckpt.save_run_meta(str(tmp_path), "ind_mnist", meta)
    assert jckpt.load_run_meta(str(tmp_path), "ind_mnist") == meta
    assert tckpt.load_run_meta(str(tmp_path), "ind_mnist") == meta
