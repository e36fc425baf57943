"""Twin tests of the port's toy data and the regressor's MAP.

The JAX package writes the toy datasets with ``jax.random``; the port reads
the committed files (``data/fixtures/toy``). Tolerances, each with its
reason:

* the fixtures against ``ensure_toy_npz``'s arrays and the split: bitwise
  (the same bytes);
* the loader's batches: bitwise (the same splitmix64 shuffle);
* the regressor's MAP loss and gradient: relative 1e-5 (f32 sums in another
  order);
* three Adam steps of the regressor, ``logvar`` included: relative 1e-5 on
  the weights after the steps (an Adam step moves a weight by at most the
  learning rate, and the f32 gradients agree to ~1e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from laplace_inducing_points_tpu.data import loader as jloader
from laplace_inducing_points_tpu.data import toy as jtoy
from laplace_inducing_points_tpu.training import map as jmap
from laplace_inducing_points_tpu_torch.core.params import logvar_from_jax
from laplace_inducing_points_tpu_torch.data import toy as ttoy
from laplace_inducing_points_tpu_torch.data.loader import ArrayDataset, make_dataloaders
from laplace_inducing_points_tpu_torch.training import map as tmap
from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config

from torch_twins import make_twins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> the ensure_toy_npz arguments the fixture was written with
FIXTURES = {
    "banana": ("banana", "classifier_banana.yml", {}),
    "xor": ("xor", "classifier_xor.yml", {}),
    "spiral": ("spiral", "classifier_spiral.yml", {}),
    "sine": ("sine", "regressor_sine.yml", {}),
    "ring_r2": ("ring", None, {"radius": 2.0, "fname": "ring_r2"}),
    "ring_r1p05": ("ring", None, {"radius": 1.05, "fname": "ring_r1p05"}),
}


def _gen_args(config, extra):
    data = {}
    if config is not None:
        data = dict(load_experiment_config(
            os.path.join(REPO, "configs", "toy", config)).get("data") or {})
    data.update(extra)
    return dict(n=data.pop("n", 512), noise=data.pop("noise", 0.05), seed=data.pop("seed", 42),
                **data)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_fixture_reader_matches_ensure_toy_npz(fixture, tmp_path):
    """The committed file the port resolves holds exactly the arrays the JAX
    package generates at those parameters."""
    name, config, extra = FIXTURES[fixture]
    args = _gen_args(config, extra)
    ref = jtoy.load_dataset(jtoy.ensure_toy_npz(name, data_dir=str(tmp_path), **args))
    path = ttoy.ensure_toy_npz(name, data_dir=str(tmp_path / "none"), **args)
    assert os.path.dirname(path) == str(ttoy.FIXTURE_DIR)
    got = ttoy.load_dataset(path)
    for a, b in zip(got, ref):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_stale_or_missing_fixture_raises_naming_the_jax_command(tmp_path):
    args = _gen_args("classifier_banana.yml", {})
    with pytest.raises(FileNotFoundError, match="laplace_inducing_points_tpu.cli.make_data"):
        ttoy.ensure_toy_npz("banana", data_dir=str(tmp_path), **{**args, "n": 499})
    with pytest.raises(FileNotFoundError, match="gen_kwargs"):
        ttoy.ensure_toy_npz("banana", data_dir=str(tmp_path), **args, shuffle=True)
    # a fresh file in data_dir wins over the fixture
    jpath = jtoy.ensure_toy_npz("xor", data_dir=str(tmp_path), n=40, noise=0.1, seed=3)
    assert ttoy.ensure_toy_npz("xor", data_dir=str(tmp_path), n=40, noise=0.1, seed=3) == jpath
    assert ttoy.ring_cache_fname(1.05) == jtoy.ring_cache_fname(1.05) == "ring_r1p05"


@pytest.mark.parametrize("n", [10, 500, 1280])
def test_train_test_val_split_matches_jax(n):
    x = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
    y = np.arange(n) % 2
    for got, ref in zip(ttoy.train_test_val_split(x, y), jtoy.train_test_val_split(x, y)):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("restart", [0, 1, 2])
def test_loader_order_matches_jax_under_map_restart_seeds(restart):
    """``main_toy --map_restarts`` candidate i shuffles with seed
    ``map.seed + 7919·i``: both packages' loaders give the same batches over
    two epochs."""
    x, y = ttoy.load_dataset(str(ttoy.FIXTURE_DIR / "banana.npz"))
    tr, te, va = ttoy.train_test_val_split(x, y)
    seed = (1278316 + restart * 7919) % 2**31
    got = make_dataloaders(ArrayDataset(*tr), ArrayDataset(*te), ArrayDataset(*va), 32,
                           seed=seed)[0]
    ref = jloader.make_dataloaders(jloader.ArrayDataset(*tr), jloader.ArrayDataset(*te),
                                   jloader.ArrayDataset(*va), 32, seed=seed)[0]
    for _ in range(2):
        batches, ref_batches = list(got), list(ref)
        assert len(batches) == len(ref_batches) == 12
        for (xb, yb), (xr, yr) in zip(batches, ref_batches):
            np.testing.assert_array_equal(xb, np.asarray(xr))
            np.testing.assert_array_equal(yb, np.asarray(yr))


def _sine_batch(seed=3, n=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    y = (np.sin(x) + 0.3 * rng.standard_normal((n, 1))).astype(np.float32)
    return x, y


def _flat_and_logvar(params):
    nn = {k: v for k, v in params.items() if k != "logvar"}
    return np.asarray(ravel_pytree(nn)[0]), float(params["logvar"])


def test_regressor_map_loss_and_gradient_match_jax():
    """The Gaussian NLL with the learned logvar and the L2 prior (kernels and
    logvar at α, biases free): value and gradient in the weights and in
    logvar."""
    jstate, pstate, tree = make_twins("sine")
    x, y = _sine_batch()
    alpha = 0.3
    (ref, _), g = jax.value_and_grad(jmap._loss, argnums=1, has_aux=True)(
        jstate, jstate.params, jstate.batch_stats, (jnp.asarray(x), jnp.asarray(y)), alpha)
    g_flat, g_logvar = _flat_and_logvar(g)
    flat = pstate.flat_params.clone().requires_grad_()
    logvar = torch.tensor(logvar_from_jax(tree), requires_grad=True)
    loss, _ = tmap.map_loss(pstate, flat, torch.from_numpy(x), torch.from_numpy(y), alpha,
                            logvar)
    got_flat, got_logvar = torch.autograd.grad(loss, (flat, logvar))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(got_flat.numpy(), g_flat, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got_logvar), g_logvar, rtol=1e-5)
    with pytest.raises(ValueError, match="logvar"):
        tmap.map_loss(pstate, flat, torch.from_numpy(x), torch.from_numpy(y), alpha)


def test_regressor_three_map_steps_match_jax():
    """Three Adam steps on the weights and logvar, batch by batch, then the
    evaluation NLL at the trained state (its logvar read from the model)."""
    jstate, pstate, tree = make_twins("sine")
    lr, alpha = 1e-2, 0.005
    jstate = jstate.replace(tx=optax.adam(lr), opt_state=optax.adam(lr).init(jstate.params))
    batches = [_sine_batch(seed=s) for s in (4, 5, 6)]
    ref_losses = []
    for x, y in batches:
        jstate, loss = jmap.map_step(jstate, (jnp.asarray(x), jnp.asarray(y)), alpha)
        ref_losses.append(float(loss))
    ref_flat, ref_logvar = _flat_and_logvar(jstate.params)
    flat = pstate.flat_params.clone().requires_grad_()
    logvar = torch.tensor(logvar_from_jax(tree), requires_grad=True)
    opt, _ = tmap.map_optimizer(flat, lr, logvar)
    losses = [float(tmap.map_step(pstate, flat, opt, b, alpha, logvar)) for b in batches]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    np.testing.assert_allclose(flat.detach().numpy(), ref_flat, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(logvar), ref_logvar, rtol=1e-5)
    trained = tmap.trained_state(pstate, logvar)
    assert float(trained.logvar) == float(logvar) and float(pstate.logvar) != float(logvar)
    x, y = _sine_batch(seed=7)
    trained.flat_params = flat.detach().clone()
    ref_nll, _ = jmap.eval_regression(jstate, (jnp.asarray(x), jnp.asarray(y)))
    nll, _ = tmap.eval_regression(trained, (x, y))
    np.testing.assert_allclose(nll, float(ref_nll), rtol=1e-5)


def test_train_map_trains_the_regressor_and_its_logvar():
    """``train_map`` on a regressor lowers the loss, moves logvar from 0 and
    returns it in the state's model; the caller's state keeps its own."""
    _, pstate, _ = make_twins("sine")
    with torch.no_grad():
        pstate.model.logvar.fill_(0.0)
    x, y = _sine_batch(seed=8, n=64)
    loader = make_dataloaders(ArrayDataset(x, y), ArrayDataset(x, y), None, 16, seed=1)[0]
    losses = []
    trained = tmap.train_map(pstate, loader, loader, num_epochs=6, alpha=1e-3, lr=0.02,
                             callback=lambda step, loss: losses.append(float(loss)))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert abs(float(trained.logvar)) > 1e-3 and float(pstate.logvar) == 0.0
    assert trained.model is not pstate.model


def test_logvar_from_jax_reads_the_regressors_leaf():
    _, _, tree = make_twins("sine")
    assert logvar_from_jax(tree) == pytest.approx(-0.7)
    _, _, ctree = make_twins("banana")
    assert logvar_from_jax(ctree) is None


@pytest.mark.parametrize("n,seed", [(1, 3), (400, 2**63 - 2), (1281, 12345)])
def test_shuffle_without_the_library_is_the_same_stream(n, seed):
    """The Python splitmix64 Fisher-Yates the loader falls back to without a
    compiler gives the native library's permutation."""
    from laplace_inducing_points_tpu_torch.data import native

    got = native._shuffle_python(n, seed)
    assert sorted(got.tolist()) == list(range(n))
    if native.have_native():
        np.testing.assert_array_equal(got, native.shuffle_indices(n, seed))
