"""Twin tests of the port's wide MLP, ResNet1M, BatchNorm and CIFAR-10
augmentation against the JAX package.

Both packages get the same numpy inputs: Flax parameters and ``batch_stats``
converted by the port's converter, the same images and batches. Tolerances,
each with its reason:

* forward passes at full width: rtol 1e-5, atol 1e-6 — f32 convolutions and
  matmuls summed in another order, through up to 20 layers;
* the flat order and the converters: bitwise;
* the strided SAME convolution: rtol 1e-5, atol 1e-6, one layer;
* BatchNorm statistics after 3 MAP steps: rtol 1e-5, atol 1e-7 — the unbiased
  variance would put the running variance 1/(n−1) of 1% off, 6.7e-5 at
  n = 150 values per channel;
* ResNet1M's MAP loss, gradient and updated statistics in float64: rtol
  1e-10 (round-off; in float32 this gradient is ill-conditioned);
* the rows in eval mode: rtol 1e-5, atol 1e-6;
* the gram KL value and dL/dZ of the BatchNorm net: relative 1e-5 (value) and
  relative L2 1e-5 (gradient);
* the augmentation: bitwise (the same native kernel and seed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen as fnn
from jax.flatten_util import ravel_pytree

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.data import scale as jscale
from laplace_inducing_points_tpu.models import scale as jmodels
from laplace_inducing_points_tpu.training import inducing as jind
from laplace_inducing_points_tpu.training import map as jmap
from laplace_inducing_points_tpu_torch.core import operators as tops
from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, batch_stats_from_jax,
                                                           batch_stats_to_jax,
                                                           lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.data import scale as tscale
from laplace_inducing_points_tpu_torch.models import scale as tmodels
from laplace_inducing_points_tpu_torch.models.layers import Conv, same_padding
from laplace_inducing_points_tpu_torch.models.registry import get_model
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.training import inducing as tind
from laplace_inducing_points_tpu_torch.training import map as tmap
from laplace_inducing_points_tpu_torch.utils import checkpoint as tckpt

from torch_twins import bn_data as _bn_data, bn_twins as _bn_twins, convert_twins

MLP = dict(input_shape=(28, 28, 1), num_hidden=[256, 128], num_layers=2, num_classes=10)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def mlp_twins():
    return convert_twins(jmodels.LargeClassifier(**MLP), tmodels.LargeClassifier(**MLP),
                         jnp.zeros((1, 28, 28, 1)))


@pytest.fixture(scope="module")
def resnet_twins():
    return convert_twins(jmodels.ResNet1M(num_classes=10), tmodels.ResNet1M(10),
                         jnp.zeros((1, 32, 32, 3)))


# --- the wide MLP and ResNet1M at full width ----------------------------------

def test_mlp_forward_and_width_match_jax(mlp_twins):
    jstate, pstate, _, _ = mlp_twins
    assert pstate.spec.num_params == 235146 and pstate.batch_stats == {}
    x = np.random.default_rng(1).uniform(0, 1, (2, 28, 28, 1)).astype(np.float32)
    ref = jops.model_outputs(jstate, jstate.params, jnp.asarray(x))
    got = tops.model_outputs(pstate, pstate.flat_params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # one example in the model's input shape gives unbatched logits, as in JAX
    one = pstate.model(torch.from_numpy(x[0]))
    assert one.shape == (10,)


@pytest.mark.parametrize("shape", [(32, 32, 3), (28, 28, 1)])
def test_resnet1m_forward_matches_jax(resnet_twins, shape):
    """Eval mode with seeded statistics; 28×28×1 inputs are tiled to 3
    channels and pad (0, 1) at the stride-2 convolutions of 28 and 14 pixels,
    32×32×3 at those of 32 and 16."""
    jstate, pstate, _, _ = resnet_twins
    x = np.random.default_rng(2).uniform(0, 1, (2, *shape)).astype(np.float32)
    ref = jops.model_outputs(jstate, jstate.params, jnp.asarray(x))
    got = tops.model_outputs(pstate, pstate.flat_params, torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_resnet1m_flat_order_matches_ravel_pytree(resnet_twins):
    jstate, pstate, tree, stats = resnet_twins
    jflat, _ = ravel_pytree(jstate.params)
    flat, spec = params_from_jax(tree)
    assert spec.num_params == jflat.size == 1084586
    assert spec == pstate.spec == FlatSpec.from_module(tmodels.ResNet1M(10))
    np.testing.assert_array_equal(pstate.flat_params.numpy(), np.asarray(jflat))
    # the statistics: 21 BatchNorms (stem, 2 per block, 2 projections), keyed
    # like the module's buffers, and back to the Flax tree bit for bit
    assert set(pstate.batch_stats) == {n for n, _ in tmodels.ResNet1M(10).named_buffers()}
    assert len(pstate.batch_stats) == 2 * 21
    back = batch_stats_to_jax(pstate.batch_stats)
    jax.tree.map(np.testing.assert_array_equal, back, stats)


def test_resnet1m_map_loss_gradient_and_statistics_match_jax_in_float64(resnet_twins):
    """The MAP step's train-mode forward at full width, in float64 in both
    packages: the loss, its gradient in the flat weights and the updated
    BatchNorm statistics agree to round-off (rtol 1e-10). In float32 the
    gradient of this randomly initialised BatchNorm network is
    ill-conditioned (the port's is 2.7e-3 from float64, the JAX package's
    8.4e-3), so float64 is the comparison that can see a fault."""
    from types import SimpleNamespace

    jstate, pstate, _, _ = resnet_twins
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (4, 32, 32, 3))
    y = rng.integers(0, 10, 4).astype(np.int32)
    with jax.enable_x64(True):
        to64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)
        (ref_loss, ref_stats), ref_grad = jax.value_and_grad(jmap._loss, argnums=1,
                                                             has_aux=True)(
            jstate, to64(jstate.params), to64(jstate.batch_stats),
            (jnp.asarray(x), jnp.asarray(y)), 0.005)
        ref_grad = np.asarray(ravel_pytree(ref_grad)[0])
        ref_stats = jax.tree.map(np.asarray, ref_stats)
    state64 = SimpleNamespace(model=tmodels.ResNet1M(10).double(), spec=pstate.spec,
                              batch_stats={k: v.double() for k, v in pstate.batch_stats.items()})
    flat = pstate.flat_params.double().requires_grad_()
    loss, stats = tmap.classifier_loss(state64, flat, torch.from_numpy(x), torch.from_numpy(y),
                                       0.005)
    (grad,) = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-12)
    assert _rel(grad.numpy(), ref_grad) <= 1e-10
    back = batch_stats_to_jax(stats)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12),
                 back, ref_stats)


@pytest.mark.parametrize("size,window,stride,expected", [
    (32, 3, 2, (0, 1)), (28, 3, 2, (0, 1)), (14, 3, 2, (0, 1)), (7, 3, 2, (1, 1)),
    (32, 3, 1, (1, 1)), (32, 1, 2, (0, 0)), (5, 5, 1, (2, 2))])
def test_same_padding_is_xlas(size, window, stride, expected):
    assert same_padding(size, window, stride) == expected


@pytest.mark.parametrize("size,stride,window", [(32, 2, 3), (7, 2, 3), (14, 1, 3),
                                                (16, 2, 1)])
def test_strided_same_conv_matches_flax(size, stride, window):
    """Trap C2: Flax's SAME pads (0, 1) where ``padding=1`` pads (1, 1)."""
    rng = np.random.default_rng(size + stride)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    kernel = rng.standard_normal((window, window, 3, 4)).astype(np.float32)
    flax_conv = fnn.Conv(4, (window, window), strides=(stride, stride), padding="SAME",
                         use_bias=False)
    ref = flax_conv.apply({"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    conv = Conv(3, 4, (window, window), (stride, stride), "SAME", use_bias=False)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(kernel))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_registry_builds_the_scale_models():
    mlp = get_model({"name": "large_classifier", "num_h": [256, 128], "num_l": 2,
                     "num_c": 10}, (28, 28, 1))
    assert FlatSpec.from_module(mlp).num_params == 235146
    assert isinstance(get_model({"name": "ResNet1", "num_c": 10}, (32, 32, 3)),
                      tmodels.ResNet1M)


def test_lecun_init_gives_batchnorm_unit_scale():
    spec = FlatSpec.from_module(tmodels.ResNet1M(10))
    tree = lecun_normal_params(spec, 0)
    scales = [bn["scale"] for name, bn in tree.items() if name.startswith("BatchNorm")]
    scales += [bn["scale"] for block in tree.values() for name, bn in block.items()
               if name.startswith("BatchNorm")]
    assert len(scales) == 21 and all(np.all(s == 1.0) for s in scales)
    flat, _ = params_from_jax(tree)
    out = tops.model_outputs(ModelState(tmodels.ResNet1M(10), flat, "classifier"), flat,
                             torch.rand(2, 32, 32, 3))
    assert torch.isfinite(out).all() and float(out.std()) > 1e-3


def test_map_file_carries_the_statistics(tmp_path, resnet_twins):
    _, pstate, _, _ = resnet_twins
    tckpt.save_params(pstate.flat_params, pstate.spec, str(tmp_path), "map_cifar10",
                      batch_stats=pstate.batch_stats)
    stats = tckpt.load_batch_stats(str(tmp_path), "map_cifar10")
    assert stats.keys() == pstate.batch_stats.keys()
    assert all(torch.equal(stats[k], pstate.batch_stats[k]) for k in stats)
    # a file without statistics (LeNet5, written before they were stored) loads
    flat, spec = params_from_jax(lecun_normal_params(FlatSpec.from_module(tmodels.LeNet5()), 0))
    torch.save({"flat": flat, "spec": spec.to_dict(), "logvar": None},
               tmp_path / "map_mnist.pt")
    assert tckpt.load_batch_stats(str(tmp_path), "map_mnist") == {}
    ModelState(tmodels.LeNet5(), tckpt.load_params(str(tmp_path), "map_mnist")[0],
               "classifier", tckpt.load_batch_stats(str(tmp_path), "map_mnist"))


def test_model_state_checks_the_statistics(resnet_twins):
    _, pstate, _, _ = resnet_twins
    with pytest.raises(ValueError, match="batch_stats"):
        ModelState(tmodels.ResNet1M(10), pstate.flat_params, "classifier", {})


# --- a small BatchNorm net: MAP statistics, rows, gram KL ---------------------

def test_bn_map_steps_update_the_statistics_as_flax():
    """3 MAP steps on a batch of 6 5×5 images (n = 150 values per channel in
    the first BatchNorm, 24 after the stride): the running statistics with the
    biased batch variance, as Flax keeps them."""
    jstate, pstate, _, _ = _bn_twins()
    lr, alpha = 1e-3, 0.01
    jstate = jstate.replace(tx=optax.adam(lr), opt_state=optax.adam(lr).init(jstate.params))
    flat = pstate.flat_params.clone().requires_grad_()
    opt = torch.optim.Adam([flat], lr=lr, eps=1e-8)
    for step in range(3):
        x, y = _bn_data(6, 10 + step)
        jstate, jloss = jmap.map_step(jstate, (jnp.asarray(x), jnp.asarray(y)), alpha)
        loss = tmap.map_step(pstate, flat, opt, (x, y), alpha)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = batch_stats_from_jax(jax.tree.map(np.asarray, jstate.batch_stats))
    assert ref.keys() == pstate.batch_stats.keys()
    for key, value in ref.items():
        np.testing.assert_allclose(pstate.batch_stats[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    # the statistics moved off their initial values (mean 0, var 1)
    assert float(pstate.batch_stats["BatchNorm_0.mean"].abs().max()) > 1e-3
    x, y = _bn_data(6, 20)
    ref_nll, _ = jmap.eval_classification(jstate, (jnp.asarray(x), jnp.asarray(y)))
    nll, _ = tmap.eval_classification(
        ModelState(pstate.model, flat.detach(), "classifier", pstate.batch_stats), (x, y))
    np.testing.assert_allclose(nll, float(ref_nll), rtol=1e-5)


def test_train_map_keeps_the_callers_statistics():
    _, pstate, _, _ = _bn_twins()
    before = {k: v.clone() for k, v in pstate.batch_stats.items()}
    loader = [_bn_data(6, 30), _bn_data(6, 31)]
    trained = tmap.train_map(pstate, loader, loader, num_epochs=2, alpha=0.01, lr=1e-2)
    assert all(torch.equal(pstate.batch_stats[k], before[k]) for k in before)
    assert any(not torch.equal(trained.batch_stats[k], before[k]) for k in before)


def test_bn_rows_match_jax_in_eval_mode():
    jstate, pstate, _, _ = _bn_twins()
    Z, _ = _bn_data(3, 40)
    ref = jops.dense_wt(jstate, jnp.asarray(Z))
    got = tops.dense_wt(pstate, torch.from_numpy(Z), example_block=2)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_bn_gram_kl_and_grad_match_jax():
    jstate, pstate, _, _ = _bn_twins()
    (Z, _), (X, _) = _bn_data(3, 41), _bn_data(8, 42)
    ref_v, ref_g = jax.value_and_grad(jind.kl_objective_gram)(
        jnp.asarray(Z), jnp.asarray(X), jstate, 0.5, full_set_size=24)
    got_v, got_g = tind.kl_value_and_grad_gram(torch.from_numpy(Z), torch.from_numpy(X),
                                               pstate, 0.5, full_set_size=24)
    assert abs(float(got_v) - float(ref_v)) <= 1e-5 * abs(float(ref_v))
    assert _rel(got_g.numpy(), ref_g) <= 1e-5


# --- CIFAR-10 augmentation ----------------------------------------------------

def test_augmentation_matches_jax_take():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (40, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 40).astype(np.int32)
    ref_ds = jscale.AugmentedDataset(x, y, seed=7)
    got_ds = tscale.AugmentedDataset(x, y, seed=7)
    for idx in (np.arange(8), np.array([3, 39, 0, 17, 17]), rng.permutation(40)[:16]):
        ref, ref_y = ref_ds.take(idx)
        got, got_y = got_ds.take(idx)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got_y, ref_y)
    # crops and flips: not the plain images, each a window of the padded one
    assert not np.array_equal(got, x[idx])


def test_cifar10_train_loader_augments(tmp_path):
    train, test, _ = tscale.get_dataloaders("cifar10", 64, root=str(tmp_path))
    assert isinstance(train, tscale.AugmentedLoader) and len(train) == 8029 // 64
    xb, yb = next(iter(train))
    assert xb.shape == (64, 32, 32, 3) and xb.dtype == np.float32 and yb.shape == (64,)
    plain, _, _ = tscale.get_dataloaders("cifar10", 64, aug=False, root=str(tmp_path))
    assert not isinstance(plain, tscale.AugmentedLoader)
    assert not isinstance(test, tscale.AugmentedLoader)
