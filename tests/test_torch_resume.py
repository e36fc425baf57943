"""Twin tests of the port's resumable MAP training: the train-state checkpoint
(``utils.checkpoint.save_train_state``/``load_train_state``) and
``training.map.train_map`` continuing from it.

A JAX ``train_map`` of one epoch, saved, restored and trained one more epoch
is held against the port doing the same on the same weights and batches, for
a small classifier and a small BatchNorm net (cosine schedule over the first
epoch, so the resumed epoch trains at the schedule's floor). Tolerances, each
with its reason:

* the weights after the resumed epoch: absolute 1e-5 — Adam's first steps
  move each weight by about lr = 1e-3 times ``g/(|g|+ε)``, whose f32
  summation-order differences the existing MAP-step twins bound at 1e-2 of
  lr (``tests/test_torch_training.py``);
* the BatchNorm statistics: rtol 1e-5, atol 1e-7 (as the MAP-step twins);
* the learning rate at the restored count: rtol 1e-6 against optax's schedule;
* the port's own resume against one uninterrupted run: bitwise, the same
  operations in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.training import map as jmap
from laplace_inducing_points_tpu.utils import checkpoint as jckpt
from laplace_inducing_points_tpu_torch.core.params import batch_stats_from_jax
from laplace_inducing_points_tpu_torch.training import map as tmap
from laplace_inducing_points_tpu_torch.utils import checkpoint as tckpt

from torch_twins import bn_data, bn_twins, inputs, make_twins

LR, ALPHA = 1e-3, 0.01
GOLDEN = "tests/golden/banana_torch"


def _twins(kind):
    """``(jax_state, port_state, batches)``: 4 seeded batches of 8."""
    if kind == "bn":
        jstate, pstate, _, _ = bn_twins()
        batches = [bn_data(8, 50 + i) for i in range(4)]
    else:
        jstate, pstate, _ = make_twins(kind)
        rng = np.random.default_rng(5)
        batches = [(inputs(kind, 8, seed=60 + i), rng.integers(0, 3, 8).astype(np.int32))
                   for i in range(4)]
    return jstate, pstate, batches


def _jax_resumed(jstate, batches, ckpt, steps):
    """JAX: one epoch, ``save_train_state``, ``load_train_state`` into a fresh
    template, one more epoch."""
    tx = optax.adam(jmap.cosine_lr(LR, 1, steps))
    template = jstate.replace(tx=tx, opt_state=tx.init(jstate.params))
    state = jmap.train_map(template, batches, batches, num_epochs=1, alpha=ALPHA,
                           verbose=False)
    jckpt.save_train_state(state, ckpt, step=1)
    restored = jckpt.load_train_state(template, ckpt)
    return restored, jmap.train_map(restored, batches, batches, num_epochs=1, alpha=ALPHA,
                                    verbose=False)


@pytest.mark.parametrize("kind", ["classifier", "bn"])
def test_resumed_map_matches_jax(tmp_path, kind):
    jstate, pstate, batches = _twins(kind)
    steps = len(batches)
    jrestored, jfinal = _jax_resumed(jstate, batches, str(tmp_path / "jax"), steps)

    schedule = tmap.cosine_lr(LR, 1, steps)
    first = tmap.train_map(pstate, batches, batches, num_epochs=1, alpha=ALPHA, lr=schedule)
    tckpt.save_train_state(first, str(tmp_path / "torch"), "map")
    restored = tckpt.load_train_state(str(tmp_path / "torch"), "map", pstate.model,
                                      pstate.model_kind, torch.device("cpu"))
    count = int(jrestored.opt_state[0].count)
    assert restored.step == count == int(jrestored.step) == steps
    # the schedule resumes at the restored count: past its decay steps, at
    # its floor, 0.08 lr (optax clamps the count)
    np.testing.assert_allclose(schedule(restored.step),
                               float(optax.cosine_decay_schedule(LR, steps, 0.08)(count)),
                               rtol=1e-6)
    np.testing.assert_allclose(schedule(restored.step), 0.08 * LR, rtol=1e-6)
    seen = []
    final = tmap.train_map(restored, batches, batches, num_epochs=1, alpha=ALPHA, lr=schedule,
                           callback=lambda step, loss: seen.append(step))
    assert seen == list(range(steps, 2 * steps)) and final.step == 2 * steps

    ref = np.asarray(jops.flatten_nn_params(jfinal.params)[0])
    np.testing.assert_allclose(final.flat_params.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(restored.opt_state.mu[0].numpy(),
                               np.asarray(jops.flatten_nn_params(
                                   jrestored.opt_state[0].mu)[0]), rtol=1e-4, atol=1e-7)
    if kind == "bn":
        stats = batch_stats_from_jax(jax.tree.map(np.asarray, jfinal.batch_stats))
        for key, value in stats.items():
            np.testing.assert_allclose(final.batch_stats[key].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_resume_continues_one_uninterrupted_run(tmp_path, kind):
    """Two epochs in one run equal one epoch, the train-state file, and one
    more epoch (the batches in the same order): Adam's moments, its count
    (trap: torch keeps it per leaf, as a tensor) and a regressor's
    ``logvar`` leaf all carry over."""
    _, pstate, batches = _twins(kind)
    if kind == "regressor":
        batches = [(x, np.random.default_rng(1).standard_normal((8, 1)).astype(np.float32))
                   for x, _ in batches]
    schedule = tmap.cosine_lr(LR, 2, len(batches))
    whole = tmap.train_map(pstate, batches, batches, num_epochs=2, alpha=ALPHA, lr=schedule)
    half = tmap.train_map(pstate, batches, batches, num_epochs=1, alpha=ALPHA, lr=schedule)
    tckpt.save_train_state(half, str(tmp_path), "map")
    restored = tckpt.load_train_state(str(tmp_path), "map", pstate.model, pstate.model_kind,
                                      torch.device("cpu"))
    assert restored.step == len(batches) and len(restored.opt_state.mu) == (
        2 if kind == "regressor" else 1)
    resumed = tmap.train_map(restored, batches, batches, num_epochs=1, alpha=ALPHA,
                             lr=schedule)
    torch.testing.assert_close(resumed.flat_params, whole.flat_params, rtol=0, atol=0)
    assert resumed.step == whole.step == 2 * len(batches)
    if kind == "regressor":
        assert float(resumed.logvar) == float(whole.logvar)


def test_train_state_round_trip_and_periodic_saves(tmp_path):
    """``checkpoint_every``: saved after epoch e + 1 when (e + 1) % every == 0
    and e + 1 < num_epochs, so 3 epochs at every 1 leave the state after the
    second; the file restores weights, statistics, moments and count."""
    _, pstate, batches = _twins("bn")
    saved = []
    tmap.train_map(pstate, batches, batches, num_epochs=3, alpha=ALPHA, lr=LR,
                   checkpoint_dir=str(tmp_path), checkpoint_name="map", checkpoint_every=1,
                   callback=lambda step, loss: saved.append(step))
    restored = tckpt.load_train_state(str(tmp_path), "map", pstate.model, "classifier",
                                      torch.device("cpu"))
    assert restored.step == 2 * len(batches)
    again = tmap.train_map(pstate, batches, batches, num_epochs=2, alpha=ALPHA, lr=LR)
    torch.testing.assert_close(restored.flat_params, again.flat_params, rtol=0, atol=0)
    for key, value in again.batch_stats.items():
        torch.testing.assert_close(restored.batch_stats[key], value, rtol=0, atol=0)
    for got, want in zip(restored.opt_state.mu + restored.opt_state.nu,
                         again.opt_state.mu + again.opt_state.nu):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_old_map_file_restores_weights_only(capsys):
    """A MAP file without optimizer state (the golden banana's, written by
    ``save_params``) restores its weights and statistics at step 0 with the
    reference's note; ``load_state`` reads a train-state file as it is."""
    from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier
    model = SimpleClassifier(16, 3, 2, 2)
    state = tckpt.load_train_state(GOLDEN, "map_banana", model, "classifier",
                                   torch.device("cpu"))
    assert "optimizer-state tree mismatch" in capsys.readouterr().out
    assert state.opt_state is None and state.step == 0
    plain = tckpt.load_state(GOLDEN, "map_banana", model, "classifier", torch.device("cpu"))
    torch.testing.assert_close(state.flat_params, plain.flat_params, rtol=0, atol=0)


def test_missing_train_state_raises(tmp_path):
    _, pstate, _ = _twins("classifier")
    with pytest.raises(FileNotFoundError):
        tckpt.load_train_state(str(tmp_path), "map_mnist", pstate.model, "classifier",
                               torch.device("cpu"))
