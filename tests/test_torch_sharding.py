"""Twin tests of the port's mesh (``parallel/``): counterparts of the nine
tests of ``tests/test_sharding.py``, each sharded op against the JAX
package's sharded version and against the port's unsharded one.

JAX's mesh is the 8 forced CPU devices of ``tests/conftest.py``; the port's
lists the CPU 8 times. Both get the same trained blob classifier
(``fixtures.classifier_state``, converted with ``params_from_jax``) and the
same points and probes. Tolerances, each with its reason:

* the sharded ops against the port's unsharded ones: rtol 1e-5 — the same
  per-example work, partial sums added in another order;
* against JAX's sharded ops: rtol 1e-4, atol 1e-4, JAX's own test's;
* the data-parallel MAP step: the loss rtol 1e-5, the Adam step over lr
  ``g/(|g|+ε)`` elementwise 1e-2 and relative L2 1e-4 (the MAP-step twins',
  ``tests/test_torch_training.py``), BatchNorm statistics rtol 1e-5, atol 1e-7;
* the mesh predictor against the plain one on the same generator: rtol 1e-5,
  atol 1e-5 (JAX's own test's); the JAX mesh predictor against the port on
  JAX's noise: rtol 1e-3, atol 1e-4, the predictor twins'
  (``tests/test_torch_predictor.py``: f32 eigenvectors of a rank-deficient
  Gram). The cov path's draws come from a per-image eigh whose column signs
  differ between packages, so it is held against the port's plain path only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.inference.lla import ScalableLLAPredictor as JaxPredictor
from laplace_inducing_points_tpu.parallel import sharded_ops as jsh
from laplace_inducing_points_tpu.parallel.mesh import make_mesh as jax_make_mesh
from laplace_inducing_points_tpu.parallel.mesh import shard_batch as jax_shard_batch
from laplace_inducing_points_tpu.training import map as jmap
from laplace_inducing_points_tpu_torch.core import operators as tops
from laplace_inducing_points_tpu_torch.core.params import batch_stats_from_jax, params_from_jax
from laplace_inducing_points_tpu_torch.inference.lla import (ScalableLLAPredictor,
                                                             amortized_logit_samples_from_noise,
                                                             matfree_logit_samples_from_noise)
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier
from laplace_inducing_points_tpu_torch.parallel import mesh as pm
from laplace_inducing_points_tpu_torch.parallel import sharded_ops as sh
from laplace_inducing_points_tpu_torch.training import map as tmap

from fixtures import classifier_state
from torch_twins import bn_data, bn_twins

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh(jax.devices()[:8]), pm.make_mesh([CPU] * 8)


@pytest.fixture(scope="module")
def twins():
    """``(jax_state, port_state, x, y)``: the trained blob classifier."""
    _, jstate, (x, y) = classifier_state()
    flat, _ = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    return jstate, ModelState(SimpleClassifier(6, 1, 2, 2), flat, "classifier"), \
        np.asarray(x), np.asarray(y)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_make_mesh_and_sharding_helpers():
    """A mesh may repeat a device; a 2-D mesh shards over the data axis at
    model index 0; ragged splits keep every row; padding to a multiple."""
    mesh = pm.make_mesh([CPU] * 4, axis_names=(pm.DATA_AXIS, pm.MODEL_AXIS), shape=(2, 2))
    assert mesh.axis_devices(pm.DATA_AXIS) == (CPU, CPU)
    x = torch.arange(10.0)[:, None]
    parts = pm.shard_batch((x, x[:, 0]), pm.make_mesh([CPU] * 3))
    assert [len(p) for p in parts[0]] == [4, 3, 3]
    torch.testing.assert_close(torch.cat(parts[0]), x)
    assert len(pm.replicated(mesh).place(x)) == 2
    padded, n = pm.pad_to_multiple(x, 8)
    assert n == 10 and padded.shape == (16, 1) and float(padded[10:].abs().sum()) == 0
    with pytest.raises(ValueError):
        pm.make_mesh([CPU] * 3, shape=(2,))


def test_sharded_ggn_matches_single_device(meshes, twins):
    jstate, pstate, x, _ = twins
    Z = x[:16]
    V = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, pstate.spec.num_params)))
    ref = jsh.sharded_ggn_matmat(jstate, jnp.asarray(Z), jnp.asarray(V), meshes[0],
                                 full_set_size=40)
    got = sh.sharded_ggn_matmat(pstate, torch.from_numpy(Z), torch.from_numpy(V), meshes[1],
                                full_set_size=40)
    plain = tops.make_ggn_operator(pstate, torch.from_numpy(Z), 40).matmat(torch.from_numpy(V))
    _close(got, plain, 1e-5, 1e-6)
    _close(got, ref, 1e-4, 1e-4)


def test_sharded_curvature_adds_alpha(meshes, twins):
    jstate, pstate, x, _ = twins
    Z = x[:8]
    V = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, pstate.spec.num_params)))
    ref = jsh.sharded_curvature_matmat(jstate, jnp.asarray(Z), jnp.asarray(V), meshes[0],
                                       alpha=0.3)
    got = sh.sharded_curvature_matmat(pstate, torch.from_numpy(Z), torch.from_numpy(V),
                                      meshes[1], alpha=0.3)
    plain = tops.make_ggn_operator(pstate, torch.from_numpy(Z)).matmat(torch.from_numpy(V))
    _close(got, plain + 0.3 * torch.from_numpy(V), 1e-5, 1e-6)
    _close(got, ref, 1e-4, 1e-4)


def test_sharded_gram_matches_dense(meshes, twins):
    """The Gram of parameter-axis strips, one per device, added up."""
    jstate, pstate, x, _ = twins
    Z = x[:8]
    R = tops.dense_wt(pstate, torch.from_numpy(Z))
    got = sh.sharded_gram(pstate, torch.from_numpy(Z), meshes[1])
    _close(got, R @ R.T, 1e-5, 1e-6)
    _close(got, jsh.sharded_gram(jstate, jnp.asarray(Z), meshes[0]), 1e-4, 1e-4)


def test_sharded_dense_wt_matches(meshes, twins):
    """One row block per device, in order; 6 points over 8 devices leave two
    devices without a block."""
    jstate, pstate, x, _ = twins
    for n in (8, 6):
        Z = x[:n]
        blocks = sh.sharded_dense_wt(pstate, torch.from_numpy(Z), meshes[1])
        assert [b.shape[0] for b in blocks] == [2] * n
        _close(torch.cat(blocks), tops.dense_wt(pstate, torch.from_numpy(Z)), 1e-6)
    ref = jsh.sharded_dense_wt(jstate, jnp.asarray(x[:8]), meshes[0])
    _close(torch.cat(sh.sharded_dense_wt(pstate, torch.from_numpy(x[:8]), meshes[1])), ref,
           1e-4, 1e-4)


def _map_steps(kind, meshes, twins):
    """``(jax sharded, port single-device, port mesh)`` results of one MAP
    step on a batch of 16: ``(loss, flat, batch_stats)``."""
    import optax
    if kind == "bn":
        jstate, pstate, _, _ = bn_twins()
        x, y = bn_data(16, 70)
    else:
        jstate, pstate, xs, ys = twins
        x, y = xs[:16], ys[:16].astype(np.int32)
    lr = 1e-3
    jstate = jstate.replace(tx=optax.adam(lr), opt_state=optax.adam(lr).init(jstate.params))
    jnew, jloss = jmap.map_step(jstate, jax_shard_batch((jnp.asarray(x), jnp.asarray(y)),
                                                        meshes[0]), 0.1)
    jout = (float(jloss), np.asarray(jops.flatten_nn_params(jnew.params)[0]),
            {k: v.numpy() for k, v in batch_stats_from_jax(
                jax.tree.map(np.asarray, jnew.batch_stats)).items()})
    outs = []
    for mesh in (None, meshes[1]):
        work = tmap.working_state(pstate, pstate.flat_params.clone())
        flat = pstate.flat_params.clone().requires_grad_()
        loss = tmap.map_step(work, flat, torch.optim.Adam([flat], lr=lr, eps=1e-8), (x, y),
                             0.1, mesh=mesh)
        outs.append((float(loss), flat.detach().numpy(),
                     {k: v.numpy() for k, v in work.batch_stats.items()}))
    return jout, outs, pstate.flat_params.numpy(), lr


@pytest.mark.parametrize("kind", ["classifier", "bn"])
def test_data_parallel_map_step_matches_single_device(meshes, twins, kind):
    """Same batch, sharded over 8 devices vs one: the same loss, step and,
    for the BatchNorm net, the same running statistics, those of the whole
    batch (trap: statistics per shard are another function)."""
    jout, (single, meshed), before, lr = _map_steps(kind, meshes, twins)
    for out in (meshed, jout):
        np.testing.assert_allclose(out[0], single[0], rtol=1e-5)
        u, u_ref = (out[1] - before) / lr, (single[1] - before) / lr
        np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-2)
        assert np.linalg.norm(u - u_ref) <= 1e-4 * np.linalg.norm(u_ref)
        assert out[2].keys() == single[2].keys() and bool(single[2]) == (kind == "bn")
        for key in single[2]:
            np.testing.assert_allclose(out[2][key], single[2][key], rtol=1e-5, atol=1e-7,
                                       err_msg=key)


def test_probe_sharding_placement(meshes):
    probes = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(2), (16, 32))))
    shards = sh.shard_probes(probes, meshes[1])
    assert len(shards) == 8 and all(s.shape == (2, 32) for s in shards)
    torch.testing.assert_close(torch.cat(shards), probes, rtol=0, atol=0)


def _predictors(pstate, Z, mesh, **kw):
    return (ScalableLLAPredictor(pstate, Z, full_set_size=32, **kw),
            ScalableLLAPredictor(pstate, Z, full_set_size=32, mesh=mesh, **kw))


def test_mesh_sharded_predictor_matches_single_device(meshes, twins):
    """Sample axis over the mesh, the factor replicated: the plain values,
    with and without sample blocks; JAX's mesh predictor gives the port's on
    its own noise."""
    jstate, pstate, x, _ = twins
    Z, X = torch.from_numpy(x[:6]), torch.from_numpy(x[:10])
    S = 32
    with torch.no_grad():
        plain, meshed = _predictors(pstate, Z, meshes[1])
        a = plain.logit_samples(X, 0.4, torch.Generator().manual_seed(11), S)
        b = meshed.logit_samples(X, 0.4, torch.Generator().manual_seed(11), S)
        assert b.shape == (S, 10, 2) and len(meshed.shards) == 8
        _close(b, a, 1e-5, 1e-5)
        _, blocked = _predictors(pstate, Z, meshes[1], sample_block=16)
        c = blocked.logit_samples(X, 0.4, torch.Generator().manual_seed(11), S)
        _close(c, a, 1e-5, 1e-5)

        key = jax.random.PRNGKey(11)
        jmeshed = JaxPredictor(jstate, jnp.asarray(x[:6]), full_set_size=32, mesh=meshes[0])
        ref = np.asarray(jmeshed.logit_samples(jnp.asarray(x[:10]), 0.4, key, S))
        eps = torch.from_numpy(np.asarray(jax.random.normal(key, (S, pstate.spec.num_params))))
        got = amortized_logit_samples_from_noise(pstate, plain.R, plain.lam, plain.V, 0.4,
                                                 plain.beta, X, eps)
    _close(got, ref, 1e-3, 1e-4)


def test_mesh_sharded_matfree_predictor_matches_single_device(meshes, twins):
    jstate, pstate, x, _ = twins
    Z, X = torch.from_numpy(x[:6]), torch.from_numpy(x[:10])
    kw = dict(method="matfree", cg_tol=1e-8, cg_maxiter=400, precond_rank=4)
    S = 16
    with torch.no_grad():
        plain, meshed = _predictors(pstate, Z, meshes[1], **kw)
        a = plain.logit_samples(X, 0.4, torch.Generator().manual_seed(13), S)
        b = meshed.logit_samples(X, 0.4, torch.Generator().manual_seed(13), S)
        assert b.shape == (S, 10, 2)
        _close(b, a, 1e-4, 1e-5)
        assert meshed.last_cg_residual <= 1e-5

        key = jax.random.PRNGKey(13)
        jmeshed = JaxPredictor(jstate, jnp.asarray(x[:6]), full_set_size=32, mesh=meshes[0],
                               **kw)
        ref = np.asarray(jmeshed.logit_samples(jnp.asarray(x[:10]), 0.4, key, S))
        k1, k2 = jax.random.split(key)
        eps = torch.from_numpy(np.asarray(jax.random.normal(k1, (S, pstate.spec.num_params))))
        eta = torch.from_numpy(np.asarray(jax.random.normal(k2, (S, plain.d))))
        got, _ = matfree_logit_samples_from_noise(pstate, Z, plain.nys, 0.4, 32, X, eps, eta,
                                                  1e-8, 400)
    _close(got, ref, 1e-3, 1e-4)


def test_mesh_cov_predictor_matches_single_device(meshes, twins):
    """``method="cov"`` takes a mesh and runs unsharded: the plain draws."""
    _, pstate, x, _ = twins
    Z, X = torch.from_numpy(x[:6]), torch.from_numpy(x[:10])
    with torch.no_grad():
        plain, meshed = _predictors(pstate, Z, meshes[1], method="cov")
        a = plain.logit_samples(X, 0.4, torch.Generator().manual_seed(14), 64)
        b = meshed.logit_samples(X, 0.4, torch.Generator().manual_seed(14), 64)
    assert len(meshed.shards) == 1 and b.shape == (64, 10, 2)
    torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernels_launch_on_the_device_of_their_operands():
    """On a second GPU each kernel wrapper launches under that device's guard
    and stream, and its result equals the first GPU's (one card cannot show
    a launch on the wrong device)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
    from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep
    from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
    g = torch.Generator().manual_seed(0)
    A, B, C = (torch.randn(s, generator=g) for s in ((40, 3000), (56, 3000), (40, 56)))
    for fn, args in ((syrk, (A,)), (matmul_nt, (A, B)), (matmul_nn, (C, B)),
                     (ggn_sweep, (A, B, 0.5))):
        ref = fn(*(t.to("cuda:0") if torch.is_tensor(t) else t for t in args))
        got = fn(*(t.to("cuda:1") if torch.is_tensor(t) else t for t in args))
        torch.cuda.synchronize("cuda:1")
        assert got.device == torch.device("cuda:1")
        torch.testing.assert_close(got.cpu(), ref.cpu(), rtol=0, atol=0)
