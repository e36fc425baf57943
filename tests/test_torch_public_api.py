"""The port's public API against the JAX package's: every name a JAX
subpackage's ``__init__`` exports has a counterpart the port's subpackage
exports (or a listed replacement), each port subpackage imports on its own
with ``jax`` blocked and without loading the kernels' library, and the last
helpers (``count_params``, ``num_curvature_params``, ``print_summary``,
``is_pd``, ``nystrom_preconditioner``, ``data.device_iter``) agree with the
JAX package's.

Tolerances: the counts exactly; ``nystrom_preconditioner``'s action relative
1e-5 on the same start Ω (the sketch's float32 eigh, as in
``tests/test_torch_nystrom.py``); ``device_iter``'s batches exactly.
"""

import ast
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu import utils as jutils
from laplace_inducing_points_tpu.core import params as jparams
from laplace_inducing_points_tpu.models import scale as jscale
from laplace_inducing_points_tpu.ops import nystrom as jny
from laplace_inducing_points_tpu_torch import core, data, models, ops, utils
from laplace_inducing_points_tpu_torch.models.state import ModelState
from torch_twins import make_twins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("core", "data", "evaluation", "inference", "models", "ops", "parallel",
               "training")

# JAX exports whose port counterpart has another name: the port restructured them
REPLACED = {
    # a flat tensor and its FlatSpec (``FlatSpec.unflatten``) replace the
    # (flat, unravel) pair of ravel_pytree
    ("core", "flatten_nn_params"): "FlatSpec",
    # one state object: the module, its flat weights, BatchNorm statistics and
    # the trainer's Adam state
    ("models", "TrainState"): "ModelState",
    ("models", "create_train_state"): "ModelState",
}
# JAX exports with no counterpart at all, and why
NOT_PORTED = {
    ("models", "EMPTY_STATS"): "Flax's frozen empty batch_stats collection; a port model "
                               "without BatchNorm has ModelState.batch_stats == {}",
}


def _jax_exports(sub: str) -> list[str]:
    """The names ``laplace_inducing_points_tpu/<sub>/__init__.py`` binds by
    import, read with ``ast`` (no JAX import)."""
    path = os.path.join(REPO, "laplace_inducing_points_tpu", sub, "__init__.py")
    tree = ast.parse(open(path).read())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_has_a_port_export(sub):
    port = importlib.import_module(f"laplace_inducing_points_tpu_torch.{sub}")
    names = _jax_exports(sub)
    assert names
    for name in names:
        if (sub, name) in NOT_PORTED:
            assert not hasattr(port, name), f"{sub}.{name} is ported: drop it from NOT_PORTED"
            continue
        target = REPLACED.get((sub, name), name)
        if name in port.__all__ or target != name:
            obj = getattr(port, target)
            assert getattr(obj, "__module__", "").startswith("laplace_inducing_points_tpu_torch")\
                or not callable(obj), (sub, name, obj)
        else:        # a submodule the JAX __init__ rebinds (inference.sample)
            assert importlib.util.find_spec(f"{port.__name__}.{name}") is not None, (sub, name)
    assert set(port.__all__) == set(dir(port)) & set(port.__all__)


def test_ops_syrk_is_the_b1_wrapper_and_runs_plain_on_the_cpu():
    from laplace_inducing_points_tpu_torch.ops.cuda import syrk as syrk_mod
    assert ops.syrk is syrk_mod.syrk
    A = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ops.syrk(A), A @ A.T, rtol=1e-6, atol=1e-6)


_IMPORT_ALONE = """
import sys
sys.modules["jax"] = None
import importlib
name = sys.argv[1]
module = importlib.import_module(name)
for export in getattr(module, "__all__", ()):
    getattr(module, export)
assert "laplace_inducing_points_tpu" not in sys.modules
build = sys.modules.get("laplace_inducing_points_tpu_torch.ops.cuda._build")
assert build is None or build.load_library.cache_info().currsize == 0, "library loaded"
print("imported", name)
"""


def test_port_subpackages_import_alone_with_jax_blocked():
    """Each subpackage (and the two figure modules) in a process of its own,
    ``jax`` blocked: no import cycle, no JAX, every export resolves, and the
    kernels' library is neither built nor loaded."""
    names = [f"laplace_inducing_points_tpu_torch.{s}" for s in (*SUBPACKAGES, "utils", "viz")]
    names += ["laplace_inducing_points_tpu_torch.viz.figures",
              "laplace_inducing_points_tpu_torch.viz.exp_plots"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = {name: subprocess.Popen([sys.executable, "-c", _IMPORT_ALONE, name], cwd=REPO,
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True) for name in names}
    for name, proc in procs.items():
        out = proc.communicate(timeout=120)[0]
        assert proc.returncode == 0 and f"imported {name}" in out, out[-2000:]


@pytest.mark.parametrize("name, D", [("LeNet5", 61706), ("ResNet1M", 1084586)])
def test_count_params_match_jax(name, D, capsys):
    """The counts on the JAX parameter tree (shapes from ``eval_shape``,
    zeros) converted with ``params_from_jax``; ``print_summary``'s lines
    equal the JAX package's."""
    jmodel = jscale.LeNet5() if name == "LeNet5" else jscale.ResNet1M(num_classes=10)
    shape = (1, 28, 28, 1) if name == "LeNet5" else (1, 32, 32, 3)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros(shape)), jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes["params"]))
    flat, spec = core.params_from_jax(tree)
    module = getattr(models, name)() if name == "LeNet5" else models.ResNet1M(10)
    state = ModelState(module, flat, "classifier")
    assert jparams.count_params(tree) == jparams.num_curvature_params(tree) == D
    for counted in (core.count_params(module), core.count_params(tree),
                    core.num_curvature_params(state), core.num_curvature_params(spec),
                    core.num_curvature_params(module), core.num_curvature_params(tree),
                    core.count_params(list(module.parameters()))):
        assert counted == D
    jparams.print_summary(tree)
    jax_lines = capsys.readouterr().out
    core.print_summary(module)
    assert capsys.readouterr().out == jax_lines


def test_count_params_of_a_regressor_includes_logvar_and_the_curvature_not():
    jstate, pstate, tree = make_twins("regressor")
    assert core.count_params(pstate.model) == jparams.count_params(jstate.params) \
        == core.count_params(tree)
    assert core.num_curvature_params(pstate) == jparams.num_curvature_params(jstate.params) \
        == core.count_params(pstate.model) - 1


def test_is_pd_matches_jax():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    lam = np.logspace(0, -3, 12)
    pd = ((Q * lam) @ Q.T).astype(np.float32)
    neg = ((Q * np.concatenate([lam[:-1], [-1e-3]])) @ Q.T).astype(np.float32)
    tiny = ((Q * np.concatenate([lam[:-1], [1e-12]])) @ Q.T).astype(np.float64)
    for mat, want in ((pd, True), (neg, False)):
        assert utils.is_pd(torch.from_numpy(mat)) is want
        assert utils.is_pd(mat) is want
        assert jutils.is_pd(jnp.asarray(mat)) is want
    assert utils.is_pd(torch.from_numpy(tiny), tol=1e-9) is False
    assert utils.is_pd(torch.from_numpy(tiny), tol=0.0) is True


def test_nystrom_preconditioner_matches_jax():
    """One call builds the same P⁻¹ as the JAX package's on the same start Ω
    (``jax.random.normal(key, (d, k))``, handed to the port), and it speeds
    up the port's batched CG."""
    from laplace_inducing_points_tpu_torch.ops.cg import cg_batched
    d, k, rho = 64, 8, 1e-2
    rng = np.random.default_rng(3)
    Qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    G = ((Qm * np.concatenate([np.logspace(3, 1, k), np.full(d - k, 1e-2)])) @ Qm.T)
    G = G.astype(np.float32)
    key = jax.random.PRNGKey(5)
    omega = np.array(jax.random.normal(key, (d, k), dtype=jnp.float32))
    ref = jny.nystrom_preconditioner(lambda V: V @ jnp.asarray(G).T, d, k, rho, key)
    Gt = torch.from_numpy(G)
    apply = ops.nystrom_preconditioner(lambda V: V @ Gt.T, d, k, rho, torch.from_numpy(omega))
    V = rng.standard_normal((3, d)).astype(np.float32)
    got = apply(torch.from_numpy(V)).numpy()
    want = np.asarray(ref(jnp.asarray(V)))
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    # drawn from a generator, it still deflates the top of the spectrum
    apply = ops.nystrom_preconditioner(lambda V: V @ Gt.T, d, k, rho,
                                       torch.Generator().manual_seed(0))
    B = torch.from_numpy(V)
    matmat = lambda X: X @ Gt.T + rho * X  # noqa: E731
    _, plain = cg_batched(matmat, B, tol=1e-5, maxiter=500)
    _, pre = cg_batched(matmat, B, tol=1e-5, maxiter=500, precond=apply)
    assert int(pre.iterations) < int(plain.iterations)


def test_device_iter_yields_the_loader_batches_as_tensors():
    loader = data.DataLoader(data.ArrayDataset(np.arange(40.0).reshape(10, 4), np.arange(10)),
                             3, drop_last=False)
    got = list(data.device_iter(loader, "cpu", prefetch=2, dtype=torch.float64))
    want = list(loader)
    assert len(got) == len(want) == 4
    for (x, y), (xw, yw) in zip(got, want):
        assert x.dtype == torch.float64 and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), xw)
        np.testing.assert_array_equal(y.numpy(), yw)
    assert list(data.device_iter([], "cpu")) == []
