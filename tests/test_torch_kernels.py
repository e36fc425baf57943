"""The port's SYRK / NT / NN kernels: plain versions against the JAX Pallas
kernels, their gradients against the JAX custom VJPs, and the wrappers'
contract.

On the CPU the wrappers compute their plain versions; the Pallas kernels run
in interpret mode, as ``tests/test_syrk.py`` and
``tests/test_matmul_kernels.py`` run them. The CUDA kernels themselves run
only on a GPU: the tests marked ``cuda`` compare them with the plain versions
there and skip elsewhere (``python3 chip_smoke.py`` is the full check).
"""

import functools

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.ops.pallas import matmul as jmm
from laplace_inducing_points_tpu.ops.pallas import syrk as jsyrk
from laplace_inducing_points_tpu_torch.ops.cuda import _build
from laplace_inducing_points_tpu_torch.ops.cuda import matmul as tmm
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                               matmul_nn_plain,
                                                               matmul_nt,
                                                               matmul_nt_plain)
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk, syrk_plain

WRAPPERS = {"syrk": syrk, "matmul_nt": matmul_nt, "matmul_nn": matmul_nn}


def _interpret(fn, *args):
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        return np.asarray(fn.__wrapped__(*args))
    finally:
        pl.pallas_call = orig


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(16, 64), (24, 70), (8, 32)])
def test_syrk_matches_pallas_interpret(shape):
    A = _randn(*shape)
    ref = _interpret(jsyrk._syrk_pallas, jnp.asarray(A), 8, 32)
    got = syrk(torch.from_numpy(A))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(syrk_plain(torch.from_numpy(A)).numpy(), ref,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,n,D", [(16, 8, 64), (13, 21, 70), (8, 8, 32)])
def test_matmul_nt_matches_pallas_interpret(m, n, D):
    A, B = _randn(m, D, seed=1), _randn(n, D, seed=2)
    ref = _interpret(jmm._matmul_nt_pallas, jnp.asarray(A), jnp.asarray(B), 8, 8, 32)
    got = matmul_nt(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,z,D", [(16, 8, 64), (11, 19, 75)])
def test_matmul_nn_matches_pallas_interpret(m, z, D):
    A, B = _randn(m, z, seed=3), _randn(z, D, seed=4)
    ref = _interpret(jmm._matmul_nn_pallas, jnp.asarray(A), jnp.asarray(B), 8, 32, 8)
    got = matmul_nn(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_cpu_calls_never_count_launches():
    before = {name: fn.launches for name, fn in WRAPPERS.items()}
    A, B = torch.randn(5, 40), torch.randn(7, 40)
    syrk(A)
    matmul_nt(A, B)
    matmul_nn(A, B.T.contiguous())
    assert {name: fn.launches for name, fn in WRAPPERS.items()} == before


def test_cpu_backward_never_counts_launches():
    before = {name: fn.backward_launches for name, fn in WRAPPERS.items()}
    A = torch.randn(5, 40, requires_grad=True)
    B = torch.randn(7, 40, requires_grad=True)
    W = torch.randn(40, 7, requires_grad=True)
    (syrk(A).sum() + matmul_nt(A, B).sum() + matmul_nn(A, W).sum()).backward()
    assert A.grad is not None and B.grad is not None and W.grad is not None
    assert {name: fn.backward_launches for name, fn in WRAPPERS.items()} == before


# --- gradients: each Function's VJP against the JAX custom VJP, the Pallas
# forward in interpret mode. rtol 1e-5 / atol 1e-4 as for the forward: the
# cotangent products contract at most 70 terms here, summed in another order.

@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX custom VJPs over the Pallas kernels in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                             interpret=True))
    monkeypatch.setattr(jsyrk, "_syrk_pallas", jsyrk._syrk_pallas.__wrapped__)
    monkeypatch.setattr(jmm, "_matmul_nt_pallas", jmm._matmul_nt_pallas.__wrapped__)
    monkeypatch.setattr(jmm, "_matmul_nn_pallas", jmm._matmul_nn_pallas.__wrapped__)


def _vjps(jax_fn, torch_fn, inputs, ct):
    """(JAX cotangents, port cotangents) of the same inputs and cotangent."""
    out, pull = jax.vjp(jax_fn, *(jnp.asarray(a) for a in inputs))
    ref = [np.asarray(g) for g in pull(jnp.asarray(ct))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = torch.autograd.grad(torch_fn(*leaves), leaves, torch.from_numpy(ct))
    np.testing.assert_allclose(torch_fn(*leaves).detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-4)
    return ref, [g.numpy() for g in got]


@pytest.mark.parametrize("shape", [(16, 64), (24, 70), (8, 32)])
def test_syrk_vjp_matches_jax(interpret_pallas, shape):
    A, ct = _randn(*shape, seed=5), _randn(shape[0], shape[0], seed=6)
    ref, got = _vjps(lambda a: jsyrk._syrk_diff(a, 8, 32), syrk, [A], ct)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,n,D", [(16, 8, 64), (13, 21, 70), (8, 8, 32)])
def test_matmul_nt_vjp_matches_jax(interpret_pallas, m, n, D):
    A, B, ct = _randn(m, D, seed=7), _randn(n, D, seed=8), _randn(m, n, seed=9)
    ref, got = _vjps(lambda a, b: jmm._matmul_nt_diff(a, b, 8, 8, 32), matmul_nt,
                     [A, B], ct)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,z,D", [(16, 8, 64), (11, 19, 75)])
def test_matmul_nn_vjp_matches_jax(interpret_pallas, m, z, D):
    A, B, ct = _randn(m, z, seed=10), _randn(z, D, seed=11), _randn(m, D, seed=12)
    ref, got = _vjps(lambda a, b: jmm._matmul_nn_diff(a, b, 8, 32, 8), matmul_nn,
                     [A, B], ct)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("need_a,need_b", [(True, False), (False, True)])
@pytest.mark.parametrize("name", ["matmul_nt", "matmul_nn"])
def test_backward_computes_only_the_gradients_asked_for(name, need_a, need_b):
    """The cross-Gram's rows Rx never require grad: their cotangent product
    (a long contraction) must not run at all."""
    vjp = {"matmul_nt": tmm.matmul_nt_vjp, "matmul_nn": tmm.matmul_nn_vjp}[name]
    A, B = _args(name, torch.randn(4, 6))
    C = WRAPPERS[name](A, B)
    dA, dB = vjp(A, B, torch.randn_like(C), need_a, need_b)
    assert (dA is None) != need_a and (dB is None) != need_b
    a = A.clone().requires_grad_(need_a)
    b = B.clone().requires_grad_(need_b)
    WRAPPERS[name](a, b).sum().backward()
    assert (a.grad is None) != need_a and (b.grad is None) != need_b


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_backward_refuses_double_differentiation(name):
    """The backward runs the kernels, which record no graph: asking for a
    second derivative raises instead of returning a silent zero."""
    A = torch.randn(4, 6, requires_grad=True)
    args = (A,) + _args(name, A)[1:]
    (g,) = torch.autograd.grad(WRAPPERS[name](*args).square().sum(), A, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def _args(name, A):
    """Valid companions for a first operand ``A`` of wrapper ``name``."""
    if name == "syrk":
        return (A,)
    if name == "matmul_nt":
        return (A, torch.randn(3, A.shape[-1]))
    return (A, torch.randn(A.shape[-1], 9))


BAD_INPUTS = {
    "float64": (lambda: torch.randn(4, 6, dtype=torch.float64), TypeError, "float32"),
    "non_contiguous": (lambda: torch.randn(6, 4).T, ValueError, "contiguous"),
    "rank_3": (lambda: torch.randn(2, 4, 6), ValueError, "matrix"),
    "empty": (lambda: torch.randn(0, 6), ValueError, "empty"),
}


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_refuse(name, bad):
    make, exc, match = BAD_INPUTS[bad]
    with pytest.raises(exc, match=match):
        WRAPPERS[name](*_args(name, make()))


def test_requires_grad_is_accepted_outside_grad_mode():
    A = torch.randn(4, 6, requires_grad=True)
    with torch.no_grad():
        torch.testing.assert_close(syrk(A), syrk_plain(A))


@pytest.mark.parametrize("name", ["matmul_nt", "matmul_nn"])
def test_matmuls_refuse_mismatched_contraction(name):
    with pytest.raises(ValueError, match="contraction"):
        WRAPPERS[name](torch.randn(4, 6), torch.randn(5, 7))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Nothing falls back: without the CUDA toolkit the build raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(tmp_path / "lib.so")


def test_library_name_tracks_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert {p.name for p in _build.sources()} >= {"syrk.cu", "matmul.cu", "gemm_f32.cuh"}


@pytest.mark.cuda
@pytest.mark.parametrize("name,shapes", [
    ("syrk", [(77, 301)]),
    ("matmul_nt", [(13, 333), (70, 333)]),
    ("matmul_nn", [(13, 45), (45, 1001)]),
])
def test_kernel_matches_plain_on_cuda(name, shapes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run python3 chip_smoke.py there)")
    plain = {"syrk": syrk_plain, "matmul_nt": matmul_nt_plain,
             "matmul_nn": matmul_nn_plain}[name]
    args = [torch.randn(*s, device="cuda") for s in shapes]
    before = WRAPPERS[name].launches
    got = WRAPPERS[name](*args)
    torch.cuda.synchronize()
    assert WRAPPERS[name].launches == before + 1
    torch.testing.assert_close(got, plain(*args), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shapes", [
    ("syrk", [(77, 301)]),
    ("matmul_nt", [(13, 333), (70, 333)]),
    ("matmul_nn", [(13, 45), (45, 1001)]),
])
def test_backward_matches_plain_on_cuda(name, shapes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run python3 chip_smoke.py there)")
    plain = {"syrk": syrk_plain, "matmul_nt": matmul_nt_plain,
             "matmul_nn": matmul_nn_plain}[name]
    args = [torch.randn(*s, device="cuda", requires_grad=True) for s in shapes]
    out = WRAPPERS[name](*args)
    ct = torch.randn_like(out)
    before = WRAPPERS[name].backward_launches
    got = torch.autograd.grad(out, args, ct)
    torch.cuda.synchronize()
    assert WRAPPERS[name].backward_launches == before + (1 if name == "syrk" else 2)
    for g, r in zip(got, torch.autograd.grad(plain(*args), args, ct)):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-4)
