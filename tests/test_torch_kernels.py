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
from laplace_inducing_points_tpu_torch.ops.cuda import sweep as tsweep
from laplace_inducing_points_tpu_torch.ops.cuda import syrk as tsyrk
from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep, ggn_sweep_plain
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


# m = 1 and z = 1 reach the row and rank paths on the card, m = 16 the small tiles
NT_SHAPES = [(16, 8, 64), (13, 21, 70), (8, 8, 32), (1, 21, 70), (16, 21, 75)]
NN_SHAPES = [(16, 8, 64), (11, 19, 75), (1, 19, 75), (13, 1, 70), (16, 19, 64)]


@pytest.mark.parametrize("m,n,D", NT_SHAPES)
def test_matmul_nt_matches_pallas_interpret(m, n, D):
    A, B = _randn(m, D, seed=1), _randn(n, D, seed=2)
    ref = _interpret(jmm._matmul_nt_pallas, jnp.asarray(A), jnp.asarray(B), 8, 8, 32)
    got = matmul_nt(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,z,D", NN_SHAPES)
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


def test_cpu_calls_count_no_path_launches():
    before = (dict(matmul_nt.path_launches), dict(matmul_nn.path_launches))
    A = torch.randn(1, 40, requires_grad=True)
    B = torch.randn(7, 40, requires_grad=True)
    W = torch.randn(40, 1)
    (matmul_nt(A, B).sum() + matmul_nn(W, A).sum()
     + matmul_nn(torch.randn(16, 7), B).sum()).backward()
    assert (matmul_nt.path_launches, matmul_nn.path_launches) == before
    assert set(matmul_nt.path_launches) == {"row", "tiled"}
    assert set(matmul_nn.path_launches) == {"row", "rank", "tiled"}


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


@pytest.mark.parametrize("m,n,D", NT_SHAPES)
def test_matmul_nt_vjp_matches_jax(interpret_pallas, m, n, D):
    A, B, ct = _randn(m, D, seed=7), _randn(n, D, seed=8), _randn(m, n, seed=9)
    ref, got = _vjps(lambda a, b: jmm._matmul_nt_diff(a, b, 8, 8, 32), matmul_nt,
                     [A, B], ct)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,z,D", NN_SHAPES)
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
    assert {p.name for p in _build.sources()} >= {"syrk.cu", "matmul.cu", "tiled.cuh",
                                                  "ggn_sweep.cu", "matmul_tiled.cu",
                                                  "matmul.cuh"}


@pytest.mark.cuda
@pytest.mark.parametrize("name,shapes", [
    ("syrk", [(77, 301)]),
    ("syrk", [(130, 3001)]),      # odd D: rows off a 16-byte boundary
    ("syrk", [(200, 600)]),       # D below one split's depth; d not a multiple of 64
    ("syrk", [(1000, 5000)]),     # split across blocks
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
    if name == "syrk":
        assert torch.equal(got, got.T)


@pytest.mark.cuda
@pytest.mark.parametrize("d,D", [(80, 626), (40, 321), (100, 4946), (1000, 626), (80, 61706)])
def test_syrk_diagonal_carries_no_coherent_error_on_cuda(d, D):
    """The Gram's diagonal is a sum of squares, whose tensor-core truncation
    loss the tiles' correction does not take back (before: -4.3e-8 to -5.0e-8 of
    it at every shape): its bias against float64 stays within phase 3's 1e-8
    floor, on normal and all-positive operands, split or not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run python3 chip_smoke.py there)")
    gen = torch.Generator(device="cuda").manual_seed(d + D)
    for A in (torch.randn(d, D, generator=gen, device="cuda"),
              torch.rand(d, D, generator=gen, device="cuda")):
        got = torch.diagonal(syrk(A)).double()
        ref = (A.double() ** 2).sum(dim=1)
        assert abs(float(torch.dot(got - ref, ref) / torch.dot(ref, ref))) <= 1e-8


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


# --- the kernel paths of B2 and B3: which shape takes which path ----------------
# LeNet5 widths (d_z = 1000, d_x = 1280, D = 61,706) on an H100: the geometry
# that the kernels' library reports there (chip_smoke.py prints it in phase 2).

D_LENET = 61706
H100 = tmm.Geometry(sms=132, row_max=8, rank_max=16, row_cols=512, tile_cols=128,
                    tile_rows=(32, 64), nt_blocks=(2, 1), nn_blocks=(2, 1), syrk_blocks=(2, 1))
PATH_SHAPES = {   # name -> (kind, m, n or z, long axis, path, tile rows)
    "slq_rz_v": ("nt", 1, 1000, D_LENET, "row", 0),
    "slq_backward_dA_nt": ("nt", 1, 1000, D_LENET, "row", 0),
    "woodbury_residual_nt": ("nt", 16, 1000, D_LENET, "tiled", 32),
    "woodbury_range_nt": ("nt", 240, 1000, D_LENET, "tiled", 64),
    "serving_eps_rt": ("nt", 200, 1000, D_LENET, "tiled", 64),
    "gxz": ("nt", 1280, 1000, D_LENET, "tiled", 64),
    "sweep_highest_nt": ("nt", 240, 1280, D_LENET, "tiled", 64),
    "slq_rzt_u": ("nn", 1, 1000, D_LENET, "row", 0),
    "slq_rank_one": ("nn", 1000, 1, D_LENET, "rank", 0),
    "woodbury_residual_nn": ("nn", 16, 1000, D_LENET, "tiled", 32),
    "woodbury_range_nn": ("nn", 240, 1000, D_LENET, "tiled", 64),
    "serving_push_back": ("nn", 200, 1000, D_LENET, "tiled", 64),
    "syrk_backward": ("nn", 1000, 1000, D_LENET, "tiled", 64),
    "gxz_backward_dB": ("nn", 1000, 1280, D_LENET, "tiled", 64),
    "woodbury_backward_dB": ("nn", 1000, 240, D_LENET, "tiled", 64),
}


@pytest.mark.parametrize("name", sorted(PATH_SHAPES))
def test_planner_sends_each_path_shape_to_its_path(name):
    kind, m, k, D, path, rows = PATH_SHAPES[name]
    plan = (tmm.nt_plan if kind == "nt" else tmm.nn_plan)(m, k, D, H100)
    assert (plan.path, plan.tile_rows) == (path, rows)
    assert plan.splits >= 1
    depth = D if kind == "nt" else k       # the contraction the splits share
    if plan.path == "tiled" and plan.splits > 1:
        assert depth // plan.splits >= tmm.MIN_SPLIT_DEPTH
    if plan.path == "row" and kind == "nn" and plan.splits > 1:
        assert depth // plan.splits >= tmm.ROW_MIN_DEPTH
    if plan.path in ("row", "rank") and kind == "nt":
        assert plan.splits == 1


@pytest.mark.parametrize("kind,m,k,D,splits", [
    ("nt", 200, 1000, D_LENET, 4),      # 32 tiles: one wave of 128 blocks
    ("nt", 240, 1000, D_LENET, 4),
    ("nt", 1280, 1000, D_LENET, 3),     # 160 tiles: 480 blocks, four waves 91% full
    ("nt", 16, 1000, D_LENET, 29),      # 8 small tiles: 232 blocks on 264 slots
    ("nt", 200, 1000, 3000, 2),         # short D: no block below 1024 of it
    ("nn", 200, 1000, D_LENET, 1),      # 1932 tiles fill the card unsplit
    ("nn", 1, 1000, D_LENET, 9),        # row path: 121 column blocks x 9
    ("nn", 1, 300, D_LENET, 4),         # row path: no block below 64 rows of z
])
def test_planner_splits(kind, m, k, D, splits):
    assert (tmm.nt_plan if kind == "nt" else tmm.nn_plan)(m, k, D, H100).splits == splits


@pytest.mark.parametrize("m,n", [(9, 1), (33, 1000), (500, 700), (4096, 4096)])
def test_tiled_splits_fill_the_waves(m, n):
    """A split plan keeps every wave WAVE_FILL full, unless the depth forbids
    more splits; without a split none is needed."""
    plan = tmm.nt_plan(m, n, D_LENET, H100)
    tiles = -(-m // plan.tile_rows) * -(-n // H100.tile_cols)
    slots = H100.nt_blocks[H100.tile_rows.index(plan.tile_rows)] * H100.sms
    blocks = tiles * plan.splits
    fill = blocks / (slots * -(-blocks // slots))
    assert fill >= tmm.WAVE_FILL or plan.splits == D_LENET // tmm.MIN_SPLIT_DEPTH


@pytest.mark.parametrize("nt_blocks,splits", [((2, 1), 4), ((2, 2), 8), ((2, 3), 11)])
def test_planner_follows_the_reported_occupancy(nt_blocks, splits):
    """The splits of serving's NT (32 tiles of 64 rows) follow the resident
    blocks per SM that the library reports, not a fixed table."""
    geo = H100._replace(nt_blocks=nt_blocks)
    assert tmm.nt_plan(200, 1000, D_LENET, geo).splits == splits


class _FakeLibrary:
    def __init__(self, report):
        self.report = report

    def lip_matmul_geometry(self, out):
        for i, v in enumerate(self.report):
            out[i] = v
        return 0


@pytest.mark.parametrize("blocks,ok", [((2, 1, 2, 1), True), ((2, 0, 2, 1), False)])
def test_geometry_reads_the_library_report(monkeypatch, blocks, ok):
    """``geometry`` turns the library's thirteen numbers into a Geometry, and
    refuses a tiled kernel that fits no block on an SM."""
    import contextlib
    report = (132, 8, 16, 512, 128, 32, 64, *blocks, 2, 1)
    monkeypatch.setattr(tmm, "load_library", lambda: _FakeLibrary(report))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    tmm.geometry.cache_clear()
    try:
        if ok:
            assert tmm.geometry(torch.device("cuda", 0)) == H100
        else:
            with pytest.raises(RuntimeError, match="fits no block"):
                tmm.geometry(torch.device("cuda", 0))
    finally:
        tmm.geometry.cache_clear()


@pytest.mark.parametrize("wrapper", ["matmul_nt", "matmul_nn"])
def test_calls_without_a_graph_skip_the_function(wrapper):
    """With no gradient to record, the wrappers compute the product without
    their autograd Function (no graph node); with one, through it."""
    fn, plain = ((matmul_nt, matmul_nt_plain) if wrapper == "matmul_nt"
                 else (matmul_nn, matmul_nn_plain))
    A = torch.randn(3, 40)
    B = torch.randn(7, 40) if wrapper == "matmul_nt" else torch.randn(40, 7)
    out = fn(A, B)
    assert out.grad_fn is None
    torch.testing.assert_close(out, plain(A, B), rtol=0, atol=0)
    Ag = A.clone().requires_grad_()
    with torch.no_grad():
        assert fn(Ag, B).grad_fn is None
    node = type(fn(Ag, B).grad_fn).__name__
    assert node.startswith("_MatmulN"), node


CUDA_PATH_CASES = [   # (kind, A shape, B shape, path, A offset in floats)
    ("nt", (1, 61706), (1000, 61706), "row", 0),
    ("nt", (1, 3001), (70, 3001), "row", 1),          # odd D, A 4 bytes off
    ("nt", (3, 3002), (130, 3002), "row", 2),         # D = 2 mod 4, A 8 bytes off
    ("nt", (16, 3001), (130, 3001), "tiled", 0),
    ("nt", (240, 3002), (1000, 3002), "tiled", 2),
    ("nn", (1, 1000), (1000, 3001), "row", 1),
    ("nn", (5, 45), (45, 1001), "row", 0),
    ("nn", (1000, 1), (1, 3001), "rank", 0),
    ("nn", (70, 3), (3, 1002), "rank", 2),
    ("nn", (13, 45), (45, 1001), "tiled", 0),
    ("nn", (240, 1000), (1000, 3002), "tiled", 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,sa,sb,path,offset", CUDA_PATH_CASES)
def test_each_path_matches_plain_on_cuda(kind, sa, sb, path, offset):
    """Each path against its plain version at odd D and rows that start off a
    16-byte boundary; the planner picks the path and its count rises by one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run python3 chip_smoke.py there)")
    buf = torch.randn(int(np.prod(sa)) + offset, device="cuda")
    A = buf[offset:].view(sa)
    B = torch.randn(*sb, device="cuda")
    fn, plain = ((matmul_nt, matmul_nt_plain) if kind == "nt"
                 else (matmul_nn, matmul_nn_plain))
    before = dict(fn.path_launches)
    got = fn(A, B)
    torch.cuda.synchronize()
    assert fn.path_launches[path] == before[path] + 1
    torch.testing.assert_close(got, plain(A, B), rtol=1e-5, atol=1e-4)


# --- B4, the GGN probe sweep ``scale·(V Rᵀ) R`` ------------------------------------
# Against JAX's ggn_sweep through its Pallas kernels (interpret mode, bit-exact
# f32 on the CPU) and through XLA; the gradients of the autograd Function
# against autograd of the plain version. rtol 1e-5 / atol 1e-4 as above: the
# products contract at most 83 terms here.

SWEEP_SHAPES = [(5, 7, 83, 1.0), (16, 8, 64, 3.5), (3, 11, 40, 0.25)]   # P, d, D, scale


@pytest.mark.parametrize("force_pallas", [True, False])
@pytest.mark.parametrize("P,d,D,scale", SWEEP_SHAPES)
def test_ggn_sweep_matches_jax(interpret_pallas, P, d, D, scale, force_pallas):
    V, R = _randn(P, D, seed=13), _randn(d, D, seed=14)
    ref = jmm.ggn_sweep(jnp.asarray(V), jnp.asarray(R), scale, force_pallas=force_pallas)
    for got in (ggn_sweep(torch.from_numpy(V), torch.from_numpy(R), scale),
                ggn_sweep(torch.from_numpy(V), torch.from_numpy(R), scale, precision="highest"),
                ggn_sweep_plain(torch.from_numpy(V), torch.from_numpy(R), scale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("precision", [None, "highest"])
@pytest.mark.parametrize("P,d,D,scale", SWEEP_SHAPES)
def test_ggn_sweep_gradients_match_plain_autograd(P, d, D, scale, precision):
    """dV = scale·(Ĉ Rᵀ) R and dR = scale·(Tᵀ Ĉ + (Ĉ Rᵀ)ᵀ V), both asked for."""
    V, R, ct = (torch.from_numpy(_randn(P, D, seed=15)), torch.from_numpy(_randn(d, D, seed=16)),
                torch.from_numpy(_randn(P, D, seed=17)))
    v, r = V.clone().requires_grad_(), R.clone().requires_grad_()
    got = torch.autograd.grad(ggn_sweep(v, r, scale, precision=precision), (v, r), ct)
    v0, r0 = V.clone().requires_grad_(), R.clone().requires_grad_()
    ref = torch.autograd.grad(ggn_sweep_plain(v0, r0, scale), (v0, r0), ct)
    for g, e in zip(got, ref):
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-4)


def test_ggn_sweep_gradient_in_v_alone_and_no_counts_on_cpu():
    """On the objective's path only the probes need a gradient: dR is not
    computed, and CPU calls count no launches."""
    before = (ggn_sweep.launches, ggn_sweep.backward_launches)
    V = torch.randn(4, 30, requires_grad=True)
    R = torch.randn(6, 30)
    (g,) = torch.autograd.grad(ggn_sweep(V, R, 2.0).square().sum(), V)
    torch.testing.assert_close(g, 2.0 * ggn_sweep_plain(2.0 * ggn_sweep_plain(V.detach(), R, 2.0),
                                                        R, 1.0), rtol=1e-5, atol=1e-4)
    assert (ggn_sweep.launches, ggn_sweep.backward_launches) == before
    with pytest.raises(RuntimeError, match="once_differentiable"):
        (gg,) = torch.autograd.grad(ggn_sweep(V, R).square().sum(), V, create_graph=True)
        gg.sum().backward()


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_ggn_sweep_refuses(bad):
    make, exc, match = BAD_INPUTS[bad]
    with pytest.raises(exc, match=match):
        ggn_sweep(make(), torch.randn(3, 6))
    with pytest.raises(ValueError, match="contraction"):
        ggn_sweep(torch.randn(4, 6), torch.randn(3, 7))
    with pytest.raises(ValueError, match="precision"):
        ggn_sweep(torch.randn(4, 6), torch.randn(3, 6), precision="tf32")


H100_SWEEP = tsweep.SweepGeometry(sms=132, tile=128, groups=(64, 256), blocks=(1, 1))


@pytest.mark.parametrize("P,d,D,group,splits", [
    (240, 1280, 61706, 256, 12),      # the Hutch++ range-finder sweep: 10 tiles, one wave
    (16, 1280, 61706, 64, 12),        # the residual sweep: the small group
    (240, 1280, 3000, 256, 11),       # short D: no block below 256 of it
    (300, 1280, 61706, 256, 6),       # P > 256: two groups, 20 tiles
    (2048, 1280, 61706, 256, 3),      # 80 tiles: 240 blocks, two waves 91% full
    (17, 70, 333, 64, 1),             # a ragged test shape: no split
])
def test_sweep_splits(P, d, D, group, splits):
    """The sweep planner's probe group and stage-1 split at the H100's
    geometry."""
    assert tsweep.sweep_plan(P, d, D, H100_SWEEP) == (group, splits)


@pytest.mark.parametrize("P,d", [(240, 1280), (16, 1280), (300, 1000), (64, 200), (65, 3000)])
def test_sweep_splits_fill_the_waves(P, d):
    """A split stage-1 plan keeps every wave WAVE_FILL full unless D forbids
    more splits, and no block contracts less than the sweep's MIN_SPLIT_DEPTH
    of D."""
    plan = tsweep.sweep_plan(P, d, D_LENET, H100_SWEEP)
    assert plan.group == (64 if P <= 64 else 256)
    tiles = -(-P // plan.group) * -(-d // H100_SWEEP.tile)
    slots = H100_SWEEP.blocks[plan.group != 64] * H100_SWEEP.sms
    blocks = tiles * plan.splits
    assert (blocks / (slots * -(-blocks // slots)) >= tmm.WAVE_FILL
            or plan.splits == D_LENET // tsweep.MIN_SPLIT_DEPTH)
    assert D_LENET // plan.splits >= tsweep.MIN_SPLIT_DEPTH


@pytest.mark.parametrize("blocks,ok", [((1, 1), True), ((1, 0), False)])
def test_sweep_geometry_reads_the_library_report(monkeypatch, blocks, ok):
    import contextlib

    class Library:
        def lip_sweep_geometry(self, out):
            for i, v in enumerate((132, 128, 64, 256, *blocks)):
                out[i] = v
            return 0

    monkeypatch.setattr(tsweep, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    tsweep.sweep_geometry.cache_clear()
    try:
        if ok:
            assert tsweep.sweep_geometry(torch.device("cuda", 0)) == H100_SWEEP
        else:
            with pytest.raises(RuntimeError, match="fits no block"):
                tsweep.sweep_geometry(torch.device("cuda", 0))
    finally:
        tsweep.sweep_geometry.cache_clear()


# --- B1, the Gram: which tiles and how many splits ---------------------------------

def _lower_tiles_brute(d, rows, cols):
    """The (row tile, column tile) pairs of a (d, d) Gram holding an element
    with row >= column."""
    return [(i, j) for i in range(-(-d // rows)) for j in range(-(-d // cols))
            if any(r >= c for r in range(i * rows, min(d, (i + 1) * rows))
                   for c in range(j * cols, min(d, (j + 1) * cols)))]


@pytest.mark.parametrize("rows,cols", [(64, 128), (32, 128), (64, 64), (128, 128)])
@pytest.mark.parametrize("d", [1, 63, 64, 65, 77, 200, 1000, 1280])
def test_syrk_lower_tiles_match_brute_force(d, rows, cols):
    assert tsyrk.lower_tiles(d, rows, cols) == len(_lower_tiles_brute(d, rows, cols))


@pytest.mark.parametrize("d,D,splits", [
    (1000, 61706, 5),     # 72 lower tiles: 360 blocks, three waves 91% full
    (1280, 61706, 6),     # 110 lower tiles (M = 128)
    (1000, 600, 1),       # D below one split's depth
    (77, 301, 1),
    (100, 61706, 57),     # 2 tiles: split as deep as MIN_SPLIT_DEPTH allows
])
def test_syrk_plan(d, D, splits):
    plan = tsyrk.syrk_plan(d, D, H100)
    assert plan == tmm.Plan("tiled", tsyrk.SYRK_TILE_ROWS, splits)


@pytest.mark.parametrize("d", [64, 200, 500, 1000, 1280, 3000])
def test_syrk_splits_fill_the_waves(d):
    plan = tsyrk.syrk_plan(d, D_LENET, H100)
    tiles = tsyrk.lower_tiles(d, plan.tile_rows, H100.tile_cols)
    slots = H100.syrk_blocks[H100.tile_rows.index(plan.tile_rows)] * H100.sms
    blocks = tiles * plan.splits
    assert (blocks / (slots * -(-blocks // slots)) >= tmm.WAVE_FILL
            or plan.splits == D_LENET // tmm.MIN_SPLIT_DEPTH)
    assert D_LENET // plan.splits >= tmm.MIN_SPLIT_DEPTH


@pytest.mark.cuda
@pytest.mark.parametrize("P,d,D", [(240, 130, 3001), (16, 70, 333), (5, 7, 83), (300, 70, 333)])
def test_ggn_sweep_matches_plain_on_cuda(P, d, D):
    """TF32 against FP32: relative Frobenius 2e-3, the TF32 rounding (2⁻¹¹
    per operand) over two products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run python3 chip_smoke.py there)")
    V = torch.randn(P, D, device="cuda", requires_grad=True)
    R = torch.randn(d, D, device="cuda")
    before = (ggn_sweep.launches, ggn_sweep.backward_launches)
    got = ggn_sweep(V, R, 0.5)
    ct = torch.randn_like(got)
    (g,) = torch.autograd.grad(got, V, ct)
    torch.cuda.synchronize()
    assert (ggn_sweep.launches, ggn_sweep.backward_launches) == (before[0] + 1, before[1] + 1)
    for x, ref in ((got, ggn_sweep_plain(V.detach(), R, 0.5)),
                   (g, ggn_sweep_plain(ct, R, 0.5))):
        assert float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref)) <= 2e-3
