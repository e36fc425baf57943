"""The gram Z step's value-and-grad replayed from one CUDA graph per ``Z``
(``training.inducing.optimize_step``): where it engages, its key, its
counters and what it returns.

On the CPU, and for every objective but the gram ones, the step runs eager
and touches no graph. On the card (tests marked ``cuda``; this file imports
no JAX, so ``python3 -m pytest --noconftest tests/test_torch_step_graph.py``
runs them there) the replayed step is held bitwise to the eager one: the
loss, ``dL/dZ``, ``Z`` and Adam's moments after five steps, and the kernels'
launch counters step by step; a capture that fails leaves the key eager with
one warning.
"""

import warnings

import pytest
import torch

from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.models.scale import LeNet5, ResNet1M
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier
from laplace_inducing_points_tpu_torch.training import inducing

COUNTERS = ("graph_captures", "graph_replays", "graph_fallbacks")


def _state(model, device="cpu"):
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(model), 3))
    return ModelState(model.to(device), flat.to(device), "classifier")


def _counters() -> dict:
    return {name: getattr(inducing.optimize_step, name) for name in COUNTERS + ("calls",)}


def _toy(seed: int, n: int) -> torch.Tensor:
    return torch.randn(n, 2, generator=torch.Generator().manual_seed(seed))


def _eager(Z, X, state, objective, probes):
    """``(loss, dL/dZ)`` of one step at alpha 0.5 and N = 100 straight through
    the objective's own function, as ``optimize_step`` computes it eager."""
    if objective == "dense":
        z = Z.detach().requires_grad_()
        with torch.enable_grad():
            value = inducing.kl_objective_dense(z, X, state, 0.5, full_set_size=100)
            (grad,) = torch.autograd.grad(value, z)
        return value.detach(), grad
    if objective == "stochastic":
        return inducing.kl_value_and_grad_stochastic(Z, X, state, 0.5, probes,
                                                     full_set_size=100, **STOCHASTIC)
    return inducing.kl_value_and_grad_gram(
        Z, X, state, 0.5, full_set_size=100,
        example_block=4 if objective == "gram_chunked" else None)


STOCHASTIC = {"st_samples": 8, "slq_samples": 2, "slq_num_matvecs": 4}


@pytest.mark.parametrize("objective", ["gram", "gram_chunked", "dense", "stochastic"])
def test_the_cpu_and_the_other_objectives_run_eager(objective):
    """No graph is captured or replayed on the CPU, nor for the dense and
    stochastic objectives, and the step's loss and Adam's step are those of
    the objective's own function."""
    state = _state(SimpleClassifier(8, 2, 3, 2))
    Z, X = _toy(1, 5), _toy(2, 9)
    probes = torch.randint(0, 2, (8, state.spec.num_params),
                           generator=torch.Generator().manual_seed(3)).float() * 2 - 1
    knobs = STOCHASTIC if objective == "stochastic" else {}
    before = _counters()
    Z_ref = Z.clone()
    opt, opt_ref = inducing.make_optimizer(Z, 1e-2), inducing.make_optimizer(Z_ref, 1e-2)
    for _ in range(3):
        loss = inducing.optimize_step(Z, X, state, 0.5, opt, objective=objective,
                                      full_set_size=100, probes=probes, **knobs)
        ref_loss, Z_ref.grad = _eager(Z_ref, X, state, objective, probes)
        opt_ref.step()
        Z_ref.grad = None
        assert torch.equal(loss, ref_loss)
        assert torch.equal(Z, Z_ref)
    after = _counters()
    assert {k: after[k] - before[k] for k in after} == {
        "graph_captures": 0, "graph_replays": 0, "graph_fallbacks": 0, "calls": 3}
    assert Z not in inducing._GRAPHS


def test_each_step_returns_a_loss_of_its_own():
    """The losses of a run stack to one value per step: none is a buffer that
    a later step overwrites."""
    state = _state(SimpleClassifier(8, 2, 3, 2))
    Z = _toy(1, 5)
    opt = inducing.make_optimizer(Z, 5e-2)
    losses = [inducing.optimize_step(Z, _toy(10 + i, 9), state, 0.5, opt, full_set_size=100)
              for i in range(4)]
    assert len({loss.data_ptr() for loss in losses}) == 4
    assert len(set(torch.stack(losses).tolist())) == 4


def test_the_graph_key():
    """A new batch at the same shape keeps the key; a new batch shape,
    example block, alpha, objective, ``Z`` or weight vector changes it."""
    state = _state(SimpleClassifier(8, 2, 3, 2))
    Z, X = _toy(1, 5), _toy(2, 9)
    common = {"objective": "gram", "full_set_size": 100, "example_block": None}

    def key(Z=Z, X=X, state=state, alpha=0.5, **kw):
        return inducing.graph_key(Z, X, state, alpha, **{**common, **kw})

    assert key() == key(X=_toy(3, 9))
    assert key(X=X.clone()) == key()
    changed = [key(X=_toy(2, 8)), key(example_block=2), key(alpha=0.25),
               key(objective="gram_chunked"), key(full_set_size=200), key(Z=Z.clone()),
               key(X=X.double()),
               key(state=ModelState(state.model, state.flat_params.clone(), "classifier"))]
    assert all(k != key() for k in changed)
    assert len(set(changed)) == len(changed)


# --- on the card --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy
    set_f32_policy(torch.device("cuda"))


def _graph_step(Z, X, state, alpha, **kwargs):
    return inducing._gram_value_and_grad(Z, X, state, alpha, "gram", **kwargs)


def _run(step, Z, batches, state, alpha, lr=5e-3, **kwargs):
    """One step of ``step`` with Adam per batch: each step's loss, ``dL/dZ`` and the
    kernel launches it counted; Adam's state after the last."""
    opt = inducing.make_optimizer(Z, lr)
    losses, grads, launches = [], [], []
    for X in batches:
        before = inducing._kernel_counts()
        loss, grad = step(Z, X, state, alpha, **kwargs)
        launches.append(inducing._counts_since(before))
        losses.append(loss)
        grads.append(grad.clone())
        Z.grad = grad
        opt.step()
        Z.grad = None
    return losses, grads, launches, opt.state[Z]


CARD_CASES = {
    # net, M, batch, example block
    "lenet5": (LeNet5, 9, 16, None, (28, 28, 1)),
    "resnet1m_blocked": (lambda: ResNet1M(10), 5, 4, 2, (32, 32, 3)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_the_replayed_step_is_the_eager_step_bitwise_on_cuda(case):
    """Five steps through the graph (eager, capture and replay, three
    replays) against five eager ones from the same points: the same loss,
    ``dL/dZ`` and kernel launches at every step, the same ``Z`` and Adam
    moments after; ResNet1M's M = 5 in blocks of 2 ends on a short block."""
    _cuda()
    make, M, n, block, shape = CARD_CASES[case]
    state = _state(make(), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    Z0 = torch.rand(M, *shape, device="cuda", generator=gen)
    batches = [torch.rand(n, *shape, device="cuda", generator=gen) for _ in range(5)]
    knobs = {"full_set_size": 60000, "example_block": block}
    before = _counters()
    Zg, Ze = Z0.clone(), Z0.clone()
    got = _run(_graph_step, Zg, batches, state, 0.005, **knobs)
    after = _counters()
    ref = _run(inducing.kl_value_and_grad_gram, Ze, batches, state, 0.005, **knobs)
    assert {k: after[k] - before[k] for k in COUNTERS} == {
        "graph_captures": 1, "graph_replays": 4, "graph_fallbacks": 0}
    for loss, ref_loss in zip(got[0], ref[0]):
        assert torch.equal(loss, ref_loss)
    for grad, ref_grad in zip(got[1], ref[1]):
        assert torch.equal(grad, ref_grad)
    assert got[2] == ref[2] and all(got[2])
    assert torch.equal(Zg, Ze)
    for moment in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(got[3][moment], ref[3][moment])
    assert len({loss.data_ptr() for loss in got[0]}) == 5
    del inducing._GRAPHS[Zg]


@pytest.mark.cuda
def test_optimize_step_replays_and_counts_on_cuda():
    """Through ``optimize_step``: one capture at the second call, replays
    after, a new batch shape captures anew; a ``Z`` that goes takes its
    graph along, and the trainer drops its ``Z``'s graph when it returns."""
    _cuda()
    state = _state(LeNet5(), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    Z = torch.rand(4, 28, 28, 1, device="cuda", generator=gen)
    opt = inducing.make_optimizer(Z, 5e-3)
    before = _counters()
    for n in (8, 8, 8, 6, 6, 6):
        X = torch.rand(n, 28, 28, 1, device="cuda", generator=gen)
        inducing.optimize_step(Z, X, state, 0.005, opt, full_set_size=60000)
    after = _counters()
    assert {k: after[k] - before[k] for k in after} == {
        "graph_captures": 2, "graph_replays": 4, "graph_fallbacks": 0, "calls": 6}
    assert Z in inducing._GRAPHS
    held = len(inducing._GRAPHS)
    del Z, opt
    assert len(inducing._GRAPHS) == held - 1
    batches = iter([(torch.rand(8, 28, 28, 1, device="cuda", generator=gen), None)
                    for _ in range(3)])
    inducing.train_inducing_points(state, torch.rand(4, 28, 28, 1, device="cuda",
                                                     generator=gen),
                                   batches, alpha=0.005, num_steps=3, lr=5e-3,
                                   full_set_size=60000)
    assert inducing.optimize_step.graph_captures == after["graph_captures"] + 1
    assert len(inducing._GRAPHS) == held - 1


@pytest.mark.cuda
def test_a_capture_that_fails_falls_back_once_on_cuda(monkeypatch):
    """An operation that refuses capture (a host read of the Gram) makes the
    key eager: one warning, ``graph_fallbacks`` 1, no capture or replay
    counted, the eager results bitwise, the caller's stream restored and
    the void capture's memory given back."""
    _cuda()
    core = inducing._kl_core

    def host_read(Gzz, *args, **kwargs):
        float(Gzz[0, 0])
        return core(Gzz, *args, **kwargs)

    monkeypatch.setattr(inducing, "_kl_core", host_read)
    state = _state(LeNet5(), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    Z0 = torch.rand(8, 28, 28, 1, device="cuda", generator=gen)
    batches = [torch.rand(32, 28, 28, 1, device="cuda", generator=gen) for _ in range(4)]
    knobs = {"full_set_size": 60000, "example_block": None}
    Zg, Ze = Z0.clone(), Z0.clone()
    ref = _run(inducing.kl_value_and_grad_gram, Ze, batches, state, 0.005, **knobs)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    before = _counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = _run(_graph_step, Zg, batches, state, 0.005, **knobs)
    after = _counters()
    fallbacks = [w for w in caught if "could not be captured" in str(w.message)]
    assert len(fallbacks) == 1
    assert {k: after[k] - before[k] for k in COUNTERS} == {
        "graph_captures": 0, "graph_replays": 0, "graph_fallbacks": 1}
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert all(torch.equal(a, b) for a, b in zip(got[0], ref[0]))
    assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    assert got[2] == ref[2]
    assert torch.equal(Zg, Ze)
    # the void capture's memory pool is given back, but for cuBLAS's
    # workspace of the capture's stream
    del inducing._GRAPHS[Zg]
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() - base <= 64 * 2**20, (base, torch.cuda.memory_reserved())
