"""Twin tests of the port's toy generators, their files and ``cli.make_data``.

The port draws its random numbers from a CPU ``torch.Generator``; the JAX
package from ``jax.random``. Tolerances, each with its reason:

* a generator handed the JAX generator's own draws (recorded in the order
  the JAX code makes them): points within 1e-6 absolute (float32 sin, cos
  and products in two libraries), labels exactly;
* each generator's own stream against JAX's at n = 20,000: the class balance
  and the mean and covariance of the points within 5 standard errors of the
  difference of two independent samples.
"""

import os

import jax
import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.cli import make_data as jmake_data
from laplace_inducing_points_tpu.data import toy as jtoy
from laplace_inducing_points_tpu_torch.cli import make_data
from laplace_inducing_points_tpu_torch.data import toy as ttoy

# name, generator keywords, n: every generator, each option that changes its
# draws, and banana at an odd n (its last point drawn twice, as in JAX)
CASES = {
    "sine": ("sine", {}, 200),
    "sine_split": ("sine", {"split_in_middle": True}, 201),
    "xor": ("xor", {}, 200),
    "spiral": ("spiral", {}, 200),
    "spiral_shuffled_ring_tail": ("spiral", {"shuffle": True, "ring_val_frac": 0.1}, 210),
    "ring": ("ring", {}, 200),
    "ring_r1p05": ("ring", {"radius": 1.05}, 200),
    "banana": ("banana", {}, 200),
    "banana_odd_n": ("banana", {}, 199),
}
DRAWS = ("uniform", "normal", "permutation", "bernoulli")


def _record(name, n, seed, noise, kwargs):
    """The JAX package's dataset and its draws, in the order it makes them: each
    ``jax.random`` draw's values (a permutation of an array as the indices it
    takes)."""
    calls, orig = [], {d: getattr(jax.random, d) for d in DRAWS}

    def recorder(kind):
        def draw(key, *args, **kw):
            out = orig[kind](key, *args, **kw)
            if kind == "permutation" and np.ndim(args[0]):
                calls.append((kind, np.asarray(orig[kind](key, np.shape(args[0])[0]))))
            else:
                calls.append((kind, np.asarray(out)))
            return out
        return draw

    for kind in DRAWS:
        setattr(jax.random, kind, recorder(kind))
    try:
        x, y = jtoy.create_dataset(name, n, jax.random.PRNGKey(seed), noise=noise, **kwargs)
    finally:
        for kind, fn in orig.items():
            setattr(jax.random, kind, fn)
    return np.asarray(x), np.asarray(y), calls


class ReplayDraws:
    """Hands a port generator recorded draws in order, checking each one's kind
    and shape against what the generator asks for."""

    def __init__(self, calls):
        self.calls = list(calls)

    def _next(self, kind, shape):
        got, values = self.calls.pop(0)
        assert got == kind and values.shape == tuple(shape), (got, values.shape, kind, shape)
        return torch.from_numpy(values.copy())

    def uniform(self, shape, low=0.0, high=1.0):
        return self._next("uniform", shape)

    def normal(self, shape):
        return self._next("normal", shape)

    def permutation(self, n):
        return self._next("permutation", (n,))

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape)


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_on_jax_draws_matches_jax(case, seed):
    name, kwargs, n = CASES[case]
    jx, jy, calls = _record(name, n, seed, 0.1, kwargs)
    replay = ReplayDraws(calls)
    merged = {**ttoy.CREATE_OVERRIDES.get(name, {}), **kwargs}
    x, y = ttoy.GENERATORS[name](n, replay, noise=0.1, **merged)
    assert not replay.calls, "the port's generator made fewer draws than JAX's"
    assert x.dtype == jx.dtype and x.shape == jx.shape
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-6)
    assert y.dtype == jy.dtype and y.shape == jy.shape
    if name == "sine":          # a regression target, not a label
        np.testing.assert_allclose(y, jy, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(y, jy)


def _moments(a: np.ndarray):
    """Mean and covariance of the rows of ``a`` with their squared standard
    errors."""
    a = a.astype(np.float64)
    n = a.shape[0]
    c = a - a.mean(axis=0)
    prods = c[:, :, None] * c[:, None, :]
    return a.mean(axis=0), a.var(axis=0) / n, prods.mean(axis=0), prods.var(axis=0) / n


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_stream_matches_jax_distribution(case):
    name, kwargs, _ = CASES[case]
    n = 20000
    jx, jy, _ = _record(name, n, 7, 0.1, kwargs)
    x, y = ttoy.create_dataset(name, n, 7, noise=0.1, **kwargs)
    if name == "sine":
        jx, x = np.concatenate([jx, jy], axis=1), np.concatenate([x, y], axis=1)
    else:
        p, q = y.mean(), jy.mean()
        se = np.sqrt((p * (1 - p) + q * (1 - q)) / n)
        assert abs(p - q) <= 5 * se, (p, q, se)
    (m1, s1, c1, t1), (m2, s2, c2, t2) = _moments(x), _moments(jx)
    assert np.all(np.abs(m1 - m2) <= 5 * np.sqrt(s1 + s2)), (m1, m2)
    assert np.all(np.abs(c1 - c2) <= 5 * np.sqrt(t1 + t2)), (c1, c2)


def test_port_file_is_regenerated_by_jax_and_read_by_the_port(tmp_path, capsys):
    """A file the port writes fails the JAX package's freshness check (JAX
    draws its own in its place); the port takes its own file and JAX's."""
    args = dict(n=300, noise=0.07, seed=5)
    path = ttoy.ensure_toy_npz("banana", data_dir=str(tmp_path), **args)
    assert path == str(tmp_path / "banana.npz")
    assert "drawn by the port's generator" in capsys.readouterr().out
    with np.load(path) as d:
        assert float(d["gen_version"]) == ttoy.PORT_GENERATOR_VERSION
        assert str(d["generator"]) == ttoy.PORT_GENERATOR
        ours = d["x"].copy()
    assert ttoy.ensure_toy_npz("banana", data_dir=str(tmp_path), **args) == path
    assert "drawn" not in capsys.readouterr().out          # taken, not drawn again
    jax_path = jtoy.ensure_toy_npz("banana", data_dir=str(tmp_path), **args)
    assert jax_path == path and "regenerating" in capsys.readouterr().out
    ref = np.asarray(jtoy.create_dataset("banana", 300, jax.random.PRNGKey(5), noise=0.07)[0])
    with np.load(path) as d:
        assert float(d["gen_version"]) == jtoy.GENERATOR_VERSION and "generator" not in d
        np.testing.assert_array_equal(d["x"], ref)
        assert not np.array_equal(d["x"], ours)
    assert ttoy.ensure_toy_npz("banana", data_dir=str(tmp_path), **args) == path
    assert "drawn" not in capsys.readouterr().out


def test_fixture_comes_before_generation(tmp_path):
    """At a fixture's parameters the port reads the committed file and writes
    nothing; at any other it draws its own."""
    path = ttoy.ensure_toy_npz("ring", data_dir=str(tmp_path), radius=2.0, fname="ring_r2")
    assert path == str(ttoy.FIXTURE_DIR / "ring_r2.npz") and not os.listdir(tmp_path)
    path = ttoy.ensure_toy_npz("ring", data_dir=str(tmp_path), radius=3.0, fname="ring_r3")
    assert path == str(tmp_path / "ring_r3.npz")
    x, _ = ttoy.load_dataset(path)
    np.testing.assert_array_equal(
        x, ttoy.create_dataset("ring", 512, 42, noise=0.05, radius=3.0)[0])
    assert np.all(np.linalg.norm(x, axis=1) > 2.8)


@pytest.mark.parametrize("dataset", sorted(ttoy.GENERATORS))
def test_make_data_writes_each_dataset(dataset, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = make_data.main(["--dataset", dataset, "--n_samples", "64", "--seed", "3", "--plot"])
    assert out == os.path.join("data", f"{dataset}.npz")
    x, y = ttoy.load_dataset(out)
    assert x.shape == ((64, 1) if dataset == "sine" else (64, 2)) and np.all(np.isfinite(x))
    assert y.shape == ((64, 1) if dataset == "sine" else (64,))
    expected = ttoy.create_dataset(dataset, 64, 3, noise=0.05,
                                   **({"split_in_middle": False} if dataset == "sine" else {}))
    np.testing.assert_array_equal(x, expected[0])
    printed = capsys.readouterr().out
    assert f"Saved {dataset} data at {out}" in printed
    assert (f"Saved figure fig/{dataset}.png" in printed) or "matplotlib not installed" in printed
    # the JAX CLI's defaults
    port, ref = make_data.build_parser(), jmake_data.build_parser()
    assert ({a.dest: a.default for a in port._actions}
            == {a.dest: a.default for a in ref._actions})
