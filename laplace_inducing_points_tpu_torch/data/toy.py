"""Toy datasets: the generators, the npz files, their split and their
freshness check.

Counterpart of ``laplace_inducing_points_tpu/data/toy.py``: the generators
``sine_fn`` … ``banana_dataset``, ``GENERATORS``, ``CREATE_OVERRIDES`` and
``create_dataset`` (``:21-231``), ``save_dataset``, ``load_dataset``,
``train_test_val_split`` (``:234-242``), ``ring_cache_fname`` (``:245``),
``ensure_toy_npz`` (``:256-288``) and ``mnist_pca_subset`` (``:291``).

The generators compute what the JAX package's compute, but their random
numbers come from a seeded CPU ``torch.Generator`` (:class:`TorchDraws`), so
one seed gives the same points on every machine; the JAX package's
``jax.random`` streams are not reproduced. Every uniform, normal, permutation
and Bernoulli draw goes through the ``draws`` argument, in the JAX
generator's order, so a test can hand a generator the JAX package's own
draws.

``ensure_toy_npz`` looks for a file whose stored generation parameters
(``n``, ``noise``, ``seed``, ``gen_version``, ``gen_kwargs``) are the ones
asked for: in ``data_dir``, then among the files the JAX package wrote and
the repository commits under ``data/fixtures/toy/``
(``scripts/write_toy_fixtures.py``); only then does it generate. A file the
port writes carries its own ``gen_version`` and a ``generator`` key, so the
JAX package's freshness check regenerates it rather than taking the port's
stream for its own; the port takes both.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# the JAX package's GENERATOR_VERSION: a file from other generator code is stale
GENERATOR_VERSION = 2

# the port's generators: their own version number, disjoint from the JAX
# package's, and the name stored beside it in every file they write
PORT_GENERATOR_VERSION = 1001
PORT_GENERATOR = "laplace_inducing_points_tpu_torch: torch.Generator (CPU)"

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "data" / "fixtures" / "toy"


class TorchDraws:
    """The generators' random numbers, from a CPU ``torch.Generator`` seeded
    with ``seed``: float32 uniforms on ``[low, high)``, standard normals, a
    permutation of ``range(n)`` and Bernoulli booleans."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def uniform(self, shape, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
        return low + (high - low) * torch.rand(shape, generator=self.generator)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator)

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator) < p


def _out(x: torch.Tensor, y: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    return x.numpy(), y.numpy()


def sine_fn(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(2 * x) + x * torch.cos(5 * x)


def sine_dataset(n: int, draws, noise: float = 0.5, split_in_middle: bool = False):
    """``y = sine_fn(x) + noise·ε`` on ``x`` uniform over [-4, 3), or with
    ``split_in_middle`` over [-4, -1) and [0, 3) (half each, shuffled)."""
    if split_in_middle:
        x = torch.cat([draws.uniform((n // 2, 1), -4.0, -1.0),
                       draws.uniform((n - n // 2, 1), 0.0, 3.0)])
        x = x[draws.permutation(n)]
    else:
        x = draws.uniform((n, 1), -4.0, 3.0)
    return _out(x, sine_fn(x) + noise * draws.normal((n, 1)))


def xor_dataset(n: int, draws, noise: float = 0.05):
    """Corners of the unit square, class 1 where exactly one coordinate is 1,
    plus ``noise·ε``."""
    x = (draws.uniform((n, 2)) > 0.5).float()
    y = (x.sum(dim=1) == 1).int()
    return _out(x + noise * draws.normal((n, 2)), y)


def noisy_spiral_dataset(n: int, draws, noise: float = 0.05):
    """Unshuffled two-arm spiral (class 0 first half, class 1 second)."""
    if n % 2:
        raise ValueError(f"the spiral needs an even n (two equal arms), got {n}")
    half = n // 2
    r = draws.uniform((half, 1))
    theta = r * 3.0 * math.pi
    arm0 = torch.cat([r * torch.cos(theta), r * torch.sin(theta)], dim=1)
    arm1 = torch.cat([r * torch.cos(theta + math.pi), r * torch.sin(theta + math.pi)], dim=1)
    arm0 = arm0 + noise * draws.normal(arm0.shape)
    arm1 = arm1 + noise * draws.normal(arm1.shape)
    y = torch.cat([torch.zeros(half), torch.ones(half)]).int()
    return _out(torch.cat([arm0, arm1]), y)


def spiral_dataset(n: int, draws, noise: float = 0.05, ring_val_frac: float = 0.0,
                   shuffle: bool = False):
    """The spiral for ``n - n_val`` points (shuffled when ``shuffle``), then a
    radius-1.05 ring for the last ``n_val = ring_val_frac·n`` (one more when
    that leaves the spiral an odd count), unshuffled so that the sequential
    80/10/10 split puts the ring in the validation set."""
    n_val = int(ring_val_frac * n)
    if n_val > 0 and (n - n_val) % 2:
        n_val += 1
    n_spiral = n - n_val
    x, y = noisy_spiral_dataset(n_spiral, draws, noise)
    if shuffle:
        perm = draws.permutation(n_spiral).numpy()
        x, y = x[perm], y[perm]
    if n_val == 0:
        return x, y
    x_rg, y_rg = ring_dataset(n_val, draws, radius=1.05, width=0.15, noise=noise)
    return np.concatenate([x, x_rg]), np.concatenate([y, y_rg])


def ring_dataset(n: int, draws, radius: float = 1.05, width: float = 0.15,
                 noise: float = 0.02):
    """Annulus ``[radius, radius + width]`` plus ``noise·ε``, with random
    labels (an out-of-distribution set)."""
    r = radius + draws.uniform((n, 1)) * width
    theta = draws.uniform((n, 1)) * 2.0 * math.pi
    x = torch.cat([r * torch.cos(theta), r * torch.sin(theta)], dim=1)
    x = x + noise * draws.normal(x.shape)
    return _out(x, draws.bernoulli(0.5, (n,)).int())


def banana_dataset(n: int, draws, noise: float = 0.05):
    """Two interleaved cosine arches with a line (class 1) and a blob (class
    0), shuffled."""
    half = n // 2
    # class 1: a cosine arch shifted down, then a short slanted line
    arch_n = int(half * 0.8)
    ax = draws.uniform((arch_n, 1), -1.0, 1.0)
    arch = torch.cat([ax, torch.cos(1.5 * ax) - 0.7], dim=1)
    arch = arch + noise * draws.normal((arch_n, 2))
    line_n = half - arch_n
    lx = draws.uniform((line_n, 1), 0.0, 1.0)
    line = torch.cat([lx, 1.5 - 0.2 * lx], dim=1)
    line = line + noise * draws.normal((line_n, 2))
    # class 0: a wider cosine arch, then a blob underneath
    arch_n = int(half * 0.6)
    bx = draws.uniform((arch_n, 1), -1.0, 1.1)
    barch = torch.cat([bx, torch.cos(1.6 * bx)], dim=1)
    barch = barch + noise * draws.normal((arch_n, 2))
    blob_n = half - arch_n
    cx = draws.uniform((blob_n, 1), -0.4, 0.5)
    cy = noise * 1.5 * draws.normal((blob_n, 1)) - 0.5
    blob = torch.cat([cx, cy], dim=1)
    blob = blob + noise * draws.normal((blob_n, 2))
    x = torch.cat([arch, line, barch, blob])
    y = torch.cat([torch.ones(half), torch.zeros(half)]).int()
    # at an odd n the 2·half points are indexed by a permutation of n: the
    # reference's gather clamps the index 2·half to the last point, and so
    # does this one
    perm = draws.permutation(n).clamp(max=2 * half - 1)
    return _out(x[perm], y[perm])


GENERATORS = {
    "sine": sine_dataset,
    "xor": xor_dataset,
    "spiral": spiral_dataset,
    "ring": ring_dataset,
    "banana": banana_dataset,
}

TOY_DATASETS = tuple(GENERATORS)

# keyword arguments the reference's data CLI fixes per dataset: the standalone
# ring is drawn at radius 2.0 (the generator's own default is 1.05); the
# caller's keywords still win
CREATE_OVERRIDES = {"ring": {"radius": 2.0}}


def create_dataset(name: str, n: int, seed: int, noise: float = 0.05, **kwargs):
    """Toy dataset ``name`` of ``n`` points drawn from ``TorchDraws(seed)``:
    ``(x float32, y)`` as numpy arrays."""
    if name not in GENERATORS:
        raise ValueError(f"unknown toy dataset: {name}")
    merged = {**CREATE_OVERRIDES.get(name, {}), **kwargs}
    return GENERATORS[name](n, TorchDraws(seed), noise=noise, **merged)


def save_dataset(x, y, path: str, **meta) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, x=np.asarray(x), y=np.asarray(y),
             **{k: np.asarray(v) for k, v in meta.items()})


def load_dataset(path: str) -> tuple[np.ndarray, np.ndarray]:
    data = np.load(path)
    return np.asarray(data["x"]), np.asarray(data["y"])


def train_test_val_split(x, y, fractions=(0.8, 0.10, 0.10)):
    """80/10/10 split, in order."""
    n = x.shape[0]
    n_train = int(fractions[0] * n)
    n_test = n_train + int(fractions[1] * n)
    return ((x[:n_train], y[:n_train]),
            (x[n_train:n_test], y[n_train:n_test]),
            (x[n_test:], y[n_test:]))


def ring_cache_fname(radius: float) -> str:
    """File name of the OOD ring at ``radius`` (dots become 'p')."""
    return f"ring_r{radius:g}".replace(".", "p")


def _fresh(path: Path, n: int, noise: float, seed: int, kwargs_repr: str) -> bool:
    with np.load(path) as d:
        ours = "generator" in d and str(d["generator"]) == PORT_GENERATOR
        version = PORT_GENERATOR_VERSION if ours else GENERATOR_VERSION
        fresh = all(k in d and float(d[k]) == float(v)
                    for k, v in dict(n=n, noise=noise, seed=seed, gen_version=version).items())
        return fresh and "gen_kwargs" in d and str(d["gen_kwargs"]) == kwargs_repr


def ensure_toy_npz(name: str, data_dir: str = "data", n: int = 512,
                   noise: float = 0.05, seed: int = 42,
                   fname: Optional[str] = None, **kwargs) -> str:
    """The path of the npz holding toy dataset ``name`` at these generation
    parameters: ``{data_dir}/{fname or name}.npz`` if it holds them, else the
    committed fixture of that name if it does, else that file in
    ``data_dir``, drawn by the port's generator and written."""
    if name not in GENERATORS:
        raise ValueError(f"unknown toy dataset: {name}")
    kwargs_repr = repr(sorted(kwargs.items()))
    path = Path(data_dir) / f"{fname or name}.npz"
    for candidate in (path, FIXTURE_DIR / path.name):
        if candidate.exists() and _fresh(candidate, n, noise, seed, kwargs_repr):
            return str(candidate)
    x, y = create_dataset(name, n, seed, noise=noise, **kwargs)
    save_dataset(x, y, str(path), n=n, noise=noise, seed=seed,
                 gen_version=PORT_GENERATOR_VERSION, gen_kwargs=kwargs_repr,
                 generator=PORT_GENERATOR)
    print(f"[data] {path}: {name} drawn by the port's generator (n={n}, noise={noise}, "
          f"seed={seed}, kwargs={kwargs_repr}); no file in {data_dir} or {FIXTURE_DIR} "
          f"held these parameters")
    return str(path)


def mnist_pca_subset(classes=(8, 9), n_components: int = 2, data_dir: str = "data",
                     max_per_class: int = 1000, seed: int = 0):
    """Binary MNIST subset projected onto its top principal components, as
    ``(float32 points, int32 labels)``."""
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays

    x_img, y_img = load_arrays("mnist", train=True, root=data_dir)
    mask = np.isin(y_img, classes)
    x_img, y_img = x_img[mask], y_img[mask]
    rng = np.random.default_rng(seed)
    keep = []
    for c in classes:
        idx = np.nonzero(y_img == c)[0]
        rng.shuffle(idx)
        keep.append(idx[:max_per_class])
    keep = np.concatenate(keep)
    rng.shuffle(keep)
    flat = x_img[keep].reshape(len(keep), -1)
    labels = np.searchsorted(np.sort(classes), y_img[keep]).astype(np.int32)
    flat = flat - flat.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:n_components].T
    proj = proj / (proj.std(axis=0, keepdims=True) + 1e-8)
    return proj.astype(np.float32), labels
