"""Toy datasets: the npz files, their split and their freshness check.

Counterpart of ``laplace_inducing_points_tpu/data/toy.py``: ``save_dataset``,
``load_dataset``, ``train_test_val_split`` (``:234-242``), ``ring_cache_fname``
(``:245``), ``ensure_toy_npz`` (``:256-288``) and ``mnist_pca_subset``
(``:291``), in numpy. The generators draw from ``jax.random`` and are not
ported: the data comes from npz files that the JAX package wrote, committed
under ``data/fixtures/toy/`` (``scripts/write_toy_fixtures.py``). A file is
used only when the generation parameters stored in it (``n``, ``noise``,
``seed``, ``gen_version``, ``gen_kwargs``) are the ones asked for, the check
the JAX package makes before it regenerates.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

TOY_DATASETS = ("sine", "xor", "spiral", "ring", "banana")

# the JAX package's GENERATOR_VERSION: a file from other generator code is stale
GENERATOR_VERSION = 2

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "data" / "fixtures" / "toy"

WRITE_COMMAND = ("python -m laplace_inducing_points_tpu.cli.make_data (or "
                 "scripts/write_toy_fixtures.py), run where JAX is installed")


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
    d = np.load(path)
    fresh = all(k in d and float(d[k]) == float(v)
                for k, v in dict(n=n, noise=noise, seed=seed,
                                 gen_version=GENERATOR_VERSION).items())
    return fresh and "gen_kwargs" in d and str(d["gen_kwargs"]) == kwargs_repr


def ensure_toy_npz(name: str, data_dir: str = "data", n: int = 512,
                   noise: float = 0.05, seed: int = 42,
                   fname: Optional[str] = None, **kwargs) -> str:
    """The path of the npz holding toy dataset ``name`` at these generation
    parameters: ``{data_dir}/{fname or name}.npz`` if it holds them, else the
    committed fixture of that name if it does. Neither: raises, naming the
    JAX command that writes one."""
    if name not in TOY_DATASETS:
        raise ValueError(f"unknown toy dataset: {name}")
    kwargs_repr = repr(sorted(kwargs.items()))
    stem = f"{fname or name}.npz"
    for path in (Path(data_dir) / stem, FIXTURE_DIR / stem):
        if path.exists() and _fresh(path, n, noise, seed, kwargs_repr):
            return str(path)
    raise FileNotFoundError(
        f"no {stem} with n={n}, noise={noise}, seed={seed}, "
        f"gen_version={GENERATOR_VERSION}, gen_kwargs={kwargs_repr} in {data_dir} or "
        f"{FIXTURE_DIR}: the toy generators are jax.random code; write the file with "
        f"{WRITE_COMMAND}")


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
