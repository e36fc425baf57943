"""Image datasets: MNIST / FashionMNIST / CIFAR-10, numpy end-to-end.

Counterpart of ``laplace_inducing_points_tpu/data/scale.py``: the IDX and
npz readers, the deterministic synthetic surrogate (``:83-105``,
bit-identical) and the 98/2 train/val split. Nothing is downloaded: a
dataset missing under ``root`` is replaced by the surrogate, and a line says
so. CIFAR train-time augmentation is not ported yet (ROADMAP, Queue A).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from laplace_inducing_points_tpu_torch.data.loader import ArrayDataset, DataLoader

DATASET_SHAPES = {
    "mnist": ((28, 28, 1), 10),
    "fmnist": ((28, 28, 1), 10),
    "cifar10": ((32, 32, 3), 10),
}
VAL_FRACTION = 0.02     # the reference's 98/2 train/val split


def _read_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad IDX image magic in {path}")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows, cols, 1).astype(np.float32) / 255.0


def _read_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX label magic in {path}")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.astype(np.int32)


def _try_idx(root: str, prefix: str, train: bool):
    base = "train" if train else "t10k"
    for ext in ("", ".gz"):
        imgs = os.path.join(root, prefix, f"{base}-images-idx3-ubyte{ext}")
        labs = os.path.join(root, prefix, f"{base}-labels-idx1-ubyte{ext}")
        if os.path.exists(imgs) and os.path.exists(labs):
            return _read_idx_images(imgs), _read_idx_labels(labs)
    return None


def _try_npz(root: str, name: str, train: bool):
    path = os.path.join(root, f"{name}_{'train' if train else 'test'}.npz")
    if os.path.exists(path):
        d = np.load(path)
        return d["x"].astype(np.float32), d["y"].astype(np.int32)
    return None


def _synthetic(name: str, train: bool, seed: int = 0):
    """Deterministic class-structured surrogate (offline fallback): each
    class is a distinct smooth spatial pattern plus noise."""
    shape, num_classes = DATASET_SHAPES[name]
    n = 8192 if train else 2048
    rng = np.random.default_rng(seed + (0 if train else 1))
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    x = np.empty((n, h, w, c), dtype=np.float32)
    for k in range(num_classes):
        mask = y == k
        freq = 0.2 + 0.15 * k
        phase = 0.7 * k
        pattern = 0.5 + 0.5 * np.sin(freq * xx + phase) * np.cos(
            freq * yy - phase)
        x[mask] = pattern[None, :, :, None]
    x += 0.15 * rng.standard_normal(x.shape).astype(np.float32)
    return np.clip(x, 0.0, 1.0), y


def load_arrays(name: str, train: bool, root: str = "data"):
    if name not in DATASET_SHAPES:
        raise ValueError(f"unknown dataset: {name}")
    idx_prefix = {"mnist": "MNIST/raw", "fmnist": "FashionMNIST/raw"}.get(name)
    if idx_prefix:
        out = _try_idx(root, idx_prefix, train)
        if out is not None:
            return out
    out = _try_npz(root, name, train)
    if out is not None:
        return out
    print(f"[data] '{name}' not found under {root} — using the "
          "deterministic synthetic surrogate")
    return _synthetic(name, train)


def get_dataloaders(name: str, batch_size: int, *, root: str = "data",
                    seed: int = 0):
    """train/test/val loaders with the reference's 98/2 train/val split;
    evaluation loaders keep the tail batch."""
    x_all, y_all = load_arrays(name, train=True, root=root)
    x_test, y_test = load_arrays(name, train=False, root=root)

    n_total = x_all.shape[0]
    n_val = int(VAL_FRACTION * n_total)
    n_train = n_total - n_val
    train_loader = DataLoader(ArrayDataset(x_all[:n_train], y_all[:n_train]),
                              batch_size, shuffle=True, seed=seed)
    test_loader = DataLoader(ArrayDataset(x_test, y_test), batch_size,
                             drop_last=False)
    val_loader = DataLoader(ArrayDataset(x_all[n_train:], y_all[n_train:]),
                            batch_size, drop_last=False)
    print(f"[data] loaded '{name}'  train={n_train} val={n_val} "
          f"test={len(x_test)}")
    return train_loader, test_loader, val_loader
