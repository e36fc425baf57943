"""Image datasets: MNIST / FashionMNIST / CIFAR-10, numpy end-to-end.

Counterpart of ``laplace_inducing_points_tpu/data/scale.py``: the IDX and
npz readers, the deterministic synthetic surrogate (``:83-105``,
bit-identical), the 98/2 train/val split and CIFAR-10's train-time
augmentation (``:130-161``: RandomCrop(32, pad 4) plus a horizontal flip,
through the native ``crop_flip_f32``). Nothing is downloaded: a dataset
missing under ``root`` is replaced by the surrogate, and a line says so.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from laplace_inducing_points_tpu_torch.data import native
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


class AugmentedDataset(ArrayDataset):
    """CIFAR train-time augmentation, RandomCrop(32, pad 4) + HFlip, applied per
    batch: :meth:`take` draws one seed from the dataset's generator and crops
    and flips the batch out of the zero-padded images with it, as the
    reference's ``AugmentedDataset.take`` does, so the same indices and
    ``seed`` give the same images in both packages."""

    def __init__(self, x, y, pad: int = 4, seed: int = 0):
        super().__init__(x, y)
        self.pad = pad
        self._rng = np.random.default_rng(seed)
        self._padded = np.ascontiguousarray(np.pad(
            self.x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
            mode="constant").astype(np.float32))

    def take(self, idx: np.ndarray):
        h, w = self.x.shape[1], self.x.shape[2]
        out = native.crop_flip_f32(self._padded, np.asarray(idx), h, w, self.pad,
                                   int(self._rng.integers(0, 2**63 - 1)))
        return out, self.y[idx]


class AugmentedLoader(DataLoader):
    """A :class:`DataLoader` whose batches come from
    :meth:`AugmentedDataset.take`."""

    def __iter__(self):
        n = len(self.dataset)
        idx = self._rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            yield self.dataset.take(idx[s:s + self.batch_size])


def get_dataloaders(name: str, batch_size: int, *, aug: bool = True,
                    root: str = "data", seed: int = 0):
    """train/test/val loaders with the reference's 98/2 train/val split;
    evaluation loaders keep the tail batch.

    ``aug`` asks for train-time augmentation, which the reference applies to
    CIFAR-10 only (its ``data/scale.py:177``); MNIST and FashionMNIST have
    none.
    """
    x_all, y_all = load_arrays(name, train=True, root=root)
    x_test, y_test = load_arrays(name, train=False, root=root)

    n_total = x_all.shape[0]
    n_val = int(VAL_FRACTION * n_total)
    n_train = n_total - n_val
    if name == "cifar10" and aug:
        train_loader = AugmentedLoader(
            AugmentedDataset(x_all[:n_train], y_all[:n_train], seed=seed), batch_size,
            shuffle=True, seed=seed)
    else:
        train_loader = DataLoader(ArrayDataset(x_all[:n_train], y_all[:n_train]),
                                  batch_size, shuffle=True, seed=seed)
    test_loader = DataLoader(ArrayDataset(x_test, y_test), batch_size,
                             drop_last=False)
    val_loader = DataLoader(ArrayDataset(x_all[n_train:], y_all[n_train:]),
                            batch_size, drop_last=False)
    print(f"[data] loaded '{name}'  train={n_train} val={n_val} "
          f"test={len(x_test)}")
    return train_loader, test_loader, val_loader
