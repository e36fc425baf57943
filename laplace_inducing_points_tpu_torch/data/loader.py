"""Numpy minibatch pipeline.

Counterpart of ``laplace_inducing_points_tpu/data/loader.py:29-93``
(``ArrayDataset``, ``DataLoader``, ``make_dataloaders``), ``:109-155``
(``device_iter``) and ``:158-179`` (``cycling_batches``, one batch at a
time). Batches stay numpy on the host; the harness and the trainers move each
one to the model's device, and ``device_iter`` does so for a library
caller. An epoch's
shuffle is the JAX package's: a seed drawn from ``np.random.default_rng(seed)``
drives the native splitmix64 Fisher-Yates (``data.native.shuffle_indices``),
so the two packages give the same batches.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from laplace_inducing_points_tpu_torch.data.native import shuffle_indices


class ArrayDataset:
    """In-memory (x, y) dataset."""

    def __init__(self, x, y):
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        if len(self.x) != len(self.y):
            raise ValueError(f"{len(self.x)} inputs but {len(self.y)} targets")

    def __len__(self):
        return len(self.x)


class DataLoader:
    """Minibatch iterator over an ArrayDataset; ``drop_last`` keeps batch
    shapes fixed."""

    def __init__(self, dataset: ArrayDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        if self.shuffle:
            idx = shuffle_indices(n, int(self._rng.integers(0, 2**63 - 1)))
        else:
            idx = np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            b = idx[s:s + self.batch_size]
            yield self.dataset.x[b].astype(np.float32, copy=False), self.dataset.y[b]


def make_dataloaders(train: ArrayDataset, test: ArrayDataset,
                     val: Optional[ArrayDataset], batch_size: int, seed: int = 0):
    """Train keeps ``drop_last`` (when it has a full batch); evaluation
    loaders keep the tail batch."""
    train_loader = DataLoader(train, batch_size, shuffle=True, seed=seed,
                              drop_last=len(train) >= batch_size)
    test_loader = DataLoader(test, batch_size, shuffle=False, drop_last=False)
    if val is None:
        return train_loader, test_loader
    val_loader = DataLoader(val, batch_size, shuffle=False, drop_last=False)
    return train_loader, test_loader, val_loader


def device_iter(loader: Iterable, device="cpu", *, prefetch: int = 2,
                dtype: torch.dtype = torch.float32) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """``loader``'s batches as tensors on ``device`` (inputs as ``dtype``),
    with ``prefetch`` batches moved ahead: on a CUDA device from pinned
    memory without blocking, so the copies overlap the caller's work on the
    batch before. On a mesh, ``parallel.shard_batch`` splits each batch."""
    device = torch.device(device)

    def put(batch):
        x, y = (torch.as_tensor(np.asarray(t)) for t in batch)
        x = x.to(dtype)
        if device.type == "cuda":
            return (x.pin_memory().to(device, non_blocking=True),
                    y.pin_memory().to(device, non_blocking=True))
        return x.to(device), y.to(device)

    batches = iter(loader)
    pending = deque(put(b) for _, b in zip(range(max(prefetch, 1)), batches))
    while pending:
        out = pending.popleft()
        for b in batches:
            pending.append(put(b))
            break
        yield out


def cycling_batches(loader):
    """Endless iterator over ``loader``'s batches, restarting it (and so
    reshuffling it) whenever it runs out."""
    while True:
        empty = True
        for batch in loader:
            empty = False
            yield batch
        if empty:
            raise ValueError("the loader yields no batch")
