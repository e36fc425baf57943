"""User-supplied dataset import with verification (no network).

Counterpart of ``laplace_inducing_points_tpu/data/import_data.py:58-184``,
numpy and the standard library only, so that the port ingests real data on a
machine without JAX. The user drops the official files in a directory and
``python -m laplace_inducing_points_tpu_torch.cli.import_data`` verifies and
installs them where ``data.scale.load_arrays`` looks
(``<root>/MNIST/raw``, ``<root>/FashionMNIST/raw``, ``<root>/cifar10_*.npz``):
the same bytes as the JAX package's import.

Verification is two-layer:
* **structural** (hard gate): IDX magic numbers, element counts, image/label
  count agreement, label range;
* **checksum** (soft gate, ``strict=True`` to enforce): MD5s as published in
  torchvision's dataset tables for the canonical distribution files.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import pickle
import shutil
import struct
import tarfile
from typing import Dict, Optional, Tuple

import numpy as np

# canonical distribution-file MD5s (as published in torchvision's
# MNIST.resources / FashionMNIST.resources / CIFAR10.tgz_md5 tables)
KNOWN_MD5 = {
    "mnist": {
        "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
        "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
        "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
        "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
    },
    "fmnist": {
        "train-images-idx3-ubyte.gz": "8d4fb7e6c68d591d4c3dfef9ec88bf0d",
        "train-labels-idx1-ubyte.gz": "25c81989df183df01b3e8a0aad5dffbe",
        "t10k-images-idx3-ubyte.gz": "bef4ecab320f06d8554ea6380940ec79",
        "t10k-labels-idx1-ubyte.gz": "bb300cfdad3c16e7a12a480ee83cd310",
    },
    "cifar10": {
        "cifar-10-python.tar.gz": "c58f30108f718f92721af3b95e74349a",
    },
}

IDX_PREFIX = {"mnist": "MNIST/raw", "fmnist": "FashionMNIST/raw"}
IDX_FILES = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
             "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def validate_idx_pair(img_path: str, lab_path: str) -> Tuple[int, int, int]:
    """Structural IDX validation; returns (count, rows, cols) or raises."""
    with _open(img_path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{img_path}: bad IDX image magic {magic}")
        body = f.read()
        if len(body) != n * rows * cols:
            raise ValueError(f"{img_path}: expected {n * rows * cols} pixel "
                             f"bytes, found {len(body)}")
    with _open(lab_path) as f:
        magic, nl = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{lab_path}: bad IDX label magic {magic}")
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    if nl != n or len(labels) != n:
        raise ValueError(f"image/label count mismatch: {n} vs {nl}")
    if labels.max() > 9:
        raise ValueError(f"{lab_path}: label range 0..{labels.max()} > 9")
    return n, rows, cols


def _check_md5(dataset: str, fname: str, path: str, strict: bool) -> None:
    expected = KNOWN_MD5.get(dataset, {}).get(fname)
    if expected is None:
        return
    got = _md5(path)
    if got != expected:
        msg = (f"{path}: md5 {got} != published {expected} "
               "(modified or non-canonical file)")
        if strict:
            raise ValueError(msg)
        print(f"[import] WARNING: {msg}")
    else:
        print(f"[import] md5 verified: {fname}")


def import_idx(dataset: str, src: str, root: str = "data",
               strict: bool = False) -> str:
    """Verify + install the four canonical IDX .gz files for mnist/fmnist."""
    dest = os.path.join(root, IDX_PREFIX[dataset])
    os.makedirs(dest, exist_ok=True)
    found = {}
    for fname in IDX_FILES:
        for cand in (os.path.join(src, fname), os.path.join(src, fname[:-3])):
            if os.path.exists(cand):
                found[fname] = cand
                break
        else:
            raise FileNotFoundError(
                f"{fname} (or uncompressed) not found under {src}")
    for base in ("train", "t10k"):
        n, rows, cols = validate_idx_pair(
            found[f"{base}-images-idx3-ubyte.gz"],
            found[f"{base}-labels-idx1-ubyte.gz"])
        print(f"[import] {dataset} {base}: {n} images of {rows}x{cols} OK")
    for fname, cand in found.items():
        if cand.endswith(".gz"):
            _check_md5(dataset, fname, cand, strict)
        out = os.path.join(dest, os.path.basename(cand))
        shutil.copyfile(cand, out)
    print(f"[import] installed {dataset} -> {dest}")
    return dest


def import_cifar10(src: str, root: str = "data",
                   strict: bool = False) -> Tuple[str, str]:
    """Verify + convert cifar-10-python.tar.gz (or its extracted dir) into
    the framework's ``cifar10_{train,test}.npz`` cache format."""
    tar_path = os.path.join(src, "cifar-10-python.tar.gz")
    batches_dir = os.path.join(src, "cifar-10-batches-py")
    tmp_extract = None
    if os.path.exists(tar_path):
        _check_md5("cifar10", "cifar-10-python.tar.gz", tar_path, strict)
        tmp_extract = os.path.join(root, "_cifar_extract")
        with tarfile.open(tar_path, "r:gz") as tf:
            tf.extractall(tmp_extract, filter="data")
        batches_dir = os.path.join(tmp_extract, "cifar-10-batches-py")
    if not os.path.isdir(batches_dir):
        raise FileNotFoundError(
            f"neither cifar-10-python.tar.gz nor cifar-10-batches-py/ "
            f"under {src}")

    def _load_batch(path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.asarray(d[b"labels"],
                                                        dtype=np.int32)

    xs, ys = zip(*[_load_batch(os.path.join(batches_dir, f"data_batch_{i}"))
                   for i in range(1, 6)])
    x_train, y_train = np.concatenate(xs), np.concatenate(ys)
    x_test, y_test = _load_batch(os.path.join(batches_dir, "test_batch"))
    if x_train.shape != (50000, 32, 32, 3) or len(y_test) != 10000:
        raise ValueError(f"unexpected CIFAR shapes: {x_train.shape}, "
                         f"{len(y_test)} test labels")
    os.makedirs(root, exist_ok=True)
    tr = os.path.join(root, "cifar10_train.npz")
    te = os.path.join(root, "cifar10_test.npz")
    np.savez(tr, x=x_train, y=y_train)
    np.savez(te, x=x_test, y=y_test)
    if tmp_extract:
        shutil.rmtree(tmp_extract, ignore_errors=True)
    print(f"[import] installed cifar10 -> {tr}, {te}")
    return tr, te


def import_dataset(dataset: str, src: str, root: str = "data",
                   strict: bool = False):
    if dataset in IDX_PREFIX:
        return import_idx(dataset, src, root, strict)
    if dataset == "cifar10":
        return import_cifar10(src, root, strict)
    raise ValueError(f"unknown dataset: {dataset}")
