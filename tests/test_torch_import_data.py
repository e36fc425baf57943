"""Twin tests of the port's dataset import (``data/import_data.py``,
``cli/import_data.py``): from the same synthetic sources both packages write
byte-identical files or refuse alike; the port's copy runs without JAX."""

import gzip
import hashlib
import io
import os
import pickle
import struct
import subprocess
import sys
import tarfile

import numpy as np
import pytest

from laplace_inducing_points_tpu.cli import import_data as jcli
from laplace_inducing_points_tpu_torch.cli import import_data as tcli
from laplace_inducing_points_tpu_torch.data import scale as tscale

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDX = ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
       "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")


def _write_idx_source(src, bad_magic: bool = False):
    """The four canonical IDX ``.gz`` files, 40 and 12 seeded 28x28 images."""
    src.mkdir()
    rng = np.random.default_rng(0)
    for base, n in (("train", 40), ("t10k", 12)):
        images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, n, dtype=np.uint8)
        magic = 2052 if bad_magic and base == "t10k" else 2051
        with gzip.open(src / f"{base}-images-idx3-ubyte.gz", "wb") as f:
            f.write(struct.pack(">IIII", magic, n, 28, 28) + images.tobytes())
        with gzip.open(src / f"{base}-labels-idx1-ubyte.gz", "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar_source(src):
    """``cifar-10-python.tar.gz`` with the five training batches and the test
    batch at CIFAR-10's own sizes (the importer checks them); a cheap
    repeating pattern, so the archive stays small."""
    src.mkdir()
    pattern = (np.arange(10000 * 3072) % 251).astype(np.uint8).reshape(10000, 3072)
    with tarfile.open(src / "cifar-10-python.tar.gz", "w:gz", compresslevel=1) as tf:
        for i, name in enumerate([f"data_batch_{k}" for k in range(1, 6)] + ["test_batch"]):
            blob = pickle.dumps({b"data": np.roll(pattern, i, axis=1),
                                 b"labels": [(j + i) % 10 for j in range(10000)]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def _digests(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def _run_both(tmp_path, argv):
    """``(result, files)`` of each package's CLI on ``argv``: the exception
    type and message, or None, and the digests of every file it wrote."""
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        root = tmp_path / f"root_{name}"
        try:
            cli.main([*argv, "--root", str(root)])
            result = None
        except (ValueError, FileNotFoundError) as err:
            result = (type(err).__name__, str(err).replace(str(root), "<root>"))
        out[name] = (result, _digests(root) if root.exists() else {})
    return out


@pytest.mark.parametrize("dataset,case", [
    ("mnist", "valid"), ("fmnist", "valid"), ("mnist", "bad_magic"),
    ("fmnist", "strict_md5"), ("mnist", "missing_file")])
def test_idx_import_writes_what_the_jax_package_writes(tmp_path, dataset, case):
    """Valid sources install byte-identical files (the md5 mismatch of a
    synthetic file only warns); a bad magic, an md5 mismatch under
    ``--strict`` and a missing file raise alike."""
    src = tmp_path / "src"
    _write_idx_source(src, bad_magic=case == "bad_magic")
    if case == "missing_file":
        (src / IDX[3]).unlink()
    argv = ["--dataset", dataset, "--src", str(src)] + (["--strict"] if case == "strict_md5"
                                                         else [])
    out = _run_both(tmp_path, argv)
    assert out["torch"] == out["jax"]
    result, files = out["torch"]
    if case == "valid":
        assert result is None
        prefix = "MNIST" if dataset == "mnist" else "FashionMNIST"
        assert sorted(files) == sorted(os.path.join(prefix, "raw", f) for f in IDX)
        x, y = tscale.load_arrays(dataset, train=False, root=str(tmp_path / "root_torch"))
        assert x.shape == (12, 28, 28, 1) and y.shape == (12,)
    else:
        assert result[0] == {"bad_magic": "ValueError", "strict_md5": "ValueError",
                             "missing_file": "FileNotFoundError"}[case]
        assert {"bad_magic": "magic", "strict_md5": "md5",
                "missing_file": IDX[3]}[case] in result[1]


@pytest.mark.parametrize("strict", [False, True])
def test_cifar10_import_writes_what_the_jax_package_writes(tmp_path, strict):
    """The synthetic archive's md5 is not the published one: without
    ``--strict`` both packages warn and install the same ``cifar10_*.npz``
    bytes, with it both refuse before extracting."""
    src = tmp_path / "src"
    _write_cifar_source(src)
    out = _run_both(tmp_path, ["--dataset", "cifar10", "--src", str(src)]
                    + (["--strict"] if strict else []))
    assert out["torch"] == out["jax"]
    result, files = out["torch"]
    if strict:
        assert result[0] == "ValueError" and "md5" in result[1] and not files
    else:
        assert result is None
        assert sorted(files) == ["cifar10_test.npz", "cifar10_train.npz"]


def test_import_runs_without_jax(tmp_path):
    """The port's import CLI with ``jax`` blocked from import."""
    src = tmp_path / "src"
    _write_idx_source(src)
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'laplace_inducing_points_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from laplace_inducing_points_tpu_torch.cli import import_data\n"
            f"import_data.main(['--dataset', 'mnist', '--src', {str(src)!r}, "
            f"'--root', {str(tmp_path / 'root')!r}])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[import] installed mnist" in out.stdout
    assert len(_digests(tmp_path / "root")) == 4
