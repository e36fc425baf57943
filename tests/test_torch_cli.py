"""The port's evaluation CLI end to end on the CPU, its data pipeline, and
the rule that the port never imports JAX."""

import gzip
import json
import math
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.data import scale as jscale
from laplace_inducing_points_tpu_torch.cli import evaluate
from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.data import scale as tscale
from laplace_inducing_points_tpu_torch.data.loader import (ArrayDataset, DataLoader,
                                                           make_dataloaders)
from laplace_inducing_points_tpu_torch.models.scale import LeNet5
from laplace_inducing_points_tpu_torch.utils.checkpoint import save_array, save_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "scale", "lenet5_mnist.yml")


def _small_config(tmp_path) -> str:
    """lenet5_mnist.yml with ip.m 2, ip.mc_samples 3 and map.batch_size 8."""
    text = open(CONFIG).read()
    for old, new in (("    m: 100\n", "    m: 2\n"),
                     ("    mc_samples: 200\n", "    mc_samples: 3\n"),
                     ("    batch_size: 256\n", "    batch_size: 8\n")):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path = tmp_path / "lenet5_mnist_small.yml"
    path.write_text(text)
    return str(path)


def _argv(tmp_path, *extra):
    return ["--dataset", "mnist", "--config", _small_config(tmp_path), "--scalable",
            "--predictive", "weight", "--iters", "1", "--max_batches", "1",
            "--device", "cpu", "--ckpt_map", str(tmp_path / "map"),
            "--ckpt_induc", str(tmp_path / "ind"), "--data_dir", str(tmp_path / "data"),
            *extra]


def _write_checkpoints(tmp_path):
    (tmp_path / "data").mkdir()
    flat, spec = params_from_jax(lecun_normal_params(FlatSpec.from_module(LeNet5()), 0))
    save_params(flat, spec, str(tmp_path / "map"), "map_mnist")
    x, _ = tscale.load_arrays("mnist", train=True, root=str(tmp_path / "data"))
    save_array(x[:2], str(tmp_path / "ind"), "ind_mnist", 250)


def test_evaluate_main_end_to_end_on_cpu(tmp_path):
    _write_checkpoints(tmp_path)
    out_json = tmp_path / "eval.jsonl"
    records = evaluate.main(_argv(tmp_path, "--out_json", str(out_json)))
    assert len(records) == 1
    rec = records[0]
    assert rec["device"] == "cpu" and rec["batches"] == 1 and rec["mc"] == 3
    for key in ("nll", "acc", "brier", "ece", "factor_s", "per_batch_s"):
        assert math.isfinite(rec[key]), key
    assert json.loads(out_json.read_text().splitlines()[0])["nll"] == rec["nll"]


@pytest.mark.parametrize("extra,match", [
    (["--predictive", "cov"], "ROADMAP"),
    (["--mesh"], "ROADMAP"),
])
def test_evaluate_refuses_unported_paths(tmp_path, extra, match):
    _write_checkpoints(tmp_path)
    with pytest.raises(NotImplementedError, match=match):
        evaluate.main(_argv(tmp_path, *extra))


def test_evaluate_refuses_the_dense_predictive(tmp_path):
    argv = [a for a in _argv(tmp_path) if a != "--scalable"]
    with pytest.raises(NotImplementedError, match="dense"):
        evaluate.main(argv)


def test_evaluate_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal cannot be observed")
    argv = _argv(tmp_path)
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(argv)


def test_port_imports_no_jax():
    """Importing every module of the port leaves ``jax`` out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import laplace_inducing_points_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 29, names\n"
        "new = {pkg.__name__ + '.' + m for m in ('training.inducing', 'training.map', "
        "'cli.train_scale')}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'laplace_inducing_points_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 29


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_surrogate_is_bit_identical(train):
    x_t, y_t = tscale._synthetic("mnist", train)
    x_j, y_j = jscale._synthetic("mnist", train)
    np.testing.assert_array_equal(x_t, x_j)
    np.testing.assert_array_equal(y_t, y_j)


def _write_idx(root, base, images, labels):
    raw = root / "MNIST" / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    with gzip.open(raw / f"{base}-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    with gzip.open(raw / f"{base}-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())


def test_idx_files_read_as_the_jax_package_reads_them(tmp_path):
    rng = np.random.default_rng(0)
    for base, n in (("train", 100), ("t10k", 30)):
        _write_idx(tmp_path, base, rng.integers(0, 256, (n, 28, 28), dtype=np.uint8),
                   rng.integers(0, 10, n, dtype=np.uint8))
    for train in (True, False):
        x_t, y_t = tscale.load_arrays("mnist", train, root=str(tmp_path))
        x_j, y_j = jscale.load_arrays("mnist", train, root=str(tmp_path))
        np.testing.assert_array_equal(x_t, x_j)
        np.testing.assert_array_equal(y_t, y_j)
    train, test, val = tscale.get_dataloaders("mnist", 16, root=str(tmp_path))
    assert (len(train.dataset), len(val.dataset), len(test.dataset)) == (98, 2, 30)
    assert len(test) == 2           # evaluation keeps the tail batch


def test_loaders_batch_and_shuffle():
    ds = ArrayDataset(np.arange(10, dtype=np.float64)[:, None], np.arange(10))
    tr, te = make_dataloaders(ds, ds, None, 4, seed=1)
    train_batches = list(tr)
    assert len(train_batches) == 2 and all(x.dtype == np.float32 for x, _ in train_batches)
    assert [len(y) for _, y in te] == [4, 4, 2]
    seen = np.concatenate([y for _, y in train_batches])
    assert len(set(seen.tolist())) == 8
    np.testing.assert_array_equal(
        np.concatenate([y for _, y in DataLoader(ds, 3, drop_last=False)]), np.arange(10))
