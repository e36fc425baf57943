"""The port's evaluation CLI end to end on the CPU (the weight and the
matfree predictives, ``--mesh`` and ``--profile``, and the matfree objective
through ``train_scale``), its data pipeline, the port's CLIs against their
JAX twins' options, and the rule that the port never imports JAX."""

import glob
import gzip
import importlib
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
from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale
from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.data import scale as tscale
from laplace_inducing_points_tpu_torch.data.loader import (ArrayDataset, DataLoader,
                                                           make_dataloaders)
from laplace_inducing_points_tpu_torch.models.scale import LeNet5
from laplace_inducing_points_tpu_torch.utils.checkpoint import save_array, save_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "scale", "lenet5_mnist.yml")
MATFREE_CONFIG = os.path.join(REPO, "configs", "scale", "lenet5_mnist_matfree1k.yml")


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


@pytest.mark.parametrize("predictive", ["weight", "cov"])
def test_evaluate_mesh_on_one_device(tmp_path, capsys, predictive):
    """``--mesh`` with one device (here the CPU) is a no-op, as in the
    reference: the same metrics as without it, no mesh line."""
    _write_checkpoints(tmp_path)
    base = _argv(tmp_path, "--predictive", predictive)
    meshed = evaluate.main([*base, "--mesh"])
    assert "[mesh]" not in capsys.readouterr().out
    plain = evaluate.main(base)
    for key in ("nll", "acc", "brier", "ece"):
        assert meshed[0][key] == plain[0][key], key


@pytest.mark.parametrize("iters", [1, 2])
def test_evaluate_profile_traces_the_last_repetition(tmp_path, capsys, iters):
    _write_checkpoints(tmp_path)
    trace_dir = tmp_path / "trace"
    argv = _argv(tmp_path, "--profile", str(trace_dir))
    argv[argv.index("--iters") + 1] = str(iters)
    records = evaluate.main(argv)
    out = capsys.readouterr().out
    assert len(records) == iters
    assert ("[profile] WARNING: --iters 1" in out) == (iters == 1)
    assert f"[profile] device trace of repetition {iters - 1} written to {trace_dir}" in out
    (path,) = glob.glob(str(trace_dir / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::linalg_eigh" not in names        # the factor build is not traced
    assert "aten::randn" in names                  # the repetition's draws are


@pytest.mark.parametrize("name", ["train_scale", "evaluate", "main_toy", "import_data"])
def test_port_parsers_accept_every_jax_option(name):
    """Each port CLI takes every option string of its JAX twin (and
    ``--device``), with the same positional modes."""
    jax_parser = importlib.import_module(f"laplace_inducing_points_tpu.cli.{name}").build_parser()
    port_parser = importlib.import_module(
        f"laplace_inducing_points_tpu_torch.cli.{name}").build_parser()

    def options(parser):
        return {s for a in parser._actions for s in a.option_strings} - {"-h", "--help"}

    def modes(parser):
        return [a.choices for a in parser._actions if not a.option_strings]

    assert options(jax_parser) <= options(port_parser)
    assert options(port_parser) - options(jax_parser) <= {"--device"}
    assert modes(port_parser) == modes(jax_parser)


def _matfree_config(tmp_path) -> str:
    """lenet5_mnist_matfree1k.yml cut to a CPU rehearsal: M 5 (no example
    blocks: the twins cover them), ip.epochs 1 of batch 4, test batches of
    8, 4 Krylov steps, rank-4 sketches, 10 CG iterations, S = 3."""
    text = open(MATFREE_CONFIG).read()
    for old, new, count in (("    m: 1024\n", "    m: 5\n", 1),
                            ("    epochs: 60\n", "    epochs: 1\n", 1),
                            ("    batch_size: 128\n", "    batch_size: 4\n", 1),
                            ("    batch_size: 256\n", "    batch_size: 8\n", 1),
                            ("slq_num_matvecs: 64", "slq_num_matvecs: 4", 1),
                            ("precond_rank: 64", "precond_rank: 4", 2),
                            ("cg_example_block: 128", "cg_example_block: null", 2),
                            ("cg_maxiter: 100", "cg_maxiter: 10", 1),
                            ("cg_maxiter: 200", "cg_maxiter: 10", 1),
                            ("mc_samples: 32", "mc_samples: 3", 2)):
        assert text.count(old) == count, old
        text = text.replace(old, new)
    path = tmp_path / "lenet5_mnist_matfree_cut.yml"
    path.write_text(text)
    return str(path)


@pytest.fixture
def one_intra_op_thread():
    """A toy-sized run beside other test workers: one intra-op thread keeps
    it from oversubscribing the cores (restored after the test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_matfree_train_inducing_then_evaluate_on_cpu(tmp_path, one_intra_op_thread):
    """``train_scale train_inducing --objective stochastic_matfree`` (the
    config's CG knobs, the healthchecks) on a seeded MAP, then ``evaluate
    --predictive matfree`` on its Z, flags over the config's knobs."""
    _write_checkpoints(tmp_path)
    common = ["--dataset", "mnist", "--config", _matfree_config(tmp_path), "--device", "cpu",
              "--ckpt_map", str(tmp_path / "map"), "--ckpt_induc", str(tmp_path / "ind"),
              "--data_dir", str(tmp_path / "data")]
    result = train_scale.main(["train_inducing", "--objective", "stochastic_matfree",
                               "--alpha_ip", "50", "--train_log", str(tmp_path / "log.jsonl"),
                               *common])
    hc = result["healthcheck_post"]
    assert hc["cg_iterations"] <= 10 and math.isfinite(hc["cg_rel_residual"])
    assert result["inducing"]["objective"] == "stochastic_matfree" and result["Z_moved"] > 0
    summary = json.loads((tmp_path / "log.jsonl").read_text().splitlines()[-1])
    assert summary["cg_maxiter"] == 10 and summary["precond_rank"] == 4
    assert summary["cg_iterations_post"] == hc["cg_iterations"]
    records = evaluate.main(["--scalable", "--predictive", "matfree", "--iters", "1",
                             "--max_batches", "1", "--cg_maxiter", "6", "--precond_rank", "0",
                             *common])
    rec = records[0]
    assert rec["predictive"] == "matfree" and rec["alpha"] == 50.0
    for key in ("nll", "acc", "brier", "ece", "cg_rel_residual"):
        assert math.isfinite(rec[key]), key


def test_matfree_knobs_take_the_flags_over_the_config():
    cfg = {"cg_tol": 1e-4, "cg_maxiter": 200, "precond_rank": 64, "precond_power": 1,
           "cg_example_block": 128}
    args = evaluate.build_parser().parse_args(
        ["--dataset", "mnist", "--config", "c", "--cg_tol", "1e-6", "--precond_rank", "0"])
    assert evaluate.matfree_knobs(cfg, args) == {
        "cg_tol": 1e-6, "cg_maxiter": 200, "precond_rank": None, "precond_power": 1,
        "cg_example_block": 128}
    assert evaluate.matfree_knobs(cfg)["precond_rank"] == 64


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
        "assert len(names) >= 36, names\n"
        "new = {pkg.__name__ + '.' + m for m in ('training.inducing', 'training.map', "
        "'cli.train_scale', 'training.alpha', 'training.grid_search', 'data.native', "
        "'ops.cg', 'ops.nystrom', 'cli.main_toy', 'data.toy', 'viz.nplot', 'viz.style', "
        "'parallel', 'parallel.mesh', 'parallel.sharded_ops', 'utils.profiling', "
        "'data.import_data', 'cli.import_data')}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'laplace_inducing_points_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 36


def test_port_and_smoke_import_with_jax_blocked():
    """With ``jax`` (and the JAX package) set to None in sys.modules, so that
    any import of them fails, every port module and ``chip_smoke.py``
    import."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'laplace_inducing_points_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import laplace_inducing_points_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert callable(chip_smoke.main)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 36


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
