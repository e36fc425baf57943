"""The port's trainer CLI end to end on the CPU at a tiny configuration, chained
into the evaluation CLI: α given, from the grid search and from the evidence;
``--continue``, ``--profile``, ``--objective gram_chunked`` and ``--no-mesh``."""

import glob
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.utils import checkpoint as jckpt
from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale
from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.models.scale import LeNet5, ResNet1M
from laplace_inducing_points_tpu_torch.utils.checkpoint import load_train_state, save_params

from test_torch_cli import CONFIG, REPO


# the stochastic objective's estimator knobs, cut for the CPU: 16 probes, an
# SLQ depth of 8 (the shipped 200 would keep ~5 GB of Krylov prefixes for
# the backward pass)
STOCHASTIC_CUTS = (("    st_samples: 256\n", "    st_samples: 16\n"),
                   ("    slq_num_matvecs: 200\n", "    slq_num_matvecs: 8\n"))


def _tiny_config(tmp_path, extra=()) -> str:
    """lenet5_mnist.yml with 1 MAP epoch, 3 Z steps, M = 2, a Z batch of 4
    and 3 predictive samples (D stays 61,706), and the ``extra`` cuts."""
    text = open(CONFIG).read()
    for old, new in (("    epochs: 150\n", "    epochs: 1\n"),
                     ("    epochs: 250\n", "    epochs: 3\n"),
                     ("    m: 100\n", "    m: 2\n"),
                     ("    batch_size: 128\n", "    batch_size: 4\n"),
                     ("    mc_samples: 200\n", "    mc_samples: 3\n"), *extra):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path = tmp_path / "lenet5_mnist_tiny.yml"
    path.write_text(text)
    return str(path)


def _common(tmp_path, extra=()):
    (tmp_path / "data").mkdir(exist_ok=True)
    return ["--dataset", "mnist", "--config", _tiny_config(tmp_path, extra), "--device", "cpu",
            "--ckpt_map", str(tmp_path / "map"), "--ckpt_induc", str(tmp_path / "ind"),
            "--data_dir", str(tmp_path / "data")]


def test_full_pipeline_then_evaluate_on_cpu(tmp_path):
    log = tmp_path / "train.jsonl"
    result = train_scale.main(["full_pipeline", "--alpha_ip", "0.005",
                               "--train_log", str(log), *_common(tmp_path)])
    assert result["map"]["steps"] == 8029 // 256
    assert math.isfinite(result["map"]["loss_last"])
    assert result["Z_moved"] > 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows[:-1]] == [0, 1, 2]
    assert all(math.isfinite(r["loss"]) for r in rows[:-1])
    assert rows[-1]["op"] == "kl_training_run" and rows[-1]["steps"] == 3
    Z = jckpt.load_array(str(tmp_path / "ind"), "ind_mnist", 3)
    assert Z.shape == (2, 28, 28, 1) and np.isfinite(Z).all()
    assert jckpt.load_run_meta(str(tmp_path / "ind"), "ind_mnist") == {
        "alpha_ip": 0.005, "alpha_src": "cli", "objective": "gram"}

    records = evaluate.main(["--scalable", "--predictive", "weight", "--iters", "1",
                             "--max_batches", "1", *_common(tmp_path)])
    assert records[0]["alpha"] == 0.005            # picked up from the run meta
    for key in ("nll", "acc", "brier", "ece"):
        assert math.isfinite(records[0][key]), key


def test_train_map_then_train_inducing_chain(tmp_path):
    assert set(train_scale.main(["train_map", *_common(tmp_path)])) == {"map"}
    assert (tmp_path / "map" / "map_mnist.pt").exists()
    assert not (tmp_path / "ind").exists()
    result = train_scale.main(["train_inducing", "--alpha_ip", "0.01",
                               *_common(tmp_path)])
    assert "map" not in result and result["Z_moved"] > 0
    assert (tmp_path / "ind" / "ind_mnist_3.npz").exists()


def test_train_inducing_stochastic_on_cpu(tmp_path):
    """``--objective stochastic`` through the CLI: the estimator knobs come
    from the config, the objective is in the log summary and the run meta,
    and evaluation reads the Z."""
    common = _common(tmp_path, STOCHASTIC_CUTS)
    train_scale.main(["train_map", *common])
    log = tmp_path / "train.jsonl"
    result = train_scale.main(["train_inducing", "--objective", "stochastic",
                               "--alpha_ip", "0.005", "--train_log", str(log), *common])
    assert result["Z_moved"] > 0
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows[:-1]] == [0, 1, 2]
    assert all(math.isfinite(r["loss"]) for r in rows[:-1])
    assert rows[-1]["op"] == "kl_training_run" and rows[-1]["objective"] == "stochastic"
    assert jckpt.load_run_meta(str(tmp_path / "ind"), "ind_mnist")["objective"] == "stochastic"
    records = evaluate.main(["--scalable", "--predictive", "weight", "--iters", "1",
                             "--max_batches", "1", *common])
    assert all(math.isfinite(records[0][key]) for key in ("nll", "acc", "brier", "ece"))


def test_alpha_from_the_grid_search_on_cpu(tmp_path):
    """Without ``--alpha_ip`` the grid search runs on the MAP and the initial Z
    (log10 alpha from 1 to 3: 8 points, then 3 between the best one's
    neighbours), and its alpha trains Z and reaches the evaluation."""
    result = train_scale.main(["full_pipeline", *_common(tmp_path)])
    alpha = result["alpha"]
    assert alpha["alpha_src"] == "grid" and len(alpha["grid"]) == 11
    np.testing.assert_allclose([a for a, _ in alpha["grid"][:8]], np.logspace(1, 3, 8))
    assert all(math.isfinite(nll) for _, nll in alpha["grid"])
    best = min(alpha["grid"], key=lambda point: point[1])
    assert alpha["alpha_ip"] == best[0] and 10.0 <= best[0] <= 1000.0
    meta = jckpt.load_run_meta(str(tmp_path / "ind"), "ind_mnist")
    assert meta == {"alpha_ip": best[0], "alpha_src": "grid", "objective": "gram"}
    records = evaluate.main(["--scalable", "--predictive", "weight", "--iters", "1",
                             "--max_batches", "1", *_common(tmp_path)])
    assert records[0]["alpha"] == best[0]


def test_alpha_from_the_evidence_on_cpu(tmp_path):
    """``--alpha_mode evidence``: 5 MAP epochs (burn-in 1), an alpha step after
    the fifth on its last batch, and that alpha trains Z."""
    common = _common(tmp_path, (("    epochs: 1\n", "    epochs: 5\n"),
                                ("    batch_size: 256\n", "    batch_size: 64\n")))
    result = train_scale.main(["full_pipeline", "--alpha_mode", "evidence", *common])
    assert result["map"]["steps"] == 5 * (8029 // 64)
    evidence = result["map"]["evidence_alpha"]
    # one Adam step on log alpha from the config's 0.005 moves it by lr = 0.05
    np.testing.assert_allclose(abs(math.log(evidence / 0.005)), 0.05, rtol=1e-3)
    assert result["alpha"] == {"alpha_ip": evidence, "alpha_src": "evidence", "grid": []}
    assert jckpt.load_run_meta(str(tmp_path / "ind"), "ind_mnist")["alpha_src"] == "evidence"
    assert result["Z_moved"] > 0


@pytest.fixture(scope="module")
def trained_map(tmp_path_factory):
    """The ``map`` directory of one ``train_map`` run (31 steps), for the
    tests to copy."""
    root = tmp_path_factory.mktemp("trained")
    train_scale.main(["train_map", *_common(root)])
    return root / "map"


def _with_map(tmp_path, trained_map):
    shutil.copytree(trained_map, tmp_path / "map")
    return _common(tmp_path)


def test_continue_resumes_the_map_run(tmp_path, trained_map, capsys):
    """``train_map --continue`` trains map.epochs more epochs from the saved
    Adam state: the step count goes on (31 -> 62) and the cosine schedule,
    past its end, stays at its floor 0.08 lr; the file then holds step 62."""
    common = _with_map(tmp_path, trained_map)
    result = train_scale.main(["train_map", "--continue", *common])
    assert "[resume] continuing from step 31" in capsys.readouterr().out
    stats = result["map"]
    assert (stats["start_step"], stats["end_step"], stats["steps"]) == (31, 62, 31)
    np.testing.assert_allclose(stats["start_lr"], 0.08 * 5e-4, rtol=1e-6)
    state = load_train_state(str(tmp_path / "map"), "map_mnist", LeNet5(), "classifier",
                             torch.device("cpu"))
    assert state.step == 62 and math.isfinite(stats["loss_last"])


@pytest.mark.parametrize("mode", ["train_map", "train_inducing"])
def test_continue_without_a_checkpoint_starts_fresh(tmp_path, capsys, mode):
    """No train state: the reference's line, then the fresh seeded init (for
    ``train_inducing`` the Z training runs on it, as the reference's does)."""
    result = train_scale.main([mode, "--continue", "--alpha_ip", "0.005", *_common(tmp_path)])
    assert "[resume] no checkpoint found — starting fresh" in capsys.readouterr().out
    if mode == "train_map":
        assert result["map"]["start_step"] == 0 and result["map"]["end_step"] == 31
    else:
        assert "map" not in result and result["Z_moved"] > 0
        assert not (tmp_path / "map").exists()


def test_profile_traces_the_inducing_phase(tmp_path, trained_map, capsys):
    common = _with_map(tmp_path, trained_map)
    trace_dir = tmp_path / "trace"
    train_scale.main(["train_inducing", "--alpha_ip", "0.005", "--profile", str(trace_dir),
                      *common])
    assert f"[profile] device trace written to {trace_dir}" in capsys.readouterr().out
    (path,) = glob.glob(str(trace_dir / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::cholesky_solve" in names          # the KL algebra of the Z steps


def test_profile_with_train_map_exits_before_any_work(tmp_path):
    with pytest.raises(SystemExit, match="inducing-training phase"):
        train_scale.main(["train_map", "--profile", str(tmp_path / "trace"), *_common(tmp_path)])
    assert not (tmp_path / "map").exists() and not (tmp_path / "trace").exists()


def test_gram_chunked_objective_trains_the_gram_z(tmp_path, trained_map):
    """``--objective gram_chunked`` (rows in chunks of 4 examples) trains the
    same Z as ``gram`` from the same MAP, and says so in the run meta."""
    common = _with_map(tmp_path, trained_map)
    Zs = {}
    for objective in ("gram_chunked", "gram"):
        train_scale.main(["train_inducing", "--objective", objective, "--alpha_ip", "0.005",
                          *common])
        assert jckpt.load_run_meta(str(tmp_path / "ind"), "ind_mnist")["objective"] == objective
        Zs[objective] = jckpt.load_array(str(tmp_path / "ind"), "ind_mnist", 3)
    np.testing.assert_allclose(Zs["gram_chunked"], Zs["gram"], rtol=1e-5, atol=1e-6)


def test_no_mesh_runs_the_pipeline(tmp_path, trained_map, capsys):
    """``--no-mesh`` (the reference's flag) on one device: the same run, no
    mesh either way."""
    common = _with_map(tmp_path, trained_map)
    result = train_scale.main(["train_inducing", "--no-mesh", "--alpha_ip", "0.005", *common])
    assert result["Z_moved"] > 0 and "[mesh]" not in capsys.readouterr().out


def test_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal cannot be observed")
    argv = ["train_map", *_common(tmp_path)]
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_scale.main(argv)


RESNET_CONFIG = os.path.join(REPO, "configs", "scale", "resnet1m_cifar10.yml")


def test_resnet1m_train_inducing_then_evaluate_on_cpu(tmp_path):
    """ResNet1M at full width (D = 1,084,586) through both CLIs on the CIFAR-10
    surrogate: a MAP file with BatchNorm statistics, one gram Z step at
    alpha 10 in example blocks of 4 as shipped (M = 2, a Z batch of 2), then
    the weight predictive on one test batch of 8 (3 samples in sample blocks
    of 2)."""
    text = open(RESNET_CONFIG).read()
    for old, new in (("    epochs: 100\n", "    epochs: 1\n"), ("    m: 50\n", "    m: 2\n"),
                     ("    batch_size: 32\n", "    batch_size: 2\n"),
                     ("    batch_size: 256\n", "    batch_size: 8\n"),
                     ("    mc_samples: 200\n", "    mc_samples: 3\n"),
                     ("  sample_block: 25\n", "  sample_block: 2\n")):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    config = tmp_path / "resnet1m_tiny.yml"
    config.write_text(text)
    (tmp_path / "data").mkdir()
    model = ResNet1M(10)
    flat, spec = params_from_jax(lecun_normal_params(FlatSpec.from_module(model), 0))
    rng = np.random.default_rng(0)
    stats = {name: torch.from_numpy((0.1 * rng.standard_normal(b.shape) if name.endswith("mean")
                                     else rng.uniform(0.5, 1.5, b.shape)).astype(np.float32))
             for name, b in model.named_buffers()}
    save_params(flat, spec, str(tmp_path / "map"), "map_cifar10", batch_stats=stats)
    common = ["--dataset", "cifar10", "--config", str(config), "--device", "cpu",
              "--ckpt_map", str(tmp_path / "map"), "--ckpt_induc", str(tmp_path / "ind"),
              "--data_dir", str(tmp_path / "data")]
    result = train_scale.main(["train_inducing", "--alpha_ip", "10", *common])
    assert result["Z_moved"] > 0 and result["alpha"]["alpha_src"] == "cli"
    records = evaluate.main(["--scalable", "--predictive", "weight", "--iters", "1",
                             "--max_batches", "1", *common])
    assert records[0]["alpha"] == 10.0 and records[0]["batches"] == 1
    for key in ("nll", "acc", "brier", "ece"):
        assert math.isfinite(records[0][key]), key
