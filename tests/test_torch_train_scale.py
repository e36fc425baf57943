"""The port's trainer CLI end to end on the CPU at a tiny configuration, chained
into the evaluation CLI, and its refusals of what is not ported."""

import json
import math

import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.utils import checkpoint as jckpt
from laplace_inducing_points_tpu_torch.cli import evaluate, train_scale

from test_torch_cli import CONFIG


def _tiny_config(tmp_path) -> str:
    """lenet5_mnist.yml with 1 MAP epoch, 3 Z steps, M = 2, a Z batch of 4
    and 3 predictive samples (D stays 61,706)."""
    text = open(CONFIG).read()
    for old, new in (("    epochs: 150\n", "    epochs: 1\n"),
                     ("    epochs: 250\n", "    epochs: 3\n"),
                     ("    m: 100\n", "    m: 2\n"),
                     ("    batch_size: 128\n", "    batch_size: 4\n"),
                     ("    mc_samples: 200\n", "    mc_samples: 3\n")):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path = tmp_path / "lenet5_mnist_tiny.yml"
    path.write_text(text)
    return str(path)


def _common(tmp_path):
    (tmp_path / "data").mkdir(exist_ok=True)
    return ["--dataset", "mnist", "--config", _tiny_config(tmp_path), "--device", "cpu",
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


@pytest.mark.parametrize("extra", [
    ["--continue"],
    ["--alpha_mode", "evidence"],
    ["--profile", "trace"],
    ["--mesh"],
    ["--objective", "stochastic"],
    ["--objective", "dense"],
    [],                                         # no --alpha_ip: the grid search
])
def test_unported_flags_raise(tmp_path, extra):
    argv = ["full_pipeline", *extra, *_common(tmp_path)]
    if extra:
        argv += ["--alpha_ip", "0.005"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_scale.main(argv)
    assert not (tmp_path / "map").exists()       # refused before any work


def test_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal cannot be observed")
    argv = ["train_map", *_common(tmp_path)]
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_scale.main(argv)
