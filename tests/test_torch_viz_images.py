"""The port's image figures and results figures: ``viz.nplot.plot_image_grid``
and the ``mnist``/``fmnist``/``cifar10`` branch of ``make_inducing_callback``
(the JAX package's ``viz/nplot.py:295-351``), driven by
``training.train_inducing_points``; ``viz.exp_plots`` on the records the
port's ``cli/evaluate.py --out_json`` writes; ``viz.figures``. Each writes its
file where matplotlib is installed (it is here) and says so and draws nothing
where it is not (the card's machine)."""

import os
import sys

import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu_torch.cli import evaluate
from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.data import scale as tscale
from laplace_inducing_points_tpu_torch.data.loader import cycling_batches
from laplace_inducing_points_tpu_torch.models import LeNet5
from laplace_inducing_points_tpu_torch.training import train_inducing_points
from laplace_inducing_points_tpu_torch.utils.checkpoint import save_array, save_params
from laplace_inducing_points_tpu_torch.viz import exp_plots, figures, nplot
from torch_twins import inputs, make_twins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib unimportable, as on the card's machine."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def _png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_mnist_callback_draws_z_while_train_inducing_points_runs(tmp_path):
    """Three gram Z steps of a full-width LeNet5 at M = 2 with the image
    callback at every step: ``ips_mnist.png`` holds the grid of Z."""
    _, state, _ = make_twins("lenet5")
    Z = torch.from_numpy(inputs("lenet5", 2))
    x = inputs("lenet5", 4, seed=2)
    cb = nplot.make_inducing_callback("mnist", every=1, fig_dir=str(tmp_path))
    out = train_inducing_points(state, Z, cycling_batches([(x, np.zeros(4))]), alpha=1.0,
                                num_steps=3, lr=1e-2, full_set_size=100, callback=cb)
    assert out.shape == Z.shape and not torch.equal(out, Z)
    assert _png(tmp_path / "ips_mnist.png")


@pytest.mark.parametrize("plot_type, shape", [("fmnist", (5, 28, 28, 1)),
                                              ("cifar10", (40, 32, 32, 3))])
def test_image_callback_moves_z_to_the_host_only_on_drawn_steps(plot_type, shape, tmp_path,
                                                                monkeypatch):
    moved = []
    numpy = nplot._numpy
    monkeypatch.setattr(nplot, "_numpy", lambda t: (moved.append(1), numpy(t))[1])
    cb = nplot.make_inducing_callback(plot_type, every=4, fig_dir=str(tmp_path))
    Z = torch.rand(*shape, generator=torch.Generator().manual_seed(0))
    for step in range(9):
        cb(step, Z, 0.0)
    assert len(moved) == 3                 # steps 0, 4 and 8
    assert _png(tmp_path / f"ips_{plot_type}.png")
    assert cb.trajectory == []             # images keep no trajectory


def test_image_callback_without_matplotlib_says_so_and_draws_nothing(no_matplotlib, tmp_path,
                                                                    capsys, monkeypatch):
    moved = []
    monkeypatch.setattr(nplot, "_numpy", lambda t: moved.append(1))
    cb = nplot.make_inducing_callback("cifar10", every=1, fig_dir=str(tmp_path))
    assert capsys.readouterr().out == ("[viz] matplotlib not installed: the inducing points "
                                       "of cifar10 not drawn\n")
    for step in range(3):
        cb(step, torch.zeros(2, 32, 32, 3), 0.0)
    assert moved == [] and not os.listdir(tmp_path)
    assert nplot.plot_image_grid(np.zeros((2, 28, 28, 1)), save_path=str(tmp_path / "x.png")) \
        is None
    assert "matplotlib not installed" in capsys.readouterr().out
    assert nplot.make_inducing_callback("svhn") is None


def test_plot_image_grid_takes_tensors_and_returns_the_figure(tmp_path):
    import matplotlib.pyplot as plt
    imgs = torch.rand(9, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    fig, axs = nplot.plot_image_grid(imgs, step=3, name="mnist")
    assert axs.shape == (2, 8) and fig._suptitle.get_text() == "mnist inducing points 3"
    plt.close(fig)
    path = nplot.plot_image_grid(imgs.numpy(), color=False, save_path=str(tmp_path / "g.png"))
    assert _png(path)


def test_exp_plots_renders_the_records_of_the_ports_evaluate(tmp_path, capsys):
    """``cli.evaluate --out_json`` on a seeded LeNet5 (M = 2, one batch, two
    repetitions), then ``exp_plots``'s CLI on the file: the records carry
    ``dataset``, ``alpha`` and the metrics, and the figure is written."""
    text = open(os.path.join(REPO, "configs", "scale", "lenet5_mnist.yml")).read()
    for old, new in (("    m: 100\n", "    m: 2\n"), ("    mc_samples: 200\n",
                                                       "    mc_samples: 3\n")):
        text = text.replace(old, new)
    (tmp_path / "cfg.yml").write_text(text)
    (tmp_path / "data").mkdir()
    flat, spec = params_from_jax(lecun_normal_params(FlatSpec.from_module(LeNet5()), 0))
    save_params(flat, spec, str(tmp_path / "map"), "map_mnist")
    x, _ = tscale.load_arrays("mnist", train=True, root=str(tmp_path / "data"))
    save_array(x[:2], str(tmp_path / "ind"), "ind_mnist", 250)
    out_json = tmp_path / "eval.jsonl"
    evaluate.main(["--dataset", "mnist", "--config", str(tmp_path / "cfg.yml"), "--scalable",
                   "--predictive", "weight", "--iters", "2", "--max_batches", "1",
                   "--device", "cpu", "--ckpt_map", str(tmp_path / "map"), "--ckpt_induc",
                   str(tmp_path / "ind"), "--data_dir", str(tmp_path / "data"),
                   "--out_json", str(out_json)])
    records = exp_plots.load_records([str(out_json)])
    assert len(records) == 2 and {r["dataset"] for r in records} == {"mnist"}
    assert all(np.isfinite(r[m]) for r in records for m in ("nll", "acc", "brier", "ece"))
    capsys.readouterr()
    exp_plots.main([str(out_json), "--out", str(tmp_path / "fig" / "exp.png")])
    assert capsys.readouterr().out.startswith("wrote ")
    assert _png(tmp_path / "fig" / "exp.png")


def test_exp_plots_and_figures_without_matplotlib(no_matplotlib, tmp_path, capsys):
    records = [{"dataset": "banana", "alpha": 0.5, "nll": 0.2, "acc": 1.0}]
    assert exp_plots.plot_records(records, str(tmp_path / "e.png")) is None
    assert figures.laplace_1d_figure(str(tmp_path / "l.png")) is None
    assert capsys.readouterr().out.count("matplotlib not installed") == 2
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError):
        exp_plots.plot_records([], str(tmp_path / "e.png"))


def test_figures_draw_and_fit_the_bimodal_target(tmp_path):
    """Both figures are written; the forward-KL fit (mass-covering) is the
    widest Gaussian of the grid's two fits and sits between the modes."""
    assert _png(figures.laplace_1d_figure(str(tmp_path / "laplace.png")))
    assert _png(figures.kl_asymmetry_figure(str(tmp_path / "kl.png")))
    xs = np.linspace(-6, 6, 601)
    p = 0.55 * figures._normal(xs, -2.0, 0.7) + 0.45 * figures._normal(xs, 2.2, 0.9)
    p /= p.sum() * (xs[1] - xs[0])
    (kl_f, mu_f, sig_f), (kl_r, mu_r, sig_r) = figures.best_gaussian_fits(xs, p)
    assert 0 < kl_f and 0 < kl_r and sig_f >= sig_r
    assert sig_f > 1.5 and abs(mu_f) < 0.5
