"""The toy figures: the predictive computations on the device, then drawing.

Counterpart of ``laplace_inducing_points_tpu/viz/nplot.py``. Each figure of
the reference is split in two here: a torch function that computes what the
figure shows and returns it as numpy arrays (the MAP softmax on the 150×150
grid, ``plot_map_2d_classification`` ``:116``; the grid predictive's mean and
std, ``plot_lla_2d_classification`` ``:71``; the dense 1-D predictive with X
and with Z, ``plot_regression_lla_1d`` ``:143``; the MAP / sampled Laplace /
linearized panels, ``make_predictive_mean_figure`` ``:180``; the IP-LLA mean
and std, ``make_comparison_figure`` ``:248``; the inducing-point
trajectory and image grids, ``make_inducing_callback`` ``:325`` and
``plot_image_grid`` ``:295``), and a ``draw_*`` function that imports
matplotlib inside itself. Without matplotlib ``draw`` (``viz/style.py``)
prints one line a figure and draws nothing; every computation has run all
the same.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from laplace_inducing_points_tpu_torch.core.operators import model_outputs
from laplace_inducing_points_tpu_torch.evaluation.harness import make_batch_sampler
from laplace_inducing_points_tpu_torch.inference.lla import (predict_la_samples_dense,
                                                             predict_lla_dense,
                                                             predict_lla_scalable)
from laplace_inducing_points_tpu_torch.viz.style import draw

GRID_CHUNK = 4096        # grid points per predictive call


def _grid(xtrain, pad: float = 1.5, num: int = 150):
    x = np.asarray(xtrain)
    g = np.linspace(x.min() - pad, x.max() + pad, num)
    xx, yy = np.meshgrid(g, g)
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1).astype(np.float32)
    return xx, yy, pts


def _on(state, a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=state.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=state.device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@torch.no_grad()
def map_2d_classification(state, xtrain, *, grid_num: int = 150) -> dict:
    """The MAP's ``p(class 1)`` on the grid: ``{"xx", "yy", "p1"}``."""
    xx, yy, pts = _grid(xtrain, num=grid_num)
    p = torch.softmax(model_outputs(state, state.flat_params, _on(state, pts)), dim=-1)
    return {"xx": xx, "yy": yy, "p1": _numpy(p[:, 1]).reshape(xx.shape)}


def _grid_probs(state, pts: np.ndarray, Z, alpha: float, generator: torch.Generator,
                num_mc_samples: int, full_set_size, scalable: bool) -> torch.Tensor:
    """``(S, G, K)`` predictive probabilities over the grid points, the
    posterior built once and the points taken ``GRID_CHUNK`` at a time."""
    sampler = make_batch_sampler(state, _on(state, Z), alpha=alpha,
                                 full_set_size=full_set_size,
                                 num_mc_samples=num_mc_samples, scalable=scalable)
    return torch.cat([torch.softmax(sampler(_on(state, pts[i:i + GRID_CHUNK]), generator),
                                    dim=-1)
                      for i in range(0, pts.shape[0], GRID_CHUNK)], dim=1)


@torch.no_grad()
def lla_2d_classification(state, xtrain, Z, alpha: float, *, generator: torch.Generator,
                          num_mc_samples: int = 500, full_set_size: Optional[int] = None,
                          scalable: bool = True, grid_num: int = 150) -> dict:
    """The IP-LLA predictive's mean and std of ``p(class 1)`` on the grid
    (scalable or dense): ``{"xx", "yy", "mean_p1", "std_p1"}``."""
    xx, yy, pts = _grid(xtrain, num=grid_num)
    probs = _grid_probs(state, pts, Z, alpha, generator, num_mc_samples, full_set_size,
                        scalable)
    return {"xx": xx, "yy": yy,
            "mean_p1": _numpy(probs.mean(0)[:, 1]).reshape(xx.shape),
            "std_p1": _numpy(probs.std(0, unbiased=False)[:, 1]).reshape(xx.shape)}


@torch.no_grad()
def regression_lla_1d(state, xtrain, Z, alpha: float, *,
                      full_set_size: Optional[int] = None, num: int = 100) -> dict:
    """The dense 1-D predictive on a line through the data, with the full
    training set and with Z: ``{"xlin", "full_mean", "full_std", "ip_mean",
    "ip_std"}``."""
    x = np.asarray(xtrain)
    xlin = np.linspace(x.min(), x.max(), num)[:, None].astype(np.float32)
    full = predict_lla_dense(state, _on(state, xlin), _on(state, xtrain), alpha)
    ip = predict_lla_dense(state, _on(state, xlin), _on(state, Z), alpha,
                           full_set_size=full_set_size or x.shape[0])
    return {"xlin": xlin, "full_mean": _numpy(full.mean).squeeze(),
            "full_std": _numpy(full.stddev()).squeeze(),
            "ip_mean": _numpy(ip.mean).squeeze(), "ip_std": _numpy(ip.stddev()).squeeze()}


@torch.no_grad()
def predictive_mean_comparison(state, xtrain, alpha: float, *, generator: torch.Generator,
                               num_mc_samples: int = 100, grid_num: int = 120) -> dict:
    """Three grids of ``E[p(class 1)]``: the MAP, the sampled (non-linearized)
    Laplace predictive and the linearized one, both on the full training set:
    ``{"xx", "yy", "p_map", "p_la", "p_lla"}``."""
    xx, yy, pts = _grid(xtrain, pad=1.0, num=grid_num)
    pts_t, Z = _on(state, pts), _on(state, xtrain)
    p_map = torch.softmax(model_outputs(state, state.flat_params, pts_t), -1)[:, 1]
    la = predict_la_samples_dense(state, pts_t, Z, alpha, generator,
                                  full_set_size=Z.shape[0], num_mc_samples=num_mc_samples)
    lla = predict_lla_scalable(state, pts_t, Z, alpha, generator, full_set_size=Z.shape[0],
                               num_samples=num_mc_samples)
    mean_p1 = lambda logits: _numpy(torch.softmax(logits, -1).mean(0)[:, 1]).reshape(xx.shape)
    return {"xx": xx, "yy": yy, "p_map": _numpy(p_map).reshape(xx.shape),
            "p_la": mean_p1(la), "p_lla": mean_p1(lla)}


@torch.no_grad()
def ip_lla_comparison(state, xtrain, Z, alpha: float, *, generator: torch.Generator,
                      num_mc_samples: int = 100, scalable: bool = True,
                      full_set_size: Optional[int] = None, grid_num: int = 120) -> dict:
    """The IP-LLA predictive's mean and std on the comparison grid:
    ``{"xx", "yy", "mean_p", "std_p"}``."""
    xx, yy, pts = _grid(xtrain, pad=1.0, num=grid_num)
    probs = _grid_probs(state, pts, Z, alpha, generator, num_mc_samples, full_set_size,
                        scalable)
    return {"xx": xx, "yy": yy,
            "mean_p": _numpy(probs.mean(0)[:, 1]).reshape(xx.shape),
            "std_p": _numpy(probs.std(0, unbiased=False)[:, 1]).reshape(xx.shape)}


def all_finite(result: dict) -> bool:
    """Whether every array of a computed figure is finite."""
    return all(np.all(np.isfinite(np.asarray(v))) for v in result.values())


# ---------------------------------------------------------------------------
# drawing (matplotlib, imported where it is used)
# ---------------------------------------------------------------------------

def _heat_cmap():
    from laplace_inducing_points_tpu_torch.viz import style
    return style.get_palette() if style.is_active() else "RdBu"


def _save(fig, save_path: str) -> str:
    import matplotlib.pyplot as plt
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def _scatter_classes(ax, x, y, c0="#d66", c1="#68c"):
    x, y = np.asarray(x), np.asarray(y).ravel()
    ax.scatter(*x[y == 0].T, s=12, color=c0, label="class 0", zorder=2)
    ax.scatter(*x[y == 1].T, s=12, color=c1, label="class 1", zorder=2)


def _scatter_inducing(ax, Z):
    Z = np.asarray(Z)
    ax.scatter(Z[:, 0], Z[:, 1], marker="X", color="yellow", zorder=8,
               label="Inducing points")


def draw_dataset(x, y, regression: bool, title: str, save_path: str) -> str:
    """A scatter of a toy dataset: ``y`` against ``x`` for a regression,
    the two classes in the plane otherwise."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4))
    if regression:
        ax.scatter(np.asarray(x).ravel(), np.asarray(y).ravel(), s=12, alpha=0.8)
    else:
        _scatter_classes(ax, x, y)
    ax.set_title(title)
    return _save(fig, save_path)


def draw_map_2d(res: dict, xtrain, ytrain, save_path: str) -> str:
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 5))
    im = ax.contourf(res["xx"], res["yy"], res["p1"], levels=30, cmap=_heat_cmap())
    fig.colorbar(im, ax=ax)
    _scatter_classes(ax, xtrain, ytrain)
    ax.set_title("MAP estimator")
    fig.tight_layout()
    return _save(fig, save_path)


def draw_lla_2d(res: dict, xtrain, ytrain, Z, save_path: str, *, plot_Z: bool = True,
                plot_X: bool = False) -> str:
    import matplotlib.pyplot as plt
    fig, axs = plt.subplots(1, 2, figsize=(13, 5))
    im0 = axs[0].contourf(res["xx"], res["yy"], res["mean_p1"], levels=30, cmap=_heat_cmap())
    axs[0].set_title("predictive mean p(class 1)")
    fig.colorbar(im0, ax=axs[0])
    im1 = axs[1].contourf(res["xx"], res["yy"], res["std_p1"], levels=30, cmap="viridis")
    axs[1].set_title("predictive std")
    fig.colorbar(im1, ax=axs[1])
    for ax in axs:
        if plot_X:
            _scatter_classes(ax, xtrain, ytrain)
        if plot_Z:
            _scatter_inducing(ax, Z)
    fig.tight_layout()
    return _save(fig, save_path)


def _cinterval(ax, x, mu, sigma, color, text, zorder):
    x, mu, sigma = (np.asarray(a).ravel() for a in (x, mu, sigma))
    ax.plot(x, mu, color=color, zorder=zorder + 1, label=f"{text} mean")
    ax.fill_between(x, mu - 2 * sigma, mu + 2 * sigma, color=color, alpha=0.25,
                    zorder=zorder, label=f"{text} ±2σ")


def draw_regression_1d(res: dict, xtrain, ytrain, Z, save_path: str) -> str:
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 5))
    _cinterval(ax, res["xlin"], res["full_mean"], res["full_std"], "orange", "full", 5)
    _cinterval(ax, res["xlin"], res["ip_mean"], res["ip_std"], "limegreen", "inducing", 4)
    ax.scatter(np.asarray(xtrain).ravel(), np.asarray(ytrain).ravel(), s=12, alpha=0.8)
    zs = np.asarray(Z).ravel()
    ax.plot(zs, np.full_like(zs, ax.get_ylim()[0]), "^", color="limegreen", markersize=7,
            label="Z", zorder=6)
    ax.legend(loc="lower right")
    fig.tight_layout()
    return _save(fig, save_path)


def draw_predictive_mean(res: dict, xtrain, ytrain, save_path: str) -> str:
    import matplotlib as mpl
    import matplotlib.pyplot as plt
    norm = mpl.colors.Normalize(0, 1)
    fig, axs = plt.subplots(1, 3, figsize=(13, 4), sharex=True, constrained_layout=True)
    for ax, key, title in zip(axs, ("p_map", "p_la", "p_lla"),
                              ("NN MAP", "Without Linearization", "With Linearization")):
        ax.pcolormesh(res["xx"], res["yy"], res[key], cmap=_heat_cmap(), norm=norm,
                      rasterized=True)
        _scatter_classes(ax, xtrain, ytrain)
        ax.set_title(title)
        ax.set_xlabel(r"$x_1$")
        ax.set_xticks([])
        ax.set_yticks([])
    axs[0].set_ylabel(r"$x_2$")
    fig.colorbar(mpl.cm.ScalarMappable(norm=norm, cmap=_heat_cmap()), ax=axs,
                 location="left", label=r"$\mathrm{E}[y^* \mid x^*, \mathcal{D}]$")
    return _save(fig, save_path)


def draw_comparison(res: dict, xtrain, ytrain, Z, save_path: str) -> str:
    import matplotlib.pyplot as plt
    fig, axs = plt.subplots(2, 1, figsize=(7, 11), sharex=True, sharey=True,
                            constrained_layout=True)
    im0 = axs[0].pcolormesh(res["xx"], res["yy"], res["mean_p"], cmap=_heat_cmap(),
                            rasterized=True)
    fig.colorbar(im0, ax=axs[0])
    im1 = axs[1].pcolormesh(res["xx"], res["yy"], res["std_p"], cmap="viridis",
                            rasterized=True)
    fig.colorbar(im1, ax=axs[1])
    for ax in axs:
        _scatter_classes(ax, xtrain, ytrain)
        _scatter_inducing(ax, Z)
        ax.set_xticks([])
        ax.set_yticks([])
    axs[1].set_xlabel(r"$x_1$")
    return _save(fig, save_path)


def _draw_trajectory(traj: np.ndarray, z_np: np.ndarray, step: int, loss: float, xtrain,
                     ytrain, save_path: str) -> str:
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.plot(traj[:, :, 0], traj[:, :, 1], "-o", color="black", markersize=2, zorder=7)
    if xtrain is not None:
        _scatter_classes(ax, xtrain, ytrain)
    _scatter_inducing(ax, z_np)
    ax.set_title(f"Inducing point trajectory after {step} steps (loss {loss:.2f})")
    return _save(fig, save_path)


def _draw_image_grid(imgs: np.ndarray, color: bool, step, name: str,
                     save_path: Optional[str]):
    import matplotlib.pyplot as plt
    n, cols = min(len(imgs), 32), 8
    rows = -(-n // cols)
    fig, axs = plt.subplots(rows, cols, figsize=(cols * 1.4, rows * 1.4), squeeze=False)
    for i in range(rows * cols):
        ax = axs[i // cols, i % cols]
        ax.axis("off")
        if i < n:
            if color:
                ax.imshow(np.clip(imgs[i], 0, 1))
            else:
                ax.imshow(imgs[i].squeeze(), cmap="gray")
    fig.suptitle(f"{name} inducing points {step}")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig, axs


def plot_image_grid(batch, *, color: bool = False, step="", name: str = "",
                    save_path: Optional[str] = None):
    """The first 32 images of ``batch`` (NHWC; a tensor or an array) in rows
    of 8, grayscale or ``color`` (``plot_image_grid``, ``:295``): the path
    written, or ``(fig, axs)`` without ``save_path``; ``None`` without
    matplotlib."""
    imgs = _numpy(batch) if isinstance(batch, torch.Tensor) else np.asarray(batch)
    return draw("the inducing-point image grid", _draw_image_grid, imgs, color, step, name,
                save_path)


IMAGE_PLOTS = {"mnist": False, "fmnist": False, "cifar10": True}      # -> color
TRAJECTORY_PLOTS = ("spiral", "xor", "banana")


def make_inducing_callback(plot_type: Optional[str], xtrain=None, ytrain=None,
                           every: int = 4, fig_dir: str = "fig", max_snapshots: int = 3):
    """A ``callback(step, Z, loss)`` for ``train_inducing_points`` that acts
    every ``every``-th step (``:325``): for a 2-D toy it keeps the last
    ``max_snapshots`` Z and draws their trajectory over the data
    (``callback.trajectory`` holds them); for ``mnist``, ``fmnist`` and
    ``cifar10`` it draws the first 32 points of Z as images into
    ``ips_<plot_type>.png`` (``:345-351``). Z goes to the host once on such a
    step and never on another. ``None`` for another plot type. Without
    matplotlib it says so once and draws nothing."""
    if plot_type not in TRAJECTORY_PLOTS and plot_type not in IMAGE_PLOTS:
        return None
    trajectory: list = []
    try:
        import matplotlib  # noqa: F401
        drawing = True
    except ImportError:
        what = ("the inducing-point trajectory" if plot_type in TRAJECTORY_PLOTS
                else f"the inducing points of {plot_type}")
        print(f"[viz] matplotlib not installed: {what} not drawn")
        drawing = False

    def callback(step: int, Z, loss: float):
        if step % every != 0 or not (drawing or plot_type in TRAJECTORY_PLOTS):
            return
        z_np = _numpy(Z) if isinstance(Z, torch.Tensor) else np.asarray(Z)
        if plot_type in IMAGE_PLOTS:
            plot_image_grid(z_np[:32], color=IMAGE_PLOTS[plot_type], step=step, name=plot_type,
                            save_path=os.path.join(fig_dir, f"ips_{plot_type}.png"))
            return
        trajectory.append(z_np)
        del trajectory[:-max_snapshots]
        if drawing:
            draw("the inducing-point trajectory", _draw_trajectory, np.stack(trajectory), z_np,
                 step, loss, xtrain, ytrain, os.path.join(fig_dir, "ips_trajectory.png"))

    callback.trajectory = trajectory
    return callback
