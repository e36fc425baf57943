"""Standalone illustrative figures (thesis-figure parity).

The port's own copy of ``laplace_inducing_points_tpu/viz/figures.py`` (numpy
and matplotlib only; matplotlib is imported when a figure is drawn, and
without it each figure says so and draws nothing): the 1-D Laplace
approximation of a skewed density, and the forward/reverse KL asymmetry
between a bimodal target and a unimodal fit, regenerated from the
underlying math.

Usage:
    python -m laplace_inducing_points_tpu_torch.viz.figures
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from laplace_inducing_points_tpu_torch.viz.style import draw


def _save(fig, save_path: str) -> str:
    import matplotlib.pyplot as plt
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def _normal(x, mu, sig):
    return np.exp(-0.5 * ((x - mu) / sig) ** 2) / (np.sqrt(2 * np.pi) * sig)


def _draw_laplace_1d(save_path: str) -> str:
    import matplotlib.pyplot as plt
    k, theta = 3.0, 1.0
    mode = (k - 1) * theta
    var = mode ** 2 / (k - 1)     # curvature at the mode: d²/dx² log p = -(k-1)/x²
    xs = np.linspace(1e-2, 10, 400)
    p = np.exp((k - 1) * np.log(xs) - xs / theta)
    p /= np.sum((p[1:] + p[:-1]) * np.diff(xs)) / 2          # trapezoid rule
    q = _normal(xs, mode, np.sqrt(var))
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(xs, p, label="true density $p$", color="#345", lw=2)
    ax.plot(xs, q, label="Laplace approx $q$", color="#d62", lw=2, ls="--")
    ax.axvline(mode, color="gray", lw=0.8, ls=":")
    ax.annotate("mode", (mode, 0), textcoords="offset points", xytext=(4, 6), color="gray")
    ax.set_title("Laplace approximation matches curvature at the mode")
    ax.legend()
    return _save(fig, save_path)


def laplace_1d_figure(save_path: str = "fig/laplace_example.png") -> Optional[str]:
    """Laplace approximation of a skewed 1-D density around its mode: a
    Gamma-like density matched at its mode by the Gaussian of the same
    curvature, the fit near the mode and the mismatch in the tails."""
    return draw("the 1-D Laplace figure", _draw_laplace_1d, save_path)


def best_gaussian_fits(xs: np.ndarray, p: np.ndarray):
    """``((forward KL, mu, sigma), (reverse KL, mu, sigma))``: the Gaussians
    of a grid over mu in [-4, 4] and sigma in [0.3, 4] closest to the
    density ``p`` on ``xs`` under KL(p‖q) and KL(q‖p)."""
    dx = xs[1] - xs[0]

    def kl(a, b):
        mask = a > 1e-12
        return float(np.sum(a[mask] * np.log(a[mask] / b[mask])) * dx)

    best_fwd, best_rev = None, None
    for mu in np.linspace(-4, 4, 81):
        for sig in np.linspace(0.3, 4.0, 75):
            q = _normal(xs, mu, sig)
            q = q / (q.sum() * dx)
            f, r = kl(p, q), kl(q, p)
            if best_fwd is None or f < best_fwd[0]:
                best_fwd = (f, mu, sig)
            if best_rev is None or r < best_rev[0]:
                best_rev = (r, mu, sig)
    return best_fwd, best_rev


def _draw_kl_asymmetry(save_path: str) -> str:
    import matplotlib.pyplot as plt
    xs = np.linspace(-6, 6, 601)
    p = 0.55 * _normal(xs, -2.0, 0.7) + 0.45 * _normal(xs, 2.2, 0.9)
    p /= p.sum() * (xs[1] - xs[0])
    best_fwd, best_rev = best_gaussian_fits(xs, p)
    fig, axs = plt.subplots(1, 2, figsize=(11, 4), sharey=True)
    for ax, (_, mu, sig), name in (
            (axs[0], best_fwd, r"forward $KL(p\|q)$ — mass-covering"),
            (axs[1], best_rev, r"reverse $KL(q\|p)$ — mode-seeking")):
        ax.plot(xs, p, color="#345", lw=2, label="target $p$")
        ax.plot(xs, _normal(xs, mu, sig), color="#d62", lw=2, ls="--",
                label="best Gaussian $q$")
        ax.set_title(name)
        ax.legend()
    return _save(fig, save_path)


def kl_asymmetry_figure(save_path: str = "fig/kl_example.png") -> Optional[str]:
    """Forward against reverse KL fits of a Gaussian to a bimodal mixture:
    reverse KL (the direction of the inducing-point objective) seeks a mode,
    forward KL covers the mass."""
    return draw("the KL asymmetry figure", _draw_kl_asymmetry, save_path)


if __name__ == "__main__":
    print(laplace_1d_figure())
    print(kl_asymmetry_figure())
