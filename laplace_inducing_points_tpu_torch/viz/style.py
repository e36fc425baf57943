"""Thesis figure styling: the reference's global plot theme.

The port's own copy of ``laplace_inducing_points_tpu/viz/style.py`` (the port
imports nothing of that package): seaborn ``darkgrid``, Computer Modern
serif text at ``font.size: 22`` through matplotlib's mathtext (no TeX
binary), Type-42 font embedding, the named accent colors and the ``icefire``
diverging palette for heatmaps. matplotlib is imported where a function needs
it, so the module imports on a machine without it. Styling is opt-in:
:func:`use_thesis_style` (``main_toy --style thesis``) before the figures.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, Optional


class Colors(str, Enum):
    """Accent palette."""

    paleblue = "#8888FF"
    deepblue = "#375E97"
    darkorange = "#FB6542"
    yellow = "#FFBB00"
    darkgray = "#333"


_THESIS_RC = {
    "font.family": "serif",
    "font.serif": ["cmr10", "Computer Modern Roman", "DejaVu Serif"],
    "mathtext.fontset": "cm",
    "axes.formatter.use_mathtext": True,   # cmr10 lacks a plain minus sign
    "pdf.fonttype": 42,
    "ps.fonttype": 42,
    "font.size": 22,
}

_ACTIVE = False


def is_active() -> bool:
    """True once :func:`use_thesis_style` has been applied."""
    return _ACTIVE


def use_thesis_style(font_size: int | None = None) -> None:
    """Activate the theme process-wide: seaborn ``darkgrid`` (or the same axes
    and grid colors without seaborn) and the rcParams above."""
    import matplotlib as mpl
    try:
        import seaborn as sns
        sns.set_style("darkgrid")
    except ImportError:
        mpl.rcParams.update({
            "axes.facecolor": "#EAEAF2",
            "axes.edgecolor": "white",
            "axes.grid": True,
            "grid.color": "white",
            "axes.axisbelow": True,
            "xtick.color": ".15",
            "ytick.color": ".15",
        })
    rc = dict(_THESIS_RC)
    if font_size is not None:
        rc["font.size"] = font_size
    mpl.rcParams.update(rc)
    global _ACTIVE
    _ACTIVE = True


def get_palette():
    """Diverging heatmap palette: seaborn's ``icefire``, else matplotlib's
    ``coolwarm``."""
    import matplotlib as mpl
    try:
        import seaborn as sns
        return sns.color_palette("icefire", as_cmap=True)
    except ImportError:
        return mpl.colormaps["coolwarm"]


def draw(name: str, fn: Callable, *args, **kwargs) -> Optional[str]:
    """``fn(*args, **kwargs)`` when matplotlib imports (on its file backend);
    otherwise one line that the figure ``name`` was not drawn."""
    try:
        import matplotlib
    except ImportError:
        print(f"[viz] matplotlib not installed: {name} not drawn")
        return None
    matplotlib.use("Agg")
    return fn(*args, **kwargs)
