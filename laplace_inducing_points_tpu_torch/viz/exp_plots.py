"""Experiment-results figures from the evaluation records.

The port's own copy of ``laplace_inducing_points_tpu/viz/exp_plots.py`` (numpy
and matplotlib only; matplotlib is imported when a figure is drawn, and
without it :func:`plot_records` says so and draws nothing). It renders the
JSONL records that ``cli/evaluate.py --out_json`` writes (one per repetition:
``dataset``, ``alpha`` and the metrics), a bar per (dataset, α) and metric,
with the reference's baseline numbers (BASELINE.md) as dashed lines.

Usage:
    python -m laplace_inducing_points_tpu_torch.viz.exp_plots \\
        results/banana_stochastic.jsonl --out fig/exp_banana.png
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Optional

import numpy as np

from laplace_inducing_points_tpu_torch.viz.style import draw

# reference baselines (means from BASELINE.md) keyed by dataset
REFERENCE_BASELINES = {
    "banana": {"nll": 0.1704, "acc": 1.0, "brier": 0.0717, "ece": 0.1468,
               "ood_auroc": 0.9296},
    "mnist": {"nll": 0.1007, "acc": 0.9839, "brier": 0.0364, "ece": 0.0588,
              "ood_auroc": 0.8977},
    "fmnist": {"nll": 0.4066, "acc": 0.8822, "brier": 0.1969, "ece": 0.1159,
               "ood_auroc": 0.9225},
    "cifar10": {"nll": 1.3844, "acc": 0.5624, "brier": 0.6606, "ece": 0.2345},
}

METRICS = ("nll", "acc", "brier", "ece", "ood_auroc")


def load_records(paths) -> list[dict]:
    """Every record of the JSONL files ``paths``, in order."""
    records = []
    for path in paths:
        with open(path) as f:
            records.extend(json.loads(line) for line in f if line.strip())
    return records


def _draw_records(records: list[dict], out_path: str) -> str:
    import matplotlib.pyplot as plt
    by_key = defaultdict(list)
    for r in records:
        by_key[(r["dataset"], r["alpha"])].append(r)
    metrics = [m for m in METRICS if any(m in r for r in records)]
    fig, axs = plt.subplots(1, len(metrics), figsize=(3.2 * len(metrics), 4), squeeze=False)
    labels = [f"{d}\nα={a:g}" for (d, a) in by_key]
    xs = np.arange(len(by_key))
    for ax, metric in zip(axs[0], metrics):
        vals = [[r[metric] for r in recs if metric in r] for recs in by_key.values()]
        ax.bar(xs, [np.mean(v) if v else np.nan for v in vals],
               yerr=[np.std(v) if v else 0.0 for v in vals], capsize=3, color="#68a")
        ax.set_xticks(xs)
        ax.set_xticklabels(labels, fontsize=8)
        ax.set_title(metric.upper())
        for i, (d, _) in enumerate(by_key):
            ref = REFERENCE_BASELINES.get(d, {}).get(metric)
            if ref is not None:
                ax.hlines(ref, i - 0.4, i + 0.4, colors="#d33", linestyles="dashed",
                          label="reference" if i == 0 else None)
        if ax.get_legend_handles_labels()[0]:
            ax.legend(fontsize=8)
    fig.suptitle("IP-LLA evaluation vs reference baselines")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=140, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_records(records: list[dict], out_path: str) -> Optional[str]:
    """The metrics of ``records`` by (dataset, α) beside the reference's
    baselines, written to ``out_path``; ``None`` without matplotlib."""
    if not records:
        raise ValueError("no records to plot")
    return draw("the evaluation records", _draw_records, records, out_path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("jsonl", nargs="+", help="evaluation JSONL record files")
    p.add_argument("--out", default="fig/exp_results.png")
    args = p.parse_args(argv)
    records = load_records(args.jsonl)
    if not records:
        raise SystemExit("no records found")
    out = plot_records(records, args.out)
    if out:
        print(f"wrote {out} ({len(records)} records)")


if __name__ == "__main__":
    main()
