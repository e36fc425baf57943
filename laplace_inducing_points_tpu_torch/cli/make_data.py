"""Toy-dataset generation CLI.

Counterpart of ``laplace_inducing_points_tpu/cli/make_data.py``, with its
options and defaults. The points come from the port's generators
(``data.toy``, a seeded CPU ``torch.Generator``): one seed gives the same
file on every machine, but not the JAX package's points for that seed.

Usage:
    python -m laplace_inducing_points_tpu_torch.cli.make_data \\
        --dataset sine --n_samples 200 --noise 0.3 --seed 999 \\
        --out_file data/sine.npz [--split_in_middle] [--plot]
"""

from __future__ import annotations

import argparse
import os

from laplace_inducing_points_tpu_torch.data.toy import GENERATORS, create_dataset, save_dataset


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True, choices=sorted(GENERATORS),
                   help="which dataset to create")
    p.add_argument("--n_samples", type=int, default=128)
    p.add_argument("--noise", type=float, default=0.05)
    p.add_argument("--split_in_middle", action="store_true",
                   help="sine only: leave a gap in the input domain")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out_file", default=None)
    p.add_argument("--plot", action="store_true",
                   help="also save a scatter figure under fig/ (needs matplotlib)")
    return p


def main(argv=None) -> str:
    """Write the dataset; returns the path of the npz."""
    args = build_parser().parse_args(argv)
    kwargs = {"split_in_middle": args.split_in_middle} if args.dataset == "sine" else {}
    x, y = create_dataset(args.dataset, args.n_samples, args.seed, noise=args.noise, **kwargs)
    out = args.out_file or os.path.join("data", f"{args.dataset}.npz")
    save_dataset(x, y, out)
    print(f"Saved {args.dataset} data at {out} with shape x={tuple(x.shape)}, y={tuple(y.shape)}")
    if args.plot:
        from laplace_inducing_points_tpu_torch.viz.nplot import draw, draw_dataset
        path = draw(f"fig/{args.dataset}.png", draw_dataset, x, y, args.dataset == "sine",
                    f"{args.dataset} dataset", os.path.join("fig", f"{args.dataset}.png"))
        if path is not None:
            print(f"Saved figure {path}")
    return out


if __name__ == "__main__":
    main()
