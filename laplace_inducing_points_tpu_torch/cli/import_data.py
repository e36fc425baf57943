"""Import user-supplied real datasets (offline ingestion path).

Counterpart of ``laplace_inducing_points_tpu/cli/import_data.py``: the same
flags and the same files written, without JAX.

Usage:
    python -m laplace_inducing_points_tpu_torch.cli.import_data \
        --dataset mnist --src /path/to/downloaded/files [--root data] \
        [--strict]

mnist/fmnist expect the four canonical IDX ``.gz`` files; cifar10 expects
``cifar-10-python.tar.gz`` (or an extracted ``cifar-10-batches-py/``).
Files are structurally validated (IDX magics, counts, label ranges) and
checked against the published MD5s (``--strict`` turns checksum mismatch
into an error). See ``data/import_data.py``.
"""

from __future__ import annotations

import argparse

from laplace_inducing_points_tpu_torch.data.import_data import import_dataset


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True, choices=["mnist", "fmnist", "cifar10"])
    p.add_argument("--src", required=True, help="directory holding the user-supplied files")
    p.add_argument("--root", default="data", help="dataset root the training CLIs read from")
    p.add_argument("--strict", action="store_true",
                   help="fail (not warn) on checksum mismatch")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import_dataset(args.dataset, args.src, args.root, strict=args.strict)


if __name__ == "__main__":
    main()
