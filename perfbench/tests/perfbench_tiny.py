"""Each cell cut to a size the CPU runs in seconds, for the benchmark's CPU
tests (the card runs the cells at their own)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LENET5_IP = {"m": 4, "lr": 0.008, "batch_size": 8, "objective": "gram", "example_block": None}
TINY = {
    "lenet5_mnist.ztrain_gram": {"full_set_size": 64, "ip": LENET5_IP},
    "lenet5_mnist.serve_weight": {
        "full_set_size": 64, "ip": LENET5_IP,
        "serve": {"batch_size": 8, "mc_samples": 4, "test_set_size": 32, "rank_tol": 1e-7,
                  "sample_block": None}},
}

