"""Run one cell of the benchmark of ``laplace_inducing_points_tpu_torch``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA device. Prints the
card on an earlier line and one JSON result as the last line of standard
output; exits non-zero, with no result, without enough CUDA devices.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / ".cache"
# every compiler cache at a fixed place inside the checkout, so that only a
# cell's first run in a checkout builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# one host thread for the CPU's own math: the cells are paced by the host's
# launches, which the pool's spinning threads would compete with
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
