#!/usr/bin/env python3
"""What the convolution policy's probe (``utils.device.check_conv_policy``)
adds to a fresh process on one CUDA GPU.

Run from the root of the repository:

    python3 scripts/torch_probe_cost.py [--out DIR]

Four fresh processes, in turns with the probe and with it stubbed out (with,
without, without, with), each apply the policy as an entry point does and
then build seeded LeNet5's rows of 4 surrogate images (the process's first
convolutions); each process's two times, synchronised, are printed and
written to ``OUT/probe_cost.json`` (``--out DIR``, default
``measurements/``), after the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

_PROCESS = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[2])
import chip_smoke as smoke
from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.utils import device
if sys.argv[1] == "without":
    device.check_conv_policy = lambda dev: 0.0
state, _, x, _ = smoke._conv_setup("LeNet5")
torch.cuda.synchronize()
t0 = time.perf_counter()
device.set_f32_policy(torch.device("cuda"))
torch.cuda.synchronize()
t1 = time.perf_counter()
with torch.no_grad():
    ops.dense_wt(state, x[:4])
torch.cuda.synchronize()
t2 = time.perf_counter()
print(json.dumps({"probe": sys.argv[1], "entry_point_s": t1 - t0, "first_rows_s": t2 - t1,
                  "total_s": t2 - t0}))
"""


def main() -> int:
    out = Path(sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
               else ROOT / "measurements")
    print(smoke.nvidia_smi_line(), flush=True)
    runs = []
    for mode in ("with", "without", "without", "with"):
        proc = subprocess.run([sys.executable, "-c", _PROCESS, mode, str(ROOT)],
                              capture_output=True, text=True, timeout=300, cwd=ROOT)
        if proc.returncode:
            print(proc.stderr[-3000:])
            raise RuntimeError(f"the process ({mode}) exited {proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"  {json.dumps(runs[-1])}", flush=True)
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe_cost.json").write_text(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
