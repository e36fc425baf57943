#!/usr/bin/env python3
"""Which cuDNN engine sets the float32 error of seeded ResNet1M's row
pullback under the convolution policy on one CUDA GPU.

Run from the root of the repository:

    python3 scripts/torch_conv_engines.py [--out DIR]

A process computes ``chip_smoke.py``'s STEP1 row pullback (ResNet1M, a
block of 2, float64 on its own ReLU masks as the reference) under the
policy's cuDNN settings with cuDNN frontend logging on, and lists the
engines its plans name (``ConvFwd_eng3``, ...). Then, for each engine the
errata file (``utils/cudnn_errata.json``) does not block yet, a process with
that engine blocked as well computes the same pullback: its error, and
whether cuDNN still found an engine. The same with cuDNN off is the
yardstick. Prints the card (``nvidia-smi`` name and power limit) and writes
every reading to ``OUT/conv_engines.json`` (``--out DIR``, default
``measurements/``).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ERRATA = ROOT / "laplace_inducing_points_tpu_torch" / "utils" / "cudnn_errata.json"
ROUTE = "row pullback, block of 2"

_CHILD = """
import os, sys, json
errata, log, enabled = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
os.environ["CUDNN_ERRATA_JSON_FILE"] = errata
if log:
    os.environ["CUDNN_FRONTEND_LOG_INFO"] = "1"
    os.environ["CUDNN_FRONTEND_LOG_FILE"] = log
import torch
sys.path.insert(0, sys.argv[4])
from laplace_inducing_points_tpu_torch.models import layers
from laplace_inducing_points_tpu_torch.utils import device


def flags(*args):
    torch.backends.cudnn.enabled = enabled
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False


for module in (layers, device):       # the policy's settings, this errata file
    module.set_conv_policy = flags
torch.backends.cuda.matmul.allow_tf32 = False
flags()
import chip_smoke as smoke
setup = smoke._conv_setup("ResNet1")
state, s64, _, _ = setup
[(name, _, fn)] = smoke._step1_routes("ResNet1", setup, [sys.argv[5]])
f32 = fn(state, lambda t: t).detach()
print(json.dumps({"err": smoke._rel(f32, smoke._reference(state, s64, fn))}))
"""


def run(rules: list, log: str = "", enabled: bool = True) -> dict:
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump({"version": 1, "rules": rules}, f)
    proc = subprocess.run([sys.executable, "-c", _CHILD, f.name, log, "1" if enabled else "0",
                           str(ROOT), ROUTE], capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    os.unlink(f.name)
    if proc.returncode:
        return {"failed": proc.stderr.strip().splitlines()[-1][:300]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    out = Path(sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
               else ROOT / "measurements")
    out.mkdir(parents=True, exist_ok=True)
    smi = smoke.nvidia_smi_line()
    print(smi, flush=True)
    rules = json.loads(ERRATA.read_text())["rules"]
    blocked = {(r["operation"], r["engine"]) for r in rules}
    log = out / "conv_engines_frontend.log"
    result = {"smi": smi, "route": ROUTE, "cudnn_off": run(rules, enabled=False),
              "policy": run(rules, str(log))}
    named = sorted({(m[0], int(m[1])) for m in re.findall(
        r"(ConvFwd|ConvBwdData|ConvBwdFilter)_eng(\d+)", log.read_text(errors="replace"))})
    print(f"cuDNN off: {result['cudnn_off']}; the policy: {result['policy']}; engines named "
          f"in its plans: {named}", flush=True)
    result["blocked_too"] = {}
    for op, eng in named:
        if (op, eng) in blocked:
            continue
        reading = run(rules + [{"rule_id": f"{op}_eng{eng}", "operation": op, "engine": eng}])
        result["blocked_too"][f"{op}_eng{eng}"] = reading
        print(f"  {op} engine {eng} blocked too: {reading}", flush=True)
    (out / "conv_engines.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
