#!/usr/bin/env python3
"""What BatchNorm's normaliser (``models.layers.inv_std``) costs seeded
ResNet1M's float32 routes on one CUDA GPU: ``torch.rsqrt`` against
``1 / torch.sqrt``.

Run from the root of the repository:

    python3 scripts/torch_batchnorm_rsqrt.py [--out DIR]

On ``chip_smoke.py``'s phase-32 inputs (seeded ResNet1M, the first surrogate
images) the STEP1 routes (rows and pullback in blocks of 1 and 10, the MAP
gradient at batch 16, 25 draws pushed forward on 10 images, the cov
Jacobians) are held against float64 on their own ReLU masks, with cuDNN off
and under the convolution policy, twice: with ``inv_std`` as
``torch.rsqrt(var + eps)`` (on CUDA the approximate ``rsqrtf``), and as the
port computes it, ``1 / torch.sqrt(var + eps)`` (both operations correctly
rounded). The same on the CPU for the rows in a block of 1 and the
push-forward. Prints the card (``nvidia-smi`` name and power limit) and
writes the distances to ``OUT/batchnorm_rsqrt.json`` (``--out DIR``,
default ``measurements/``).
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

ROUTES = ["rows, block of 1", "row pullback, block of 1", "rows, block of 10",
          "row pullback, block of 10", "MAP gradient, batch 16",
          "serving push-forward, 25 draws on 10 images",
          "cov Jacobians, 10 images, jac_block 32"]
CPU_ROUTES = ROUTES[:1] + ROUTES[5:6]


@contextlib.contextmanager
def rsqrt_as(way: str):
    from laplace_inducing_points_tpu_torch.models import layers
    inv_std = layers.inv_std
    if way == "rsqrt":
        layers.inv_std = lambda var, epsilon: torch.rsqrt(var + epsilon)
    try:
        yield
    finally:
        layers.inv_std = inv_std


def errors(setup, names, settings) -> dict:
    state, s64, _, _ = setup
    out = {}
    for name, _, fn in smoke._step1_routes("ResNet1", setup, names):
        for way in ("rsqrt", "1/sqrt"):
            for label, flags in settings:
                with smoke._grad_mode(name), flags(), rsqrt_as(way):
                    err = smoke._rel(fn(state, lambda t: t).detach(),
                                     smoke._reference(state, s64, fn))
                out[f"{name} | {way} | {label}"] = err
                print(f"  {name}: BatchNorm with {way}, {label}: {err:.3e}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy
    smi = smoke.nvidia_smi_line()
    print(smi, set_f32_policy(torch.device("cuda")), flush=True)
    out = Path(sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
               else ROOT / "measurements")
    result = {"smi": smi}
    result["card"] = errors(smoke._conv_setup("ResNet1"), ROUTES,
                            (("cuDNN off", smoke._cudnn_off),
                             ("the policy", contextlib.nullcontext)))
    result["cpu"] = errors(smoke._conv_setup("ResNet1", device="cpu"), CPU_ROUTES,
                           (("CPU", contextlib.nullcontext),))
    out.mkdir(parents=True, exist_ok=True)
    (out / "batchnorm_rsqrt.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
