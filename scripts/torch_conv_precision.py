#!/usr/bin/env python3
"""The float32 error of the network's autodiff against float64 by batch size,
with cuDNN on and off, on one CUDA GPU; and what turning cuDNN off costs.

Run from the root of the repository:

    python3 scripts/torch_conv_precision.py

cuDNN chooses its convolution algorithm by shape; at some batch sizes it
takes a Winograd or FFT transform whose float32 error is far above
round-off. Measured, each against the same computation in float64, with
cuDNN on (the default) and off (PyTorch's own convolutions):

* the rows ``R = Lᵀ J`` (``core.operators.dense_wt``) built in example
  blocks of several sizes: LeNet5 (seeded, then one MAP epoch on the MNIST
  surrogate; 100 points) and ResNet1M (seeded; 8 CIFAR-10 surrogate points);
* the weight predictor's push-forward ``vmap(jvp)`` of S = 200 posterior
  draws on a batch of 256 (LeNet5, M = 100, alpha 0.005), all at once and in
  two halves (as a mesh of two devices runs it), the logits against the same
  draws pushed forward in float64;
* warm host seconds (synchronised, median of 5) of a MAP step (LeNet5 at
  batch 256, ResNet1M at batch 128) and of the push-forward.

For each: the relative Frobenius error, the seconds, and the cuDNN kernels
whose names say Winograd or FFT. Prints the card (``nvidia-smi`` name and
power limit) and one JSON line.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _state64(state):
    return SimpleNamespace(model=copy.deepcopy(state.model).double(),
                           flat_params=state.flat_params.double(), spec=state.spec,
                           batch_stats={k: v.double() for k, v in state.batch_stats.items()},
                           model_kind=state.model_kind, logvar=state.logvar, device=state.device)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a.double() - b).ravel()) / torch.linalg.norm(b.ravel()))


def _transforms(fn) -> list[str]:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    return sorted(n.split("(")[0].replace("void ", "")[:60] for n in names
                  if "winograd" in n.lower() or "fft" in n.lower())


def study(label: str, state, Z: torch.Tensor, blocks) -> list[dict]:
    from laplace_inducing_points_tpu_torch.core import operators as ops
    with torch.no_grad():
        R64 = ops.dense_wt(_state64(state), Z.double(), example_block=2)
    rows = []
    for cudnn in (True, False):
        for block in blocks:
            with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False, deterministic=False,
                                            allow_tf32=False), torch.no_grad():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                R = ops.dense_wt(state, Z, example_block=block)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                kernels = _transforms(lambda: ops.dense_wt(state, Z, example_block=block))
            row = {"model": label, "cudnn": cudnn, "block": block, "rel_vs_f64": _rel(R, R64),
                   "seconds": seconds, "transforms": kernels}
            rows.append(row)
            print(f"{label} cuDNN {'on ' if cudnn else 'off'} block {block}: rows vs float64 "
                  f"{row['rel_vs_f64']:.3e} ({seconds:.3f} s){'; ' if kernels else ''}"
                  f"{', '.join(kernels)}", flush=True)
            del R
    return rows


def _flags(cudnn: bool):
    return torch.backends.cudnn.flags(enabled=cudnn, benchmark=False, deterministic=False,
                                      allow_tf32=False)


def _warm_s(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def push_forward_study(state, Z: torch.Tensor, x: torch.Tensor) -> list[dict]:
    """Logits of 200 weight-path draws pushed forward at once and in halves,
    cuDNN on and off, against the float64 push-forward of the same draws."""
    from torch.func import vmap

    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
    from laplace_inducing_points_tpu_torch.inference.sample import _g_weights
    alpha = 0.005
    with torch.no_grad():
        pred = ScalableLLAPredictor(state, Z, full_set_size=60000)
        eps = torch.randn(200, pred.R.shape[1], device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
        g = _g_weights(pred.lam, alpha, pred.beta, pred.rank_tol, None).double()
        R, V, e = pred.R.double(), pred.V.double(), eps.double()
        w64 = e / math.sqrt(alpha) + ((((e @ R.T) @ V) * g) @ V.T) @ R
        lin64 = ops.linearize_model(_state64(state), x.double())
        ref = lin64.f0[None] + vmap(lin64.jvp)(w64)
        w = w64.float()
        lin = ops.linearize_model(state, x)
    rows = []
    for cudnn in (True, False):
        for halves in (1, 2):
            def push():
                with torch.no_grad():
                    return torch.cat([vmap(lin.jvp)(part) for part in w.tensor_split(halves)])
            with _flags(cudnn):
                out = lin.f0[None] + push()
                seconds = _warm_s(push)
                kernels = _transforms(push)
            row = {"model": "LeNet5 push-forward", "cudnn": cudnn, "halves": halves,
                   "rel_vs_f64": _rel(out, ref), "seconds": seconds, "transforms": kernels}
            rows.append(row)
            print(f"LeNet5 push-forward of 200 draws on 256 images in {halves} part(s), cuDNN "
                  f"{'on ' if cudnn else 'off'}: logits vs float64 {row['rel_vs_f64']:.3e}, "
                  f"warm {seconds:.4f} s{'; ' if kernels else ''}{', '.join(kernels)}",
                  flush=True)
    return rows


def map_step_costs(states_batches) -> list[dict]:
    """Warm seconds of one MAP step (loss, backward, Adam), cuDNN on and off."""
    from laplace_inducing_points_tpu_torch.training.map import map_step, working_state
    rows = []
    for label, state, batch in states_batches:
        for cudnn in (True, False):
            work = working_state(state, state.flat_params.clone())
            flat = state.flat_params.clone().requires_grad_()
            opt = torch.optim.Adam([flat], lr=1e-4, eps=1e-8)
            with _flags(cudnn):
                seconds = _warm_s(lambda: map_step(work, flat, opt, batch, 0.005))
            rows.append({"model": f"{label} MAP step", "cudnn": cudnn, "seconds": seconds})
            print(f"{label} MAP step, cuDNN {'on ' if cudnn else 'off'}: warm {seconds:.4f} s",
                  flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                               params_from_jax)
    from laplace_inducing_points_tpu_torch.data.scale import get_dataloaders, load_arrays
    from laplace_inducing_points_tpu_torch.models.scale import LeNet5, ResNet1M
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.training.map import cosine_lr, train_map
    from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}; "
          f"{set_f32_policy()}")
    data = tempfile.mkdtemp(prefix="lipt_no_data_")     # empty: the synthetic surrogates
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(LeNet5()), 0))
    lenet = ModelState(LeNet5().cuda(), flat.cuda(), "classifier")
    train, test, _ = get_dataloaders("mnist", 256, root=data)
    lenet = train_map(lenet, train, [next(iter(test))], num_epochs=1, alpha=0.005,
                      lr=cosine_lr(5e-4, 1, len(train)))
    x, _ = load_arrays("mnist", True, root=data)
    rows = study("LeNet5", lenet, torch.as_tensor(x[:100]).cuda(), (None, 20, 8, 4, 2, 1))
    rows += push_forward_study(lenet, torch.as_tensor(x[:100]).cuda(),
                               torch.as_tensor(x[100:356]).cuda())
    model = ResNet1M(10).cuda()
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(model), 0))
    resnet = ModelState(model, flat.cuda(), "classifier")
    xc, yc = load_arrays("cifar10", True, root=data)
    rows += study("ResNet1M", resnet, torch.as_tensor(xc[:8]).cuda(), (None, 4, 2, 1))
    rows += map_step_costs([("LeNet5", lenet, next(iter(train))),
                            ("ResNet1M", resnet, (xc[:128], yc[:128]))])
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
