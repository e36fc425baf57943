#!/usr/bin/env python3
"""Device view of warm LeNet5 training steps of the PyTorch port on one CUDA GPU.

Run from the root of the repository:  python3 scripts/torch_profile_training.py

Two windows, each after two warm-up steps: 10 MAP steps (batch 256, Adam,
cosine schedule off) and 5 Z steps on the gram KL (M=100, batch 128,
full_set_size 60000, alpha 0.005, as ``configs/scale/lenet5_mnist.yml``),
from a seeded LeNet5 (numpy lecun-normal in the JAX layout) on the synthetic
MNIST-shaped surrogate. Each window runs once without and once under
``torch.profiler`` and prints: the card (``nvidia-smi`` name and power limit),
wall seconds per step with and without the profiler, device-busy seconds per
step (the union of the CUDA activity intervals), the busy share, and the
kernels with the most device time. Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import collections
import itertools
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ALPHA, FULL_SET, M = 0.005, 60000, 100


def _wall(step, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def _busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def window(label: str, step, n: int, top: int = 12) -> None:
    for _ in range(2):
        step()
    plain_s = _wall(step, n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_s = _wall(step, n)
    # device activity: kernels and copies, not the annotations of CPU ranges
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy_s = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6 / n
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    print(f"== {label}: {n} warm steps")
    print(f"wall {plain_s * 1e3:.3f} ms/step without the profiler, {prof_s * 1e3:.3f} "
          f"with it; device busy {busy_s * 1e3:.3f} ms/step = {busy_s / prof_s:.1%} of "
          f"the profiled wall time ({busy_s / plain_s:.1%} of the unprofiled)")
    for name, us in by_name.most_common(top):
        print(f"  {us / n / 1e3:9.3f} ms/step  {us / 1e6 / n / busy_s:6.1%}  {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script measures the GPU")
    from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                               params_from_jax)
    from laplace_inducing_points_tpu_torch.data.scale import get_dataloaders, load_arrays
    from laplace_inducing_points_tpu_torch.models.scale import LeNet5
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    from laplace_inducing_points_tpu_torch.training.inducing import (make_optimizer,
                                                                     optimize_step)
    from laplace_inducing_points_tpu_torch.training.map import map_step
    from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}  torch {torch.__version__}")
    print(set_f32_policy())
    model = LeNet5().cuda()
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(model), 123123123))
    state = ModelState(model, flat.cuda(), "classifier")
    with tempfile.TemporaryDirectory() as data:
        train, _, _ = get_dataloaders("mnist", 256, root=data)
        ip_loader, _, _ = get_dataloaders("mnist", 128, aug=False, root=data)
        x_train, _ = load_arrays("mnist", train=True, root=data)
    map_batches = itertools.cycle(list(itertools.islice(iter(train), 16)))
    z_batches = itertools.cycle([torch.as_tensor(x).cuda()
                                 for x, _ in itertools.islice(iter(ip_loader), 8)])

    w = state.flat_params.clone().requires_grad_()
    opt = torch.optim.Adam([w], lr=5e-4, eps=1e-8)
    window("MAP step (LeNet5, batch 256)",
           lambda: map_step(state, w, opt, next(map_batches), ALPHA), 10)

    Z = torch.as_tensor(x_train[:M]).cuda()
    z_opt = make_optimizer(Z, 0.008)
    window(f"Z step (gram KL, M={M}, batch 128)",
           lambda: optimize_step(Z, next(z_batches), state, ALPHA, z_opt,
                                 full_set_size=FULL_SET), 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
