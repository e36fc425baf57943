"""Float64 references of float32 networks across their ReLU kinks.

At a ReLU's kink a network's Jacobian jumps. An input within float32
round-off of 0 can be positive in one precision and not in the other; the
float32 Jacobian then differs from the float64 one by ~1e-4 or more whatever
the arithmetic (one such input of ResNet1M's ~3 x 10^5 an image is enough).
Replaying the masks of the float32 forward in the float64 one
(:func:`replayed_relu_masks`, :func:`replay_relu_masks`) makes both compute
the same piecewise-linear function, so what remains between them is
arithmetic. The models call ``F.relu`` (``models/scale.py``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.func import functional_call


@contextlib.contextmanager
def _relu(fn):
    relu = F.relu
    F.relu = fn
    try:
        yield relu
    finally:
        F.relu = relu


@contextlib.contextmanager
def recorded_relu_masks(record: dict):
    """Within the block each ``F.relu`` call appends its input's mask
    (``input > 0``) to ``record[name of the calling thread]``, in call order
    (a data-parallel MAP step runs its shards in threads named ``shard
    <rank>``)."""
    def recording(t, *args, **kwargs):
        record.setdefault(threading.current_thread().name, []).append(t.detach() > 0)
        return relu(t, *args, **kwargs)

    with _relu(recording) as relu:
        yield


@contextlib.contextmanager
def replayed_relu_masks(masks: list):
    """Within the block the i-th ``F.relu`` call computes ``t · masks[i]``
    (moved to ``t``'s device and dtype); the block must make exactly
    ``len(masks)`` such calls."""
    replay = iter(masks)
    with _relu(lambda t, *args, **kwargs: t * next(replay).to(t.device, t.dtype)):
        yield
    if next(replay, None) is not None:
        raise RuntimeError("fewer F.relu calls than masks to replay")


@contextlib.contextmanager
def replay_relu_masks(state32, state64):
    """Within the block every forward of ``state64.model`` (a float64 copy of
    ``state32``'s weights) replays the ReLU masks of ``state32``'s forward on
    the same inputs: that float32 forward runs first (no gradient, at
    ``state32``'s own weights, inputs cast to float32 and moved to its device,
    BatchNorm on copies of its statistics, the same ``train`` flag); the
    float64 forward then runs on its masks. It runs inside whatever
    transforms call the model (``vmap``, ``jacrev``, ``jvp``, autograd), at
    the shapes they give it, so the masks are those of the float32
    computation at the same shapes."""
    model = state64.model
    device = state32.flat_params.device
    weights = state32.spec.unflatten(state32.flat_params)

    def forward(x, *args, **kwargs):
        record = {}
        with recorded_relu_masks(record), torch.no_grad():
            functional_call(state32.model, {**weights, **{k: v.clone() for k, v in
                                                          state32.batch_stats.items()}},
                            (x.detach().to(device, torch.float32), *args), kwargs)
        with replayed_relu_masks(record.get(threading.current_thread().name, [])):
            return type(model).forward(model, x, *args, **kwargs)

    model.forward = forward
    try:
        yield
    finally:
        del model.forward
