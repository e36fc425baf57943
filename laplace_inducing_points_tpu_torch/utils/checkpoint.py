"""Checkpoints: inducing points and run metadata in the JAX package's
formats, MAP weights as a flat vector.

``save_array``/``load_array``/``save_run_meta``/``load_run_meta`` read and
write the same npz/json files as
``laplace_inducing_points_tpu/utils/checkpoint.py:130-172``, so an inducing
set written by the JAX package loads as it is. MAP weights are the flat
vector plus its ``FlatSpec``, written with ``torch.save``; a Flax tree is
converted with ``core.params.params_from_jax``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from laplace_inducing_points_tpu_torch.core.params import FlatSpec


def save_array(array, ckpt_dir: str, name: str, step: int) -> str:
    """Save an array checkpoint (inducing points) as ``{name}_{step}.npz``."""
    path = os.path.abspath(ckpt_dir)
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"{name}_{step}.npz")
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    np.savez(fn, array=np.asarray(array))
    print(f"[checkpoint] saved array '{name}' step {step} -> {fn}")
    return fn


def load_array(ckpt_dir: str, name: str, step: int) -> np.ndarray:
    fn = os.path.join(os.path.abspath(ckpt_dir), f"{name}_{step}.npz")
    if not os.path.exists(fn):
        raise FileNotFoundError(fn)
    arr = np.load(fn)["array"]
    print(f"[checkpoint] loaded array '{name}' from {fn}")
    return arr


def save_run_meta(ckpt_dir: str, name: str, meta: dict) -> str:
    """Write small run metadata (the alpha a Z was trained for) as
    ``{name}_meta.json`` beside the array checkpoints."""
    path = os.path.abspath(ckpt_dir)
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"{name}_meta.json")
    with open(fn, "w") as f:
        json.dump(meta, f)
    print(f"[checkpoint] saved run meta -> {fn}: {meta}")
    return fn


def load_run_meta(ckpt_dir: str, name: str) -> Optional[dict]:
    fn = os.path.join(os.path.abspath(ckpt_dir), f"{name}_meta.json")
    if not os.path.exists(fn):
        return None
    with open(fn) as f:
        return json.load(f)


def save_params(flat: torch.Tensor, spec: FlatSpec, ckpt_dir: str, name: str,
                logvar: Optional[float] = None) -> str:
    """Write MAP weights as ``{name}.pt``: the flat vector, its spec and, for
    a regressor, the learned ``logvar``."""
    path = os.path.abspath(ckpt_dir)
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"{name}.pt")
    torch.save({"flat": flat.detach().cpu(), "spec": spec.to_dict(),
                "logvar": logvar}, fn)
    print(f"[checkpoint] saved params '{name}' -> {fn}")
    return fn


def load_params(ckpt_dir: str, name: str) -> tuple[torch.Tensor, FlatSpec, Optional[float]]:
    """Read ``{name}.pt``: ``(flat, spec, logvar)``, on the CPU."""
    fn = os.path.join(os.path.abspath(ckpt_dir), f"{name}.pt")
    if not os.path.exists(fn):
        raise FileNotFoundError(fn)
    blob = torch.load(fn, map_location="cpu", weights_only=True)
    print(f"[checkpoint] loaded params '{name}' from {fn}")
    return blob["flat"], FlatSpec.from_dict(blob["spec"]), blob["logvar"]
