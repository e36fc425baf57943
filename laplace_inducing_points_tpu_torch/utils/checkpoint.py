"""Checkpoints: inducing points and run metadata in the JAX package's
formats, the MAP train state as a flat vector with its optimizer state.

``save_array``/``load_array``/``save_run_meta``/``load_run_meta`` read and
write the same npz/json files as
``laplace_inducing_points_tpu/utils/checkpoint.py:130-172``, so an inducing
set written by the JAX package loads as it is. MAP weights are the flat
vector plus its ``FlatSpec`` and the BatchNorm statistics, written with
``torch.save``; a Flax tree is converted with ``core.params.params_from_jax``
and ``batch_stats_from_jax``. :func:`save_train_state` adds Adam's moments
and step count to the same file (the counterpart of the reference's
``save_train_state``/``load_train_state``, ``:32-127``), which
:func:`load_train_state` restores for a resumed MAP run and :func:`load_state`
ignores. A file without them (written by :func:`save_params`) restores the
weights and statistics only.
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


def _write(ckpt_dir: str, name: str, flat: torch.Tensor, spec: FlatSpec,
           logvar: Optional[float], batch_stats: Optional[dict[str, torch.Tensor]],
           **extra) -> str:
    path = os.path.abspath(ckpt_dir)
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"{name}.pt")
    stats = {key: t.detach().cpu() for key, t in (batch_stats or {}).items()}
    torch.save({"flat": flat.detach().cpu(), "spec": spec.to_dict(),
                "logvar": logvar, "batch_stats": stats, **extra}, fn)
    return fn


def save_params(flat: torch.Tensor, spec: FlatSpec, ckpt_dir: str, name: str,
                logvar: Optional[float] = None,
                batch_stats: Optional[dict[str, torch.Tensor]] = None) -> str:
    """Write MAP weights as ``{name}.pt``: the flat vector, its spec, the
    BatchNorm statistics (``ModelState.batch_stats``) and, for a regressor,
    the learned ``logvar``."""
    fn = _write(ckpt_dir, name, flat, spec, logvar, batch_stats)
    print(f"[checkpoint] saved params '{name}' -> {fn}")
    return fn


def save_train_state(state, ckpt_dir: str, name: str) -> str:
    """Write the MAP train state of ``state`` (a ``ModelState``) as
    ``{name}.pt``: what :func:`save_params` writes plus ``state.opt_state``,
    Adam's moments of each leaf and its step count (``None`` for a state
    without one)."""
    logvar = float(state.logvar) if state.model_kind == "regressor" else None
    opt = state.opt_state
    blob = None if opt is None else {
        "count": opt.count, "mu": [t.detach().cpu() for t in opt.mu],
        "nu": [t.detach().cpu() for t in opt.nu]}
    fn = _write(ckpt_dir, name, state.flat_params, state.spec, logvar, state.batch_stats,
                opt_state=blob, step=state.step)
    print(f"[checkpoint] saved train state at step {state.step} -> {fn}")
    return fn


def load_params(ckpt_dir: str, name: str) -> tuple[torch.Tensor, FlatSpec, Optional[float]]:
    """Read ``{name}.pt``: ``(flat, spec, logvar)``, on the CPU."""
    fn = os.path.join(os.path.abspath(ckpt_dir), f"{name}.pt")
    if not os.path.exists(fn):
        raise FileNotFoundError(fn)
    blob = torch.load(fn, map_location="cpu", weights_only=True)
    print(f"[checkpoint] loaded params '{name}' from {fn}")
    return blob["flat"], FlatSpec.from_dict(blob["spec"]), blob["logvar"]


def load_state(ckpt_dir: str, name: str, model: torch.nn.Module, model_kind: str,
               device: torch.device):
    """The ``ModelState`` of ``{name}.pt`` around ``model`` (on ``device``):
    its weights, statistics and, for a regressor, its ``logvar`` written into
    the model. A file of another layout raises."""
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    flat, spec, logvar = load_params(ckpt_dir, name)
    if logvar is not None:
        with torch.no_grad():
            model.logvar.fill_(logvar)
    stats = load_batch_stats(ckpt_dir, name)
    state = ModelState(model, flat.to(device), model_kind=model_kind,
                       batch_stats={key: t.to(device) for key, t in stats.items()})
    if spec != state.spec:
        raise ValueError(f"MAP file layout {spec.names} does not match the "
                         f"model's {state.spec.names}")
    return state


def load_train_state(ckpt_dir: str, name: str, model: torch.nn.Module, model_kind: str,
                     device: torch.device):
    """:func:`load_state` with the optimizer state of ``{name}.pt`` as the
    state's ``opt_state`` (on ``device``), from which ``train_map`` continues.
    A file without one (:func:`save_params`') restores the weights and
    statistics only, prints the reference's note, and the state's step is 0.
    A missing file raises ``FileNotFoundError``."""
    from laplace_inducing_points_tpu_torch.models.state import AdamState
    state = load_state(ckpt_dir, name, model, model_kind, device)
    fn = os.path.join(os.path.abspath(ckpt_dir), f"{name}.pt")
    blob = torch.load(fn, map_location="cpu", weights_only=True).get("opt_state")
    if blob is None:
        # the reference's note for a checkpoint whose optimizer state it
        # cannot restore; such a file holds no step either, so it is 0
        print("[checkpoint] optimizer-state tree mismatch — restored "
              "params/batch_stats/step only")
    else:
        state.opt_state = AdamState(int(blob["count"]),
                                    tuple(t.to(device) for t in blob["mu"]),
                                    tuple(t.to(device) for t in blob["nu"]))
    print(f"[checkpoint] restored train state from {fn} step {state.step}")
    return state


def load_batch_stats(ckpt_dir: str, name: str) -> dict[str, torch.Tensor]:
    """The BatchNorm statistics of ``{name}.pt``, on the CPU; empty for a
    model without BatchNorm and for a file written before they were stored."""
    fn = os.path.join(os.path.abspath(ckpt_dir), f"{name}.pt")
    if not os.path.exists(fn):
        raise FileNotFoundError(fn)
    return dict(torch.load(fn, map_location="cpu", weights_only=True).get("batch_stats", {}))
