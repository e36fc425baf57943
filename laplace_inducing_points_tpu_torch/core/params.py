"""The flat curvature-parameter vector and the weight converter.

Counterpart of ``laplace_inducing_points_tpu/core/params.py:19-48``. The JAX
package ravels the network-weight pytree with ``ravel_pytree``: dict keys
sorted as strings at every level, the ``logvar`` and ``batch_stats``
collections left out, so within a layer ``bias`` comes before ``kernel``.
Posterior draws ``w (S, D)``, the rows ``R (d, D)`` and every jvp tangent
live in that vector. The port keeps the same order and the same leaf layouts
(HWIO conv kernels, ``(in, out)`` dense kernels), so the two packages'
vectors agree entry by entry. ``FlatSpec`` records the order; the torch
models keep their parameters in these layouts and permute at call time.
BatchNorm statistics (Flax's ``batch_stats`` collection) stay outside the
vector: ``batch_stats_from_jax``/``batch_stats_to_jax`` convert them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

# Collections that never enter the curvature / posterior.
EXCLUDED_COLLECTIONS = ("logvar", "batch_stats")


@dataclass(frozen=True)
class FlatSpec:
    """Leaf paths and shapes of the flat vector, in ``ravel_pytree`` order."""
    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]

    @property
    def names(self) -> tuple[str, ...]:
        """Parameter names as ``nn.Module.named_parameters`` gives them."""
        return tuple(".".join(p) for p in self.paths)

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(int(np.prod(s, dtype=np.int64)) for s in self.shapes)

    @property
    def num_params(self) -> int:
        """Dimension D of the flat vector."""
        return sum(self.sizes)

    def unflatten(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Views into ``flat`` by parameter name (differentiable, no copy)."""
        if flat.shape != (self.num_params,):
            raise ValueError(f"flat vector has shape {tuple(flat.shape)}, "
                             f"spec needs ({self.num_params},)")
        out, offset = {}, 0
        for name, shape, size in zip(self.names, self.shapes, self.sizes):
            out[name] = flat[offset:offset + size].view(shape)
            offset += size
        return out

    def to_dict(self) -> dict:
        """Plain lists, so ``torch.load(weights_only=True)`` reads them."""
        return {"paths": [list(p) for p in self.paths],
                "shapes": [list(s) for s in self.shapes]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FlatSpec":
        return cls(paths=tuple(tuple(p) for p in d["paths"]),
                   shapes=tuple(tuple(int(n) for n in s) for s in d["shapes"]))

    @classmethod
    def from_module(cls, module: nn.Module) -> "FlatSpec":
        """The spec of a port model's network weights (excluded collections
        left out), in ``ravel_pytree`` order."""
        leaves = sorted(
            (tuple(name.split(".")), tuple(p.shape))
            for name, p in module.named_parameters()
            if name.split(".")[0] not in EXCLUDED_COLLECTIONS)
        return cls(paths=tuple(p for p, _ in leaves),
                   shapes=tuple(s for _, s in leaves))


def split_nn_params(params: Mapping[str, Any]) -> tuple[dict, dict]:
    """Split a top-level param dict into (curvature params, excluded aux)."""
    nn_params = {k: v for k, v in params.items() if k not in EXCLUDED_COLLECTIONS}
    aux = {k: v for k, v in params.items() if k in EXCLUDED_COLLECTIONS}
    return nn_params, aux


def _sorted_leaves(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _sorted_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def params_from_jax(tree: Mapping[str, Any]) -> tuple[torch.Tensor, FlatSpec]:
    """Convert a Flax ``params`` tree (numpy leaves) to ``(flat, spec)``.

    ``flat`` is the f32 vector of ``flatten_nn_params``, entry for entry.
    """
    nn_params, _ = split_nn_params(tree)
    leaves = list(_sorted_leaves(nn_params))
    arrays = [np.asarray(leaf, dtype=np.float32) for _, leaf in leaves]
    spec = FlatSpec(paths=tuple(p for p, _ in leaves),
                    shapes=tuple(a.shape for a in arrays))
    flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays]))
    return flat, spec


def params_to_jax(flat: torch.Tensor, spec: FlatSpec) -> dict:
    """Inverse of :func:`params_from_jax`: the nested tree of numpy leaves."""
    return _nested((path, view.numpy().copy()) for path, view in
                   zip(spec.paths, spec.unflatten(flat.detach().cpu()).values()))


def _nested(items) -> dict:
    """The nested tree of ``(path, leaf)`` pairs."""
    tree: dict = {}
    for path, leaf in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def batch_stats_from_jax(tree: Mapping[str, Any], device=None) -> dict[str, torch.Tensor]:
    """A Flax ``batch_stats`` tree (numpy leaves, ``{"BatchNorm_0": {"mean",
    "var"}, ...}``) as the port's statistics: f32 tensors keyed like the
    module's buffers (``"BasicBlock_0.BatchNorm_1.mean"``)."""
    return {".".join(path): torch.tensor(np.asarray(leaf, dtype=np.float32), device=device)
            for path, leaf in _sorted_leaves(tree)}


def batch_stats_to_jax(stats: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`batch_stats_from_jax`: the nested tree of numpy leaves."""
    return _nested((tuple(name.split(".")), t.detach().cpu().numpy().copy())
                   for name, t in sorted(stats.items()))


def lecun_normal_params(spec: FlatSpec, seed: int) -> dict:
    """A seeded numpy init in the JAX layout: kernels ~ N(0, 1/fan_in) with
    ``fan_in`` the product of all but the last axis (HWIO and ``(in, out)``
    alike), BatchNorm ``scale`` one, biases zero."""
    rng = np.random.default_rng(seed)
    leaves = []
    for path, shape in zip(spec.paths, spec.shapes):
        if path[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            leaf = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        elif path[-1] == "scale":
            leaf = np.ones(shape, dtype=np.float32)
        else:
            leaf = np.zeros(shape, dtype=np.float32)
        leaves.append((path, leaf))
    return _nested(leaves)


def logvar_from_jax(tree: Mapping[str, Any]) -> Optional[float]:
    """A regressor's learned ``logvar`` from a Flax ``params`` tree (the
    excluded leaf :func:`params_from_jax` leaves out), or ``None``."""
    return float(np.asarray(tree["logvar"])) if "logvar" in tree else None
