"""Write the toy data and the golden banana MAP that the PyTorch port reads.

The toy generators are ``jax.random`` code, so the port reads their output
from committed files. This script writes them with the JAX package's own
``ensure_toy_npz`` (needs JAX):

* ``data/fixtures/toy/{banana,xor,spiral,sine}.npz`` at each
  ``configs/toy/*.yml``'s ``data:`` parameters;
* the OOD rings ``ring_r2.npz`` and ``ring_r1p05.npz`` (n=512, noise=0.05,
  seed=42, as ``tests/test_golden_banana.py`` makes them);
* ``tests/golden/banana_torch/map_banana.pt``: the golden banana MAP of
  ``tests/golden/banana/map`` (an orbax checkpoint) in the port's format.

Usage (from the repository root):
    JAX_PLATFORMS=cpu python scripts/write_toy_fixtures.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from laplace_inducing_points_tpu.data.toy import ensure_toy_npz, ring_cache_fname  # noqa: E402
from laplace_inducing_points_tpu.models.registry import get_model  # noqa: E402
from laplace_inducing_points_tpu.models.state import create_train_state  # noqa: E402
from laplace_inducing_points_tpu.utils.checkpoint import load_train_state  # noqa: E402
from laplace_inducing_points_tpu.utils.config import load_experiment_config  # noqa: E402
from laplace_inducing_points_tpu_torch.core.params import params_from_jax  # noqa: E402
from laplace_inducing_points_tpu_torch.utils.checkpoint import save_params  # noqa: E402

FIXTURES = os.path.join(ROOT, "data", "fixtures", "toy")
GOLDEN = os.path.join(ROOT, "tests", "golden", "banana")
GOLDEN_TORCH = os.path.join(ROOT, "tests", "golden", "banana_torch")
CONFIGS = {"banana": "classifier_banana.yml", "xor": "classifier_xor.yml",
           "spiral": "classifier_spiral.yml", "sine": "regressor_sine.yml"}
RING_RADII = (2.0, 1.05)


def write_data() -> None:
    for name, config in CONFIGS.items():
        data_cfg = dict(load_experiment_config(
            os.path.join(ROOT, "configs", "toy", config)).get("data") or {})
        path = ensure_toy_npz(name, data_dir=FIXTURES, n=data_cfg.pop("n", 512),
                              noise=data_cfg.pop("noise", 0.05),
                              seed=data_cfg.pop("seed", 42), **data_cfg)
        print(f"{name}: {path} x{np.load(path)['x'].shape}")
    for radius in RING_RADII:
        path = ensure_toy_npz("ring", data_dir=FIXTURES, radius=radius,
                              fname=ring_cache_fname(radius))
        print(f"ring r={radius}: {path}")


def write_golden_map() -> None:
    model = get_model({"name": "classifier", "type": "classifier", "num_h": 16,
                       "num_l": 3, "num_c": 2})
    state = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 2)),
                               optax.adam(1e-3), model_kind="classifier")
    state = load_train_state(state, os.path.join(GOLDEN, "map"))
    tree = jax.tree.map(np.asarray, jax.device_get(state.params))
    flat, spec = params_from_jax(tree)
    save_params(flat, spec, GOLDEN_TORCH, "map_banana")


if __name__ == "__main__":
    write_data()
    write_golden_map()
