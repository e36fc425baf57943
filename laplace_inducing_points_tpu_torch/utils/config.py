"""YAML experiment configs with schema defaults.

Counterpart of ``laplace_inducing_points_tpu/utils/config.py``: the same
defaults, applied once, so that both packages read ``configs/**.yml`` the same
way. (The JAX package cannot be imported for them: importing it imports
``jax``.)
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import yaml

IP_DEFAULTS = {
    "m": 50,
    "batch_size": 128,
    "epochs": 200,
    "lr": 0.01,
    "mc_samples": 100,
    "seed": 0,
    "st_samples": 256,
    "slq_samples": 2,
    "slq_num_matvecs": None,
    "objective": "gram",
    "example_block": None,      # chunk the example axis of row builds
    "restarts": 1,
    "alpha_train": None,
    "cg_tol": 1e-3,
    "cg_maxiter": None,
    "precond_rank": 64,
    "precond_power": 0,
    "cg_example_block": None,
}

MAP_DEFAULTS = {
    "batch_size": 32,
    "epochs": 100,
    "lr": 1e-3,
    "seed": 0,
    "schedule": "constant",
}

SAMPLING_DEFAULTS = {
    "mc_samples": 100,
    "method": "gram_eigh",
    "invsqrt_num_matvecs": None,
    "predictive": "weight",
    "sample_block": None,       # chunk the MC-sample axis of the push-forward
    "jac_block": None,
    "cg_tol": 1e-4,
    "cg_maxiter": None,
    "precond_rank": 64,
    "precond_power": 0,
    "cg_example_block": None,
}


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def load_experiment_config(path: str) -> Dict[str, Any]:
    """Load and normalize an experiment config."""
    cfg = load_yaml(path)
    opt = cfg.setdefault("optimization", {})
    for section, defaults in (("map", MAP_DEFAULTS), ("ip", IP_DEFAULTS)):
        merged = copy.deepcopy(defaults)
        merged.update(opt.get(section, {}))
        opt[section] = merged
    sampling = copy.deepcopy(SAMPLING_DEFAULTS)
    sampling.update(cfg.get("sampling", {}))
    cfg["sampling"] = sampling
    opt.setdefault("alpha", 1.0)
    opt.setdefault("full_set_size", None)
    return cfg
