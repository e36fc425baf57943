"""Validation-NLL grid search for the prior precision α.

Counterpart of ``laplace_inducing_points_tpu/training/grid_search.py:18-90``:
a coarse log₁₀ grid plus one refinement pass between the best point's
neighbours. The posterior factor of ``(state, Z0)`` does not depend on α, so
one :class:`ScalableLLAPredictor` serves every grid point (α is a per-call
argument). Every grid point sees the same noise: a ``torch.Generator`` seeded
from ``rng_key`` anew for each α, as the reference reuses one key.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from laplace_inducing_points_tpu_torch.evaluation.harness import eval_dataset
from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor


def grid_search_alpha(state, Z0: torch.Tensor, val_loader: Iterable, *,
                      full_set_size: Optional[int],
                      num_mc_samples: int = 30,
                      log10_min: float = -3.0, log10_max: float = 2.0,
                      n_coarse: int = 7, rng_key: int = 0, verbose: bool = True,
                      range_clip_min: Optional[float] = None,
                      predictive: str = "weight",
                      example_block: Optional[int] = None,
                      sample_block: Optional[int] = None,
                      history: Optional[list] = None, **predictor_kwargs) -> float:
    """Return the α minimizing the validation NLL of the IP-LLA predictive
    over ``n_coarse`` log-spaced points and three more between the best one's
    neighbours.

    ``predictive``: ``"weight"`` or ``"matfree"`` (its knobs, ``cg_tol`` and
    the rest, in ``predictor_kwargs``; the Nyström sketch is α-independent
    and built once). ``example_block`` chunks the predictor's row build and
    ``sample_block`` its push-forward; both keep the values. ``history``, if
    given, receives every ``(alpha, nll)`` in the order evaluated.
    """
    with torch.no_grad():
        predictor = ScalableLLAPredictor(state, Z0, full_set_size=full_set_size,
                                         example_block=example_block,
                                         range_clip_min=range_clip_min,
                                         sample_block=sample_block, method=predictive,
                                         **predictor_kwargs)

    def val_nll(a: float) -> float:
        generator = torch.Generator(device=state.device).manual_seed(rng_key)
        with torch.no_grad():
            nll, _ = eval_dataset(state, val_loader, Z0, alpha=float(a),
                                  full_set_size=full_set_size,
                                  num_mc_samples=num_mc_samples, generator=generator,
                                  predictor=predictor)
        if history is not None:
            history.append((float(a), float(nll)))
        return float(nll)

    alphas = np.logspace(log10_min, log10_max, n_coarse)
    nlls = []
    for a in alphas:
        nlls.append(val_nll(a))
        if verbose:
            print(f"alpha={a:9.3e}  NLL={nlls[-1]:.4f}")
    best = int(np.argmin(nlls))

    lo = alphas[max(best - 1, 0)]
    hi = alphas[min(best + 1, len(alphas) - 1)]
    llo, lhi = np.log10(lo), np.log10(hi)
    refine_alphas = 10.0 ** np.array([(3 * llo + lhi) / 4, (llo + lhi) / 2, (llo + 3 * lhi) / 4])
    refine_nlls = [val_nll(a) for a in refine_alphas]
    if verbose:
        for a, v in zip(refine_alphas, refine_nlls):
            print(f"alpha={a:9.3e}  NLL={v:.4f} (refine)")
    alphas = np.concatenate([alphas, refine_alphas])
    nlls = nlls + refine_nlls
    best = int(np.argmin(nlls))

    alpha_best = float(alphas[best])
    if verbose:
        print(f">>> selected alpha* = {alpha_best:9.3e} (val NLL = {nlls[best]:.4f})")
    return alpha_best
