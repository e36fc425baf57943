"""Evaluation CLI: NLL / ACC / Brier / ECE (+ OOD AUROC) with timing.

Counterpart of ``laplace_inducing_points_tpu/cli/evaluate.py`` for the
scalable predictives (``--scalable --predictive weight`` and ``matfree``):
loads MAP weights (``{ckpt_map}/map_{dataset}.pt``, see
``utils.checkpoint.save_params``) and the inducing points
(``{ckpt_induc}/ind_{dataset}_{epochs}.npz``), builds the posterior factor
(the matfree path: its Nyström sketch) once, and runs timed evaluation
repetitions and an optional OOD pass. The matfree knobs come from the flags,
else the config's ``sampling.cg_*``/``precond_*``. The ``cov`` predictive,
the dense predictive and the toy datasets are not ported yet (ROADMAP,
Queue A).

Usage:
    python -m laplace_inducing_points_tpu_torch.cli.evaluate \
        --dataset mnist --config configs/scale/lenet5_mnist.yml \
        --scalable --predictive weight --device cuda
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import torch

from laplace_inducing_points_tpu_torch.data.scale import DATASET_SHAPES, get_dataloaders
from laplace_inducing_points_tpu_torch.evaluation.harness import (auroc_ood,
                                                                  eval_dataset_extended)
from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
from laplace_inducing_points_tpu_torch.models.registry import get_model
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.utils.checkpoint import (load_array,
                                                                load_batch_stats,
                                                                load_params,
                                                                load_run_meta)
from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
from laplace_inducing_points_tpu_torch.utils.device import resolve_device, set_f32_policy

EVAL_SEED = 155858


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True, choices=sorted(DATASET_SHAPES))
    p.add_argument("--ood-dataset", default=None, choices=sorted(DATASET_SHAPES))
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt_map", default="checkpoint/map/")
    p.add_argument("--ckpt_induc", default="checkpoint/ind/")
    p.add_argument("--scalable", action="store_true")
    p.add_argument("--alpha_ip", type=float, default=None)
    p.add_argument("--range_clip", type=float, default=1.0,
                   help="clip range-space eigenvalues of (aI+bG) from below "
                        "inside the posterior inverse sqrt; 1.0 reproduces "
                        "the reference's monkeypatched sampler; <=0 disables")
    p.add_argument("--sample_block", type=int, default=None,
                   help="chunk the MC-sample axis of the push-forward "
                        "(bounds device memory); default: config "
                        "sampling.sample_block")
    p.add_argument("--predictive", choices=["weight", "cov", "matfree"],
                   default=None,
                   help="scalable predictive path: 'weight' pushes each draw of "
                        "the eigh factor through a jvp; 'matfree' draws Matheron "
                        "samples by Nystrom-preconditioned CG, no d_z x D factor "
                        "and no eigh (an exact sampler: --range_clip is ignored); "
                        "'cov' is not ported. Default: config sampling.predictive")
    p.add_argument("--cg_tol", type=float, default=None,
                   help="matfree predictive: CG tolerance (default config "
                        "sampling.cg_tol, 1e-4)")
    p.add_argument("--cg_maxiter", type=int, default=None,
                   help="matfree predictive: CG iteration cap (default "
                        "sampling.cg_maxiter, else 10*d_z)")
    p.add_argument("--precond_power", type=int, default=None,
                   help="matfree predictive: Nystrom sketch subspace-iteration "
                        "passes (default config sampling.precond_power, 0)")
    p.add_argument("--precond_rank", type=int, default=None,
                   help="matfree predictive: Nystrom deflation rank, 0 disables "
                        "(default config sampling.precond_rank, 64)")
    p.add_argument("--cg_example_block", type=int, default=None,
                   help="matfree predictive: run the CG operator's jvp/vjp in "
                        "example blocks of this size (bounds the live "
                        "activations; default config sampling.cg_example_block)")
    p.add_argument("--mesh", action="store_true",
                   help="not ported (ROADMAP, Queue A)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--max_batches", type=int, default=None,
                   help="evaluate only the first N test batches")
    p.add_argument("--out_json", default=None,
                   help="append per-repetition metrics as JSON lines")
    p.add_argument("--data_dir", default="data/")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a GPU) or 'cpu'")
    return p


class _Limited:
    """First-N-batches view of a loader."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __iter__(self):
        return itertools.islice(iter(self.loader), self.n)


def matfree_knobs(sampling_cfg: dict, args=None) -> dict:
    """The matfree predictive's knobs: the config's ``sampling`` entries, each
    overridden by its flag in ``args`` when given (``precond_rank`` 0
    disables the preconditioner)."""
    knobs = {}
    for key in ("cg_tol", "cg_maxiter", "precond_rank", "precond_power",
                "cg_example_block"):
        flag = getattr(args, key, None)
        knobs[key] = flag if flag is not None else sampling_cfg[key]
    knobs["precond_rank"] = knobs["precond_rank"] or None
    return knobs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> list[dict]:
    """Run the evaluation; returns one record per repetition."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    print(set_f32_policy())
    print(f"[device] {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    if not args.scalable:
        raise NotImplementedError("the dense LLA predictive is not ported yet "
                                  "(ROADMAP, Queue A): pass --scalable")
    if args.mesh:
        raise NotImplementedError("--mesh is not ported yet (ROADMAP, Queue A)")
    cfg = load_experiment_config(args.config)
    model_cfg = cfg["model"]
    opt_cfg = cfg["optimization"]
    ip_cfg = opt_cfg["ip"]
    sampling_cfg = cfg["sampling"]
    predictive = args.predictive or sampling_cfg["predictive"]
    if predictive == "cov":
        raise NotImplementedError(f"predictive {predictive!r} is not ported yet "
                                  "(ROADMAP, Queue A)")
    # alpha precedence: CLI flag > pipeline-recorded alpha > config
    meta = load_run_meta(args.ckpt_induc, f"ind_{args.dataset}")
    if args.alpha_ip is not None:
        alpha, alpha_src = args.alpha_ip, "cli"
    elif meta and "alpha_ip" in meta:
        alpha, alpha_src = float(meta["alpha_ip"]), "pipeline meta"
    else:
        alpha, alpha_src = opt_cfg["alpha"], "config"
    print(f"alpha={alpha} ({alpha_src})")

    batch_size = opt_cfg["map"]["batch_size"]
    # the train split is read for its size only: no augmentation
    train_loader, test_loader, _ = get_dataloaders(args.dataset, batch_size, aug=False,
                                                   root=args.data_dir)
    ood_loader = None
    if args.ood_dataset:
        _, ood_loader, _ = get_dataloaders(args.ood_dataset, batch_size, aug=False,
                                           root=args.data_dir)
    full_set_size = opt_cfg["full_set_size"] or len(train_loader.dataset)

    model = get_model(model_cfg, DATASET_SHAPES[args.dataset][0]).to(device)
    flat, spec, logvar = load_params(args.ckpt_map, f"map_{args.dataset}")
    if logvar is not None:
        with torch.no_grad():
            model.logvar.fill_(logvar)
    stats = load_batch_stats(args.ckpt_map, f"map_{args.dataset}")
    state = ModelState(model, flat.to(device), model_kind=model_cfg["type"],
                       batch_stats={key: t.to(device) for key, t in stats.items()})
    if spec != state.spec:
        raise ValueError(f"MAP file layout {spec.names} does not match the "
                         f"model's {state.spec.names}")
    Z = torch.as_tensor(load_array(args.ckpt_induc, f"ind_{args.dataset}",
                                   ip_cfg["epochs"]), dtype=torch.float32).to(device)

    range_clip = args.range_clip if args.range_clip > 0 else None
    sample_block = (args.sample_block if args.sample_block is not None
                    else sampling_cfg["sample_block"])
    matfree = {}
    if predictive == "matfree":
        matfree = matfree_knobs(sampling_cfg, args)
        print(f"[predictor] predictive method: matfree {matfree}")
        if range_clip is not None:
            print("[predictor] NOTE: the matfree path's Matheron sampler is exact: "
                  "--range_clip is ignored")
    with torch.no_grad():
        t0 = time.perf_counter()
        predictor = ScalableLLAPredictor(state, Z, full_set_size=full_set_size,
                                         example_block=ip_cfg["example_block"],
                                         range_clip_min=range_clip,
                                         sample_block=sample_block,
                                         method=predictive, **matfree)
        _sync(device)
        factor_s = time.perf_counter() - t0
    print(f"[predictor] posterior factor built in {factor_s:.3f} s "
          f"(M={Z.shape[0]}, d={predictor.d}, D={state.spec.num_params}"
          + (f", Nystrom rank {predictor.nys[0].shape[1]}" if matfree and predictor.nys
             else "") + ")")

    n_batches = len(test_loader)
    if args.max_batches:
        test_loader = _Limited(test_loader, args.max_batches)
        n_batches = min(n_batches, args.max_batches)
        print(f"[eval] limited to first {args.max_batches} test batches")

    records = []
    for i in range(args.iters):
        generator = torch.Generator(device=device).manual_seed(EVAL_SEED + i)
        t0 = time.perf_counter()
        with torch.no_grad():
            rec = eval_dataset_extended(
                state, test_loader, Z, alpha=alpha, full_set_size=full_set_size,
                num_mc_samples=ip_cfg["mc_samples"], generator=generator,
                predictor=predictor)
        _sync(device)
        dt = time.perf_counter() - t0
        record = {"dataset": args.dataset, "alpha": alpha, "iter": i,
                  "predictive": predictive, "mc": ip_cfg["mc_samples"],
                  "device": str(device), "factor_s": factor_s,
                  "wallclock_s": dt, "batches": n_batches,
                  "per_batch_s": dt / n_batches}
        if predictive == "matfree":
            record["cg_rel_residual"] = predictor.last_cg_residual
        if "acc" in rec:
            print(f"\nTest NLL   : {rec['nll']:8.5f}"
                  f"\nTest Acc   : {rec['acc'] * 100:8.3f} %"
                  f"\nBrier      : {rec['brier']:8.5f}"
                  f"\nECE (15bin): {rec['ece']:8.5f}"
                  f"\nTime       : {dt:.3f} s ({n_batches} batches, "
                  f"{dt / n_batches:.3f} s per batch)")
            record.update(nll=rec["nll"], acc=rec["acc"], brier=rec["brier"],
                          ece=rec["ece"])
        else:
            print(f"\nTest NLL   : {rec['nll']:8.5f}"
                  f"\nTest RMSE  : {rec['rmse']:8.5f}"
                  f"\nPICP (90%) : {rec['picp90'] * 100:8.3f} %"
                  f"\nTime       : {dt:.3f} s")
            record.update(nll=rec["nll"], rmse=rec["rmse"], picp90=rec["picp90"])
        if ood_loader is not None and "probs" in rec:
            with torch.no_grad():
                auroc = auroc_ood(state, rec["probs"], ood_loader, Z, alpha=alpha,
                                  full_set_size=full_set_size,
                                  num_mc_samples=ip_cfg["mc_samples"],
                                  generator=generator, predictor=predictor)
            print(f"OOD AUROC  : {auroc * 100:8.3f} %")
            record["ood_auroc"] = auroc
        if args.out_json:
            os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
            with open(args.out_json, "a") as f:
                f.write(json.dumps(record) + "\n")
        records.append(record)
    return records


if __name__ == "__main__":
    main()
