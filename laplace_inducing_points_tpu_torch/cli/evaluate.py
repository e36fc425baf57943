"""Evaluation CLI: NLL / ACC / Brier / ECE (+ OOD AUROC) with timing.

Counterpart of ``laplace_inducing_points_tpu/cli/evaluate.py``: loads MAP
weights (``{ckpt_map}/map_{dataset}.pt``, see ``utils.checkpoint.save_params``)
and the inducing points (``{ckpt_induc}/ind_{dataset}_{epochs}.npz``), builds
the posterior factor once (``--scalable --predictive weight`` or ``cov``: rows,
Gram and eigh; ``matfree``: its Nyström sketch; without ``--scalable``: the
dense D × D GGN), and runs timed evaluation repetitions and an optional OOD
pass. The scale datasets and the toy ones (``TOY_DATASETS``, read through
``data.toy``; the OOD ring at ``--ood_ring_radius``) are both served. The
matfree knobs come from the flags, else the config's
``sampling.cg_*``/``precond_*``; the cov path's ``--jac_block`` from the flag,
else ``sampling.jac_block``. ``--mesh`` splits the MC-sample axis of the
weight and matfree predictives over every visible GPU when there is more
than one (``parallel.mesh``); ``--profile DIR`` writes a ``torch.profiler``
trace of the last repetition into DIR.

Usage:
    python -m laplace_inducing_points_tpu_torch.cli.evaluate \
        --dataset mnist --config configs/scale/lenet5_mnist.yml \
        --scalable --predictive weight --device cuda
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import time

import torch

from laplace_inducing_points_tpu_torch.data.loader import ArrayDataset, make_dataloaders
from laplace_inducing_points_tpu_torch.data.scale import DATASET_SHAPES, get_dataloaders
from laplace_inducing_points_tpu_torch.data.toy import (TOY_DATASETS, ensure_toy_npz,
                                                        load_dataset, ring_cache_fname,
                                                        train_test_val_split)
from laplace_inducing_points_tpu_torch.evaluation.harness import (auroc_ood,
                                                                  eval_dataset_extended)
from laplace_inducing_points_tpu_torch.inference.lla import (DenseLLAPredictor,
                                                             ScalableLLAPredictor)
from laplace_inducing_points_tpu_torch.models.registry import get_model
from laplace_inducing_points_tpu_torch.parallel.mesh import make_mesh
from laplace_inducing_points_tpu_torch.utils.checkpoint import (load_array, load_run_meta,
                                                                load_state)
from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
from laplace_inducing_points_tpu_torch.utils.device import resolve_device, set_f32_policy
from laplace_inducing_points_tpu_torch.utils.profiling import trace

EVAL_SEED = 155858
DATASETS = sorted({*DATASET_SHAPES, *TOY_DATASETS})


def toy_loaders(name: str, batch_size: int, data_dir: str, data_cfg=None, seed: int = 0,
                **gen_kwargs):
    """``(train, test, val)`` loaders of a toy dataset's 80/10/10 split, read
    at the generation parameters of ``data_cfg`` (a config's ``data:``) and
    ``gen_kwargs``."""
    data_cfg = dict(data_cfg or {})
    data_cfg.update(gen_kwargs)
    x, y = load_dataset(ensure_toy_npz(name, data_dir=data_dir, n=data_cfg.pop("n", 512),
                                       noise=data_cfg.pop("noise", 0.05),
                                       seed=data_cfg.pop("seed", 42), **data_cfg))
    tr, te, va = train_test_val_split(x, y)
    return make_dataloaders(ArrayDataset(*tr), ArrayDataset(*te), ArrayDataset(*va),
                            batch_size, seed=seed)


def _loaders(name: str, batch_size: int, data_dir: str, data_cfg=None, **gen_kwargs):
    if name in TOY_DATASETS:
        return toy_loaders(name, batch_size, data_dir, data_cfg, **gen_kwargs)
    # the train split is read for its size only: no augmentation
    return get_dataloaders(name, batch_size, aug=False, root=data_dir)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True, choices=DATASETS)
    p.add_argument("--ood-dataset", default=None, choices=DATASETS)
    p.add_argument("--ood_ring_radius", type=float, default=None,
                   help="when --ood-dataset is 'ring', read it at this radius "
                        "(ring_r<radius>.npz; 2.0 and 1.05 are committed). "
                        "Default: the generator's defaults (ring.npz)")
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
                        "the eigh factor through a jvp; 'cov' builds per-image "
                        "statistics with K backward passes and samples each "
                        "image's K-dim Gaussian (the same marginals; the "
                        "statistics are cached across repetitions); 'matfree' "
                        "draws Matheron samples by Nystrom-preconditioned CG, no "
                        "d_z x D factor and no eigh (an exact sampler: "
                        "--range_clip is ignored). Default: config "
                        "sampling.predictive")
    p.add_argument("--jac_block", type=int, default=None,
                   help="cov predictive: images per Jacobian block (bounds the "
                        "(block, K, D) Jacobians); default config sampling.jac_block")
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
                   help="shard the MC-sample axis of the scalable predictor over all "
                        "visible GPUs (data-parallel evaluation; no-op on one device)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--max_batches", type=int, default=None,
                   help="evaluate only the first N test batches")
    p.add_argument("--out_json", default=None,
                   help="append per-repetition metrics as JSON lines")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a TensorBoard-loadable torch.profiler trace (host and "
                        "device) of the LAST evaluation repetition into DIR "
                        "(utils.profiling.trace). With --iters >= 2 the traced repetition "
                        "is warm; with --iters 1 it is the first one and INCLUDES the "
                        "one-time costs of a first run (a warning is printed)")
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
    cfg = load_experiment_config(args.config)
    model_cfg = cfg["model"]
    opt_cfg = cfg["optimization"]
    ip_cfg = opt_cfg["ip"]
    sampling_cfg = cfg["sampling"]
    predictive = (args.predictive or sampling_cfg["predictive"]) if args.scalable else "dense"
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
    train_loader, test_loader, _ = _loaders(args.dataset, batch_size, args.data_dir,
                                            data_cfg=cfg.get("data"))
    ood_loader = None
    if args.ood_dataset:
        # the test split for every kind of dataset, toys included
        ood_kwargs = {}
        if args.ood_dataset == "ring" and args.ood_ring_radius is not None:
            ood_kwargs = {"radius": args.ood_ring_radius,
                          "fname": ring_cache_fname(args.ood_ring_radius)}
        _, ood_loader, _ = _loaders(args.ood_dataset, batch_size, args.data_dir, **ood_kwargs)
    full_set_size = opt_cfg["full_set_size"] or len(train_loader.dataset)

    input_shape = train_loader.dataset.x.shape[1:]
    model = get_model(model_cfg, input_shape).to(device)
    state = load_state(args.ckpt_map, f"map_{args.dataset}", model, model_cfg["type"], device)
    Z = torch.as_tensor(load_array(args.ckpt_induc, f"ind_{args.dataset}",
                                   ip_cfg["epochs"]), dtype=torch.float32).to(device)

    range_clip = args.range_clip if args.range_clip > 0 else None
    sample_block = (args.sample_block if args.sample_block is not None
                    else sampling_cfg["sample_block"])
    knobs = {}
    if predictive == "matfree":
        knobs = matfree_knobs(sampling_cfg, args)
        print(f"[predictor] predictive method: matfree {knobs}")
        if range_clip is not None:
            print("[predictor] NOTE: the matfree path's Matheron sampler is exact: "
                  "--range_clip is ignored")
    if predictive == "cov":
        knobs = {"jac_block": (args.jac_block if args.jac_block is not None
                               else sampling_cfg["jac_block"])}
        print(f"[predictor] predictive method: cov {knobs}")
    mesh = None
    if (args.scalable and args.mesh and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        if predictive == "cov":
            print("[predictor] NOTE: --mesh applies only to the weight-space "
                  "push-forward; the cov path runs replicated (its per-sample cost is "
                  "a K-dim Gaussian draw: there is nothing worth sharding)")
        else:
            mesh = make_mesh()
            knobs["mesh"] = mesh
            print(f"[mesh] MC-sample axis over {torch.cuda.device_count()} devices")
    with torch.no_grad():
        t0 = time.perf_counter()
        if predictive == "dense":
            predictor = DenseLLAPredictor(state, Z, full_set_size=full_set_size)
        else:
            predictor = ScalableLLAPredictor(state, Z, full_set_size=full_set_size,
                                             example_block=ip_cfg["example_block"],
                                             range_clip_min=range_clip,
                                             sample_block=sample_block,
                                             method=predictive, **knobs)
        _sync(device)
        factor_s = time.perf_counter() - t0
    print(f"[predictor] posterior factor ({predictive}) built in {factor_s:.3f} s "
          f"(M={Z.shape[0]}, D={state.spec.num_params}"
          + (f", d={predictor.d}" if predictive != "dense" else ", the D x D GGN")
          + (f", Nystrom rank {predictor.nys[0].shape[1]}"
             if predictive == "matfree" and predictor.nys is not None else "") + ")")

    n_batches = len(test_loader)
    if args.max_batches:
        test_loader = _Limited(test_loader, args.max_batches)
        n_batches = min(n_batches, args.max_batches)
        print(f"[eval] limited to first {args.max_batches} test batches")

    if args.profile and args.iters == 1:
        print("[profile] WARNING: --iters 1 means the traced repetition is COLD: it is "
              "the first run of the evaluation step, with the CUDA kernels' build and "
              "load where the posterior factor build did not already do them, cuDNN's "
              "and the allocator's first calls and, for cov, the per-image statistics "
              "that later repetitions reuse. The factor build itself comes before "
              "the traced repetition. Use --iters >= 2 for a warm trace.")

    records = []
    for i in range(args.iters):
        generator = torch.Generator(device=device).manual_seed(EVAL_SEED + i)
        # trace only the last repetition: with iters >= 2 it is warm
        traced = args.profile and i == args.iters - 1
        t0 = time.perf_counter()
        with (trace(args.profile) if traced else contextlib.nullcontext()), torch.no_grad():
            rec = eval_dataset_extended(
                state, test_loader, Z, alpha=alpha, full_set_size=full_set_size,
                num_mc_samples=ip_cfg["mc_samples"], generator=generator,
                predictor=predictor)
        _sync(device)
        dt = time.perf_counter() - t0
        if traced:
            print(f"[profile] device trace of repetition {i} written to {args.profile}")
        record = {"dataset": args.dataset, "alpha": alpha, "iter": i,
                  "predictive": predictive, "mc": ip_cfg["mc_samples"],
                  "device": str(device), "factor_s": factor_s,
                  "wallclock_s": dt, "batches": n_batches,
                  "per_batch_s": dt / n_batches}
        if predictive == "matfree":
            record["cg_rel_residual"] = predictor.last_cg_residual
        if predictive == "cov":
            record.update(stats_cache_hits=predictor.cache_hits,
                          cov_check_frac=predictor.cov_check_frac)
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
