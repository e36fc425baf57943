"""Scale-experiment trainer: MAP weights, then inducing points Z on the exact
Gram KL, its stochastic (Hutch++ + SLQ) estimate or the dense D × D KL.

Counterpart of ``laplace_inducing_points_tpu/cli/train_scale.py:83-268``: the
three modes, MAP with the cosine schedule (BatchNorm statistics kept with the
weights), the prior precision of the Z training from ``--alpha_ip``, from
evidence maximization during the MAP (``--alpha_mode evidence``,
``training.alpha.train_map_then_alpha``) or from the validation-NLL grid
search on the initial Z (``training.grid_search.grid_search_alpha``: log₁₀ α
from 1 to 3, 8 coarse points and one refinement, on the config's
predictive; the matfree one with the config's ``sampling.cg_*`` and
``precond_*``), Z training with the ``dense`` (small models), ``gram``,
``stochastic`` or ``stochastic_matfree`` objective (the stochastic ones with the config's
``ip.st_samples``, ``ip.slq_samples``, ``ip.slq_num_matvecs`` and probes
seeded from ``ip.seed``; the matfree one also with ``ip.cg_tol``,
``ip.cg_maxiter``, ``ip.precond_rank``, ``ip.precond_power`` and
``ip.cg_example_block``, and a CG healthcheck on the trained Z printed and
kept in the ``--train_log`` summary; ``gram_chunked``: the gram step with its
rows built and pulled back ``ip.example_block or 4`` examples at a time), the
``--train_log`` rows and summary, and the checkpoints that ``cli.evaluate``
reads (the MAP train state, weights, statistics and Adam's state, as
``{ckpt_map}/map_{dataset}.pt``, Z as ``{ckpt_induc}/ind_{dataset}_{epochs}.npz``
with the run's meta beside it: the α and where it came from, ``cli``,
``evidence`` or ``grid``).

``--continue`` restores that train state and trains ``map.epochs`` more MAP
epochs from it (Adam and the cosine schedule resume at the restored step
count; past the schedule's end the rate stays at its floor), or starts
fresh where there is none. ``--profile DIR`` writes a ``torch.profiler``
trace of the inducing phase into DIR. With more than one GPU visible the MAP
steps are data-parallel over all of them (``parallel.mesh``) unless
``--no-mesh``; with one they run as they are.

The MAP weights start from a seeded numpy lecun-normal init in the JAX layout
(``core.params.lecun_normal_params`` of ``model.seed``; BatchNorm scale one,
statistics mean 0 and var 1): the Flax init stream cannot be reproduced.
Shuffles are the JAX package's (``data.loader``).

Usage:
    python -m laplace_inducing_points_tpu_torch.cli.train_scale full_pipeline \
        --dataset mnist --config configs/scale/mlp_mnist.yml --device cuda
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from laplace_inducing_points_tpu_torch.cli.evaluate import matfree_knobs
from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.data.loader import cycling_batches
from laplace_inducing_points_tpu_torch.data.scale import DATASET_SHAPES, get_dataloaders
from laplace_inducing_points_tpu_torch.models.registry import get_model
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.parallel.mesh import make_mesh
from laplace_inducing_points_tpu_torch.training.alpha import train_map_then_alpha
from laplace_inducing_points_tpu_torch.training.grid_search import grid_search_alpha
from laplace_inducing_points_tpu_torch.training.inducing import (healthcheck_line,
                                                                 matfree_cg_healthcheck,
                                                                 train_inducing_points)
from laplace_inducing_points_tpu_torch.training.map import cosine_lr, train_map
from laplace_inducing_points_tpu_torch.utils.checkpoint import (load_state, load_train_state,
                                                                save_array, save_run_meta,
                                                                save_train_state)
from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
from laplace_inducing_points_tpu_torch.utils.device import resolve_device, set_f32_policy
from laplace_inducing_points_tpu_torch.utils.profiling import trace


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["train_map", "train_inducing", "full_pipeline"])
    p.add_argument("--dataset", required=True, choices=sorted(DATASET_SHAPES))
    p.add_argument("--config", required=True)
    p.add_argument("--continue", dest="resume", action="store_true",
                   help="resume MAP training from the saved train state")
    p.add_argument("--alpha_ip", type=float, default=None,
                   help="prior precision of the Z training; default: the "
                        "evidence alpha (--alpha_mode evidence) or the grid search")
    p.add_argument("--alpha_mode", default="grid", choices=["grid", "evidence"],
                   help="grid = validation-NLL grid search; evidence = "
                        "interleave MAP with gradient ascent on the log "
                        "marginal likelihood (train_map_then_alpha)")
    p.add_argument("--objective", default=None,
                   choices=["dense", "gram", "gram_chunked", "stochastic",
                            "stochastic_matfree"],
                   help="'dense' for small models only; 'gram_chunked' builds and "
                        "pulls back the rows ip.example_block (or 4) examples at a "
                        "time; default: config ip.objective")
    p.add_argument("--ckpt_map", default="checkpoint/map/")
    p.add_argument("--ckpt_induc", default="checkpoint/ind/")
    p.add_argument("--data_dir", default="data/")
    p.add_argument("--no-mesh", action="store_true",
                   help="disable data-parallel sharding of the MAP steps over the GPUs")
    p.add_argument("--train_log", default=None,
                   help="JSONL path: per-step {step, loss, seconds} rows of the "
                        "inducing phase plus one kl_training_run summary row")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a TensorBoard-loadable torch.profiler trace (host and "
                        "device) of the inducing-training phase into DIR "
                        "(utils.profiling.trace). Traces grow with step count: use a "
                        "short run when profiling. Only the inducing phase is traced: "
                        "with mode=train_map (which has no inducing phase) the flag is "
                        "an error")
    p.add_argument("--range_clip", type=float, default=1.0,
                   help="clip min for (alpha + beta*lam) inside the posterior "
                        "inverse sqrt during the alpha grid search; must match "
                        "cli.evaluate's (1.0 in both); <=0 disables")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a GPU) or 'cpu'")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepClock:
    """Host seconds of each step, the device synchronised at each tick."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: list[float] = []
        _sync(device)
        self._last = time.perf_counter()

    def tick(self) -> float:
        _sync(self.device)
        now = time.perf_counter()
        self.seconds.append(now - self._last)
        self._last = now
        return self.seconds[-1]

    def summary(self) -> dict:
        warm = self.seconds[1:] or self.seconds
        return {"steps": len(self.seconds), "first_step_s": self.seconds[0],
                "s_per_step": statistics.median(warm)}


def _init_state(cfg, model, device) -> ModelState:
    """The MAP weights' start: the seeded numpy lecun-normal init."""
    model_cfg = cfg["model"]
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(model),
                                                  model_cfg["seed"]))
    return ModelState(model, flat.to(device), model_kind=model_cfg["type"])


def _train_map(args, cfg, state, device, train_loader, test_loader, full_set_size: int,
               mesh) -> tuple[ModelState, dict]:
    map_cfg = cfg["optimization"]["map"]
    if map_cfg["schedule"] == "cosine":
        lr = cosine_lr(map_cfg["lr"], map_cfg["epochs"], len(train_loader))
    else:
        lr = map_cfg["lr"]
    clock, losses = StepClock(device), []
    start = state.step
    start_lr = lr(start) if callable(lr) else lr

    def callback(step, loss):
        clock.tick()
        losses.append(loss)

    alpha = cfg["optimization"]["alpha"]
    evidence_alpha = None
    if args.alpha_mode == "evidence":
        state, evidence_alpha = train_map_then_alpha(
            state, train_loader, test_loader, num_epochs=map_cfg["epochs"], alpha0=alpha,
            lr=lr, burnin=max(map_cfg["epochs"] // 4, 1), full_set_size=full_set_size,
            example_block=cfg["optimization"]["ip"]["example_block"], callback=callback)
        print(f"[alpha] evidence-optimized alpha = {evidence_alpha:.5f}")
    else:
        state = train_map(state, train_loader, test_loader, num_epochs=map_cfg["epochs"],
                          alpha=alpha, lr=lr, callback=callback, mesh=mesh)
    stats = {**clock.summary(), "loss_first": float(losses[0]),
             "loss_last": float(losses[-1]), "evidence_alpha": evidence_alpha,
             "start_step": start, "start_lr": start_lr, "end_step": state.step}
    print(f"[MAP] steps {start} -> {state.step} (lr {start_lr:.6g} at step {start}), "
          f"first {stats['first_step_s']:.4f} s, "
          f"then {stats['s_per_step']:.4f} s per step (median); loss "
          f"{stats['loss_first']:.4f} -> {stats['loss_last']:.4f}")
    save_train_state(state, args.ckpt_map, f"map_{args.dataset}")
    return state, stats


def main(argv=None) -> dict:
    """Run the mode; returns ``{"map": ..., "alpha": ..., "inducing": ...}``
    timing and loss summaries of the phases that ran (``alpha``: the Z
    training's α, its source and the grid search's ``(alpha, nll)`` points)."""
    args = build_parser().parse_args(argv)
    if args.profile and args.mode == "train_map":
        # --profile traces the inducing phase only; in train_map mode main()
        # returns before it, so the flag would silently produce no trace
        raise SystemExit(
            "--profile traces the inducing-training phase, which mode=train_map never "
            "reaches: run mode=train_inducing or full_pipeline to profile, or drop the flag")
    device = resolve_device(args.device)
    print(set_f32_policy())
    print(f"[device] {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg = load_experiment_config(args.config)
    opt_cfg = cfg["optimization"]
    ip_cfg = opt_cfg["ip"]

    train_loader, test_loader, val_loader = get_dataloaders(
        args.dataset, opt_cfg["map"]["batch_size"], root=args.data_dir)
    full_set_size = opt_cfg["full_set_size"] or len(train_loader.dataset)
    model = get_model(cfg["model"], DATASET_SHAPES[args.dataset][0]).to(device)

    mesh = None
    if not args.no_mesh and device.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = make_mesh()
        print(f"[mesh] data-parallel over {torch.cuda.device_count()} devices")

    map_name, kind = f"map_{args.dataset}", cfg["model"]["type"]
    state = None
    if args.resume:
        try:
            state = load_train_state(args.ckpt_map, map_name, model, kind, device)
            print(f"[resume] continuing from step {state.step}")
        except FileNotFoundError:
            print("[resume] no checkpoint found — starting fresh")

    result = {}
    if args.mode in ("train_map", "full_pipeline"):
        state, result["map"] = _train_map(args, cfg, state or _init_state(cfg, model, device),
                                          device, train_loader, test_loader, full_set_size,
                                          mesh)
        print("[DONE] MAP training.")
        if args.mode == "train_map":
            return result
    elif not args.resume:
        state = load_state(args.ckpt_map, map_name, model, kind, device)
    elif state is None:
        state = _init_state(cfg, model, device)

    # inducing points: init from a training batch of size m (no augmentation)
    m = ip_cfg["m"]
    init_loader, _, _ = get_dataloaders(args.dataset, m, aug=False, root=args.data_dir)
    z_init = torch.as_tensor(next(iter(init_loader))[0], dtype=torch.float32,
                             device=device)
    ip_loader, _, _ = get_dataloaders(args.dataset, ip_cfg["batch_size"], aug=False,
                                      root=args.data_dir)
    evidence_alpha = result.get("map", {}).get("evidence_alpha")
    alpha_ip = args.alpha_ip if args.alpha_ip is not None else evidence_alpha
    alpha_src = "cli" if args.alpha_ip is not None else "evidence"
    grid = []
    if alpha_ip is None:
        sampling_cfg = cfg["sampling"]
        predictive = sampling_cfg["predictive"]
        knobs = matfree_knobs(sampling_cfg) if predictive == "matfree" else {}
        alpha_ip = grid_search_alpha(
            state, z_init, val_loader, full_set_size=full_set_size,
            num_mc_samples=ip_cfg["mc_samples"], log10_min=1.0, log10_max=3.0,
            n_coarse=8, range_clip_min=args.range_clip if args.range_clip > 0 else None,
            predictive=predictive, example_block=ip_cfg["example_block"],
            sample_block=sampling_cfg["sample_block"], history=grid, **knobs)
        alpha_src = "grid"
    result["alpha"] = {"alpha_ip": float(alpha_ip), "alpha_src": alpha_src, "grid": grid}
    objective = args.objective or ip_cfg["objective"]

    callback, rows = None, []
    if args.train_log:
        clock = StepClock(device)

        def callback(step, _Z, loss):
            row = {"step": step, "loss": loss, "seconds": clock.tick()}
            rows.append(row)
            with open(args.train_log, "a" if step else "w") as f:
                f.write(json.dumps(row) + "\n")

    cg = {key: ip_cfg[key] for key in ("cg_tol", "cg_maxiter", "precond_rank",
                                       "precond_power", "cg_example_block")}
    with trace(args.profile) if args.profile else contextlib.nullcontext():
        Z = train_inducing_points(
            state, z_init, cycling_batches(ip_loader), alpha=alpha_ip,
            num_steps=ip_cfg["epochs"], lr=ip_cfg["lr"], full_set_size=full_set_size,
            objective=objective, example_block=ip_cfg["example_block"],
            generator=torch.Generator(device=device).manual_seed(ip_cfg["seed"]),
            st_samples=ip_cfg["st_samples"], slq_samples=ip_cfg["slq_samples"],
            slq_num_matvecs=ip_cfg["slq_num_matvecs"], callback=callback, **cg)
    if args.profile:
        print(f"[profile] device trace written to {args.profile}")
    healthcheck = None
    if objective == "stochastic_matfree":
        # the inner solve's convergence at the trained Z
        healthcheck = matfree_cg_healthcheck(state, Z, alpha_ip, full_set_size=full_set_size,
                                             warn=False, **cg)
        result["healthcheck_post"] = healthcheck
        print(f"[inducing] matfree CG healthcheck at the trained Z: "
              f"{healthcheck_line(healthcheck)}")
    if rows:
        losses = [r["loss"] for r in rows]
        summary = {"op": "kl_training_run", "objective": objective, "M": int(m),
                   "seconds_per_step": clock.summary()["s_per_step"],
                   "first_step_seconds": rows[0]["seconds"], "steps": len(rows),
                   "loss_first": losses[0], "loss_last": losses[-1],
                   "loss_min": min(losses), "alpha_ip": float(alpha_ip),
                   "device": str(device)}
        if healthcheck is not None:
            summary.update({key: ip_cfg[key] for key in cg})
            summary.update(cg_rel_residual_post=healthcheck["cg_rel_residual"],
                           cg_converged_post=healthcheck["converged"],
                           cg_iterations_post=healthcheck["cg_iterations"],
                           kappa_post=healthcheck["kappa"],
                           kappa_deflated_post=healthcheck["kappa_deflated"],
                           predicted_iters_post=healthcheck["predicted_iters"])
        with open(args.train_log, "a") as f:
            f.write(json.dumps(summary) + "\n")
        print(f"[train_log] wrote {len(rows)} step rows + summary -> {args.train_log}")
        result["inducing"] = {**summary, "rows": rows}
    result["Z_moved"] = float(torch.max(torch.abs(Z - z_init)))
    save_array(Z, args.ckpt_induc, f"ind_{args.dataset}", ip_cfg["epochs"])
    # the alpha this Z was trained for, which cli.evaluate picks up
    save_run_meta(args.ckpt_induc, f"ind_{args.dataset}",
                  {"alpha_ip": float(alpha_ip), "alpha_src": alpha_src,
                   "objective": objective})
    print(f"[DONE] Inducing training (alpha_ip={alpha_ip:.5g}, {alpha_src}).")
    return result


if __name__ == "__main__":
    main()
