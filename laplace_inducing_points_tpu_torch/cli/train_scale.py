"""Scale-experiment trainer: MAP weights, then inducing points Z on the exact
Gram KL.

Counterpart of ``laplace_inducing_points_tpu/cli/train_scale.py:83-268`` for
the LeNet5 slice: the three modes, MAP with the cosine schedule, Z training
with the ``gram`` objective at ``--alpha_ip``, the ``--train_log`` rows and
summary, and the checkpoints that ``cli.evaluate`` reads (the MAP weights as
``{ckpt_map}/map_{dataset}.pt``, Z as ``{ckpt_induc}/ind_{dataset}_{epochs}.npz``
with the run's meta beside it). The α grid search, evidence α, ``--continue``,
``--profile``, the other objectives and a mesh are not ported yet and raise
(ROADMAP, Queue A).

The MAP weights start from a seeded numpy lecun-normal init in the JAX layout
(``core.params.lecun_normal_params`` of ``model.seed``): the Flax init stream
cannot be reproduced. Shuffles use numpy's generator.

Usage:
    python -m laplace_inducing_points_tpu_torch.cli.train_scale full_pipeline \
        --dataset mnist --config configs/scale/lenet5_mnist.yml \
        --alpha_ip 0.005 --device cuda
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.data.loader import cycling_batches
from laplace_inducing_points_tpu_torch.data.scale import DATASET_SHAPES, get_dataloaders
from laplace_inducing_points_tpu_torch.models.registry import get_model
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.training.inducing import train_inducing_points
from laplace_inducing_points_tpu_torch.training.map import cosine_lr, train_map
from laplace_inducing_points_tpu_torch.utils.checkpoint import (load_params, save_array,
                                                                save_params,
                                                                save_run_meta)
from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
from laplace_inducing_points_tpu_torch.utils.device import resolve_device, set_f32_policy


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["train_map", "train_inducing", "full_pipeline"])
    p.add_argument("--dataset", required=True, choices=sorted(DATASET_SHAPES))
    p.add_argument("--config", required=True)
    p.add_argument("--continue", dest="resume", action="store_true",
                   help="not ported (ROADMAP, Queue A)")
    p.add_argument("--alpha_ip", type=float, default=None,
                   help="prior precision of the Z training; required here (the "
                        "alpha grid search is not ported, ROADMAP, Queue A)")
    p.add_argument("--alpha_mode", default="grid", choices=["grid", "evidence"],
                   help="'evidence' is not ported (ROADMAP, Queue A)")
    p.add_argument("--objective", default=None,
                   choices=["dense", "gram", "gram_chunked", "stochastic",
                            "stochastic_matfree"],
                   help="only 'gram' is ported; default: config ip.objective")
    p.add_argument("--ckpt_map", default="checkpoint/map/")
    p.add_argument("--ckpt_induc", default="checkpoint/ind/")
    p.add_argument("--data_dir", default="data/")
    p.add_argument("--mesh", action="store_true", help="not ported (ROADMAP, Queue A)")
    p.add_argument("--train_log", default=None,
                   help="JSONL path: per-step {step, loss, seconds} rows of the "
                        "inducing phase plus one kl_training_run summary row")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="not ported (ROADMAP, Queue A)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a GPU) or 'cpu'")
    return p


def _refuse_unported(args) -> None:
    unported = {
        "--continue": args.resume,
        "--alpha_mode evidence": args.alpha_mode == "evidence",
        "--profile": args.profile is not None,
        "--mesh": args.mesh,
        f"--objective {args.objective}": args.objective not in (None, "gram"),
    }
    for flag, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP, Queue A)")
    if args.mode != "train_map" and args.alpha_ip is None:
        raise NotImplementedError("the alpha grid search is not ported yet "
                                  "(ROADMAP, Queue A): pass --alpha_ip")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _StepClock:
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


def _train_map(args, cfg, model, device, train_loader, test_loader) -> tuple[ModelState, dict]:
    model_cfg, map_cfg = cfg["model"], cfg["optimization"]["map"]
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(model),
                                                  model_cfg["seed"]))
    state = ModelState(model, flat.to(device), model_kind=model_cfg["type"])
    if map_cfg["schedule"] == "cosine":
        lr = cosine_lr(map_cfg["lr"], map_cfg["epochs"], len(train_loader))
    else:
        lr = map_cfg["lr"]
    clock, losses = _StepClock(device), []

    def callback(step, loss):
        clock.tick()
        losses.append(loss)

    state = train_map(state, train_loader, test_loader, num_epochs=map_cfg["epochs"],
                      alpha=cfg["optimization"]["alpha"], lr=lr, callback=callback)
    stats = {**clock.summary(), "loss_first": float(losses[0]),
             "loss_last": float(losses[-1])}
    print(f"[MAP] {stats['steps']} steps, first {stats['first_step_s']:.4f} s, "
          f"then {stats['s_per_step']:.4f} s per step (median); loss "
          f"{stats['loss_first']:.4f} -> {stats['loss_last']:.4f}")
    save_params(state.flat_params, state.spec, args.ckpt_map, f"map_{args.dataset}")
    return state, stats


def _load_map(args, cfg, model, device) -> ModelState:
    flat, spec, _ = load_params(args.ckpt_map, f"map_{args.dataset}")
    state = ModelState(model, flat.to(device), model_kind=cfg["model"]["type"])
    if spec != state.spec:
        raise ValueError(f"MAP file layout {spec.names} does not match the "
                         f"model's {state.spec.names}")
    return state


def main(argv=None) -> dict:
    """Run the mode; returns ``{"map": ..., "inducing": ...}`` timing and loss
    summaries of the phases that ran."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    print(set_f32_policy())
    print(f"[device] {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    cfg = load_experiment_config(args.config)
    opt_cfg = cfg["optimization"]
    ip_cfg = opt_cfg["ip"]

    train_loader, test_loader, _ = get_dataloaders(
        args.dataset, opt_cfg["map"]["batch_size"], root=args.data_dir)
    full_set_size = opt_cfg["full_set_size"] or len(train_loader.dataset)
    model = get_model(cfg["model"], DATASET_SHAPES[args.dataset][0]).to(device)

    result = {}
    if args.mode in ("train_map", "full_pipeline"):
        state, result["map"] = _train_map(args, cfg, model, device, train_loader,
                                          test_loader)
        print("[DONE] MAP training.")
        if args.mode == "train_map":
            return result
    else:
        state = _load_map(args, cfg, model, device)

    # inducing points: init from a training batch of size m (no augmentation)
    m = ip_cfg["m"]
    init_loader, _, _ = get_dataloaders(args.dataset, m, aug=False, root=args.data_dir)
    z_init = torch.as_tensor(next(iter(init_loader))[0], dtype=torch.float32,
                             device=device)
    ip_loader, _, _ = get_dataloaders(args.dataset, ip_cfg["batch_size"], aug=False,
                                      root=args.data_dir)
    alpha_ip, alpha_src = args.alpha_ip, "cli"
    objective = args.objective or ip_cfg["objective"]
    if objective != "gram":
        raise NotImplementedError(f"objective {objective!r} is not ported yet "
                                  "(ROADMAP, Queue A)")

    callback, rows = None, []
    if args.train_log:
        clock = _StepClock(device)

        def callback(step, _Z, loss):
            row = {"step": step, "loss": loss, "seconds": clock.tick()}
            rows.append(row)
            with open(args.train_log, "a" if step else "w") as f:
                f.write(json.dumps(row) + "\n")

    Z = train_inducing_points(state, z_init, cycling_batches(ip_loader), alpha=alpha_ip,
                              num_steps=ip_cfg["epochs"], lr=ip_cfg["lr"],
                              full_set_size=full_set_size, objective=objective,
                              example_block=ip_cfg["example_block"], callback=callback)
    if rows:
        losses = [r["loss"] for r in rows]
        summary = {"op": "kl_training_run", "objective": objective, "M": int(m),
                   "seconds_per_step": clock.summary()["s_per_step"],
                   "first_step_seconds": rows[0]["seconds"], "steps": len(rows),
                   "loss_first": losses[0], "loss_last": losses[-1],
                   "loss_min": min(losses), "alpha_ip": float(alpha_ip),
                   "device": str(device)}
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
