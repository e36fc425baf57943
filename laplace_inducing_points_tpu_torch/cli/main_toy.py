"""Toy-experiment pipeline driver: MAP, inducing points Z, figures.

Counterpart of ``laplace_inducing_points_tpu/cli/main_toy.py`` with its four
modes (``train_map``, ``train_inducing``, ``visualize``, ``full_pipeline``) and
every flag of the JAX CLI, plus ``--device``. The toy data comes through
``data.toy``: a file in ``--data_dir`` or a committed fixture holding the
config's generation parameters, else drawn by the port's generator and
written into ``--data_dir``; an explicit ``--dataset path.npz`` is read as it
is. The MAP weights start from a seeded
numpy lecun-normal init in the JAX layout (``model.seed``; the Flax init
stream cannot be reproduced); ``--map_restarts`` k > 1 trains k of them,
candidate i ≥ 1 from seed ``model.seed + 104729·i`` and a loader seeded
``map.seed + 7919·i``, and keeps the lowest validation NLL. The checkpoints
are the ones ``cli.evaluate`` reads: ``{ckpt_map}/map_{ds}.pt`` (a
regressor's learned ``logvar`` inside) and ``{ckpt_induc}/ind_{ds}_{epochs}.npz``
with its run meta.

Each figure is computed on the device (``viz.nplot``) and checked finite;
drawing it needs matplotlib, and without it one line says which figure was
not drawn.

Usage:
    python -m laplace_inducing_points_tpu_torch.cli.main_toy full_pipeline \\
        --dataset banana --config configs/toy/classifier_banana.yml --device cuda
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from laplace_inducing_points_tpu_torch.cli.train_scale import StepClock
from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.data.loader import (ArrayDataset, cycling_batches,
                                                           make_dataloaders)
from laplace_inducing_points_tpu_torch.data.toy import (ensure_toy_npz, load_dataset,
                                                        train_test_val_split)
from laplace_inducing_points_tpu_torch.models.registry import get_model
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.training.grid_search import grid_search_alpha
from laplace_inducing_points_tpu_torch.training.inducing import (
    train_inducing_points, train_inducing_points_restarts)
from laplace_inducing_points_tpu_torch.training.map import evaluate_loader, train_map
from laplace_inducing_points_tpu_torch.utils.checkpoint import (load_array, load_state,
                                                                save_array, save_params,
                                                                save_run_meta)
from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
from laplace_inducing_points_tpu_torch.utils.device import resolve_device, set_f32_policy
from laplace_inducing_points_tpu_torch.viz import nplot
from laplace_inducing_points_tpu_torch.viz.style import use_thesis_style


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["train_map", "train_inducing", "visualize",
                                    "full_pipeline"])
    p.add_argument("--dataset", required=True,
                   help="toy dataset name (sine/xor/spiral/ring/banana) or path to an "
                        ".npz with x, y arrays")
    p.add_argument("--config", required=True, help="experiment YAML")
    p.add_argument("--full", action="store_true",
                   help="visualize full-data LLA instead of IP-LLA")
    p.add_argument("--scalable", action="store_true",
                   help="stochastic IP objective + scalable LLA sampling")
    p.add_argument("--objective", default=None,
                   choices=["dense", "gram", "stochastic", "stochastic_matfree"],
                   help="override the inducing objective")
    p.add_argument("--num_mc_samples_lla", type=int, default=1000)
    p.add_argument("--alpha_ip", type=float, default=None)
    p.add_argument("--alpha_mode", default="config", choices=["config", "grid"],
                   help="'config' uses optimization.alpha end to end; 'grid' runs the "
                        "val-NLL grid search over 16 points in [1e-3, 10]")
    p.add_argument("--range_clip", type=float, default=1.0,
                   help="eigenvalue clip inside the posterior inverse sqrt (<=0 disables)")
    p.add_argument("--restarts", type=int, default=None,
                   help="k-restart Z training selected by the exact full-set KL; "
                        "default config optimization.ip.restarts; 1 = one run")
    p.add_argument("--alpha_train", type=float, default=None,
                   help="train Z at this prior precision (the evaluation keeps the "
                        "pipeline alpha); default config optimization.ip.alpha_train")
    p.add_argument("--ip_seed", type=int, default=None,
                   help="override optimization.ip.seed (Z-training probes, minibatch "
                        "shuffle, restart inits)")
    p.add_argument("--plot_Z", action="store_true")
    p.add_argument("--plot_X", action="store_true")
    p.add_argument("--style", default=None, choices=["thesis"],
                   help="'thesis' applies the reference's figure theme (viz/style.py)")
    p.add_argument("--comparison", action="store_true",
                   help="also the LA-vs-LLA 1x3 predictive-mean figure and the 2x1 "
                        "IP-LLA mean/std figure")
    p.add_argument("--map_restarts", type=int, default=None,
                   help="train k MAP fits (fresh init and loader order) and keep the "
                        "lowest validation NLL; default config optimization.map.restarts, "
                        "else 1")
    p.add_argument("--map_alpha_factor", type=float, default=None,
                   help="multiply the MAP L2 prior by this factor (the inducing and "
                        "evaluation alpha are untouched); default config "
                        "optimization.map.alpha_factor, else 1")
    p.add_argument("--ckpt_map", default="checkpoint/map/")
    p.add_argument("--ckpt_induc", default="checkpoint/ind/")
    p.add_argument("--fig_dir", default="fig/")
    p.add_argument("--data_dir", default="data/")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a GPU) or 'cpu'")
    return p


def _load_data(args, cfg):
    if args.dataset.endswith(".npz"):
        return load_dataset(args.dataset), os.path.splitext(os.path.basename(args.dataset))[0]
    data_cfg = dict(cfg.get("data") or {})
    path = ensure_toy_npz(args.dataset, data_dir=args.data_dir, n=data_cfg.pop("n", 512),
                          noise=data_cfg.pop("noise", 0.05), seed=data_cfg.pop("seed", 42),
                          **data_cfg)
    return load_dataset(path), args.dataset


def _init_state(model, model_cfg, device, seed: int) -> ModelState:
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(model), seed))
    return ModelState(model, flat.to(device), model_kind=model_cfg["type"])


def _train_map(args, cfg, model, device, splits, test_loader, val_loader, ds_name):
    """The MAP (k restarts selected by validation NLL); returns the state and
    its step summary."""
    model_cfg, map_cfg = cfg["model"], cfg["optimization"]["map"]
    tr, te, va = splits
    restarts = (args.map_restarts if args.map_restarts is not None
                else int(map_cfg.get("restarts", 1)))
    factor = (args.map_alpha_factor if args.map_alpha_factor is not None
              else float(map_cfg.get("alpha_factor", 1.0)))
    map_alpha = cfg["optimization"]["alpha"] * factor
    best, best_nll, cand_nlls, stats = None, None, [], None
    for i in range(restarts):
        state = _init_state(model, model_cfg, device,
                            (model_cfg["seed"] + i * 104729) % 2**31)
        loader, _, _ = make_dataloaders(ArrayDataset(*tr), ArrayDataset(*te),
                                        ArrayDataset(*va), batch_size=map_cfg["batch_size"],
                                        seed=(map_cfg["seed"] + i * 7919) % 2**31)
        clock, losses = StepClock(device), []

        def callback(step, loss):
            clock.tick()
            losses.append(loss)

        state = train_map(state, loader, test_loader, num_epochs=map_cfg["epochs"],
                          alpha=map_alpha, lr=map_cfg["lr"], callback=callback)
        nll = evaluate_loader(state, val_loader)[0] if restarts > 1 else None
        cand_nlls.append(nll)
        if best is None or nll < best_nll:
            losses = [float(v) for v in losses]
            best, best_nll = state, nll
            stats = {**clock.summary(), "loss_first": losses[0], "loss_last": losses[-1],
                     "loss_head": float(np.mean(losses[:10])),
                     "loss_tail": float(np.mean(losses[-10:]))}
    if restarts > 1:
        print(f"[map] {restarts} restarts (alpha_factor={factor}) val NLLs "
              f"{[round(v, 5) for v in cand_nlls]} -> kept {best_nll:.5f}")
    print(f"[MAP] {stats['steps']} steps, {stats['s_per_step']:.5f} s per step (median); "
          f"loss {stats['loss_first']:.4f} -> {stats['loss_last']:.4f}")
    logvar = float(best.logvar) if best.model_kind == "regressor" else None
    save_params(best.flat_params, best.spec, args.ckpt_map, f"map_{ds_name}", logvar=logvar,
                batch_stats=best.batch_stats)
    return best, {**stats, "val_nlls": cand_nlls, "logvar": logvar}


def _figure(name: str, result: dict, figures: dict, draw_fn, *draw_args,
            **draw_kwargs) -> None:
    """Record whether a computed figure is finite, then draw it."""
    figures[name] = nplot.all_finite(result)
    print(f"[viz] {name}: computed on the device, finite={figures[name]}")
    nplot.draw(name, draw_fn, result, *draw_args, **draw_kwargs)


def main(argv=None) -> dict:
    """Run the mode; returns the phases' summaries (``map``, ``alpha_ip``,
    ``inducing``, ``figures``: name -> finite)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    print(set_f32_policy(device))
    print(f"[device] {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    if args.style == "thesis":
        nplot.draw("the thesis style", use_thesis_style)
    cfg = load_experiment_config(args.config)
    model_cfg, opt_cfg = cfg["model"], cfg["optimization"]
    map_cfg, ip_cfg = opt_cfg["map"], opt_cfg["ip"]
    if args.ip_seed is not None:
        ip_cfg["seed"] = args.ip_seed
    kind = model_cfg["type"]
    alpha = opt_cfg["alpha"]

    (x, y), ds_name = _load_data(args, cfg)
    tr, te, va = train_test_val_split(x, y)
    train_loader, test_loader, val_loader = make_dataloaders(
        ArrayDataset(*tr), ArrayDataset(*te), ArrayDataset(*va),
        batch_size=map_cfg["batch_size"], seed=map_cfg["seed"] % 2**31)
    full_set_size = opt_cfg.get("full_set_size") or tr[0].shape[0]
    model = get_model(model_cfg, tr[0].shape[1:]).to(device)
    result: dict = {"figures": {}, "dataset": ds_name}
    figures = result["figures"]

    # ---- MAP ----------------------------------------------------------------
    if args.mode in ("train_map", "full_pipeline"):
        state, result["map"] = _train_map(args, cfg, model, device, (tr, te, va),
                                          test_loader, val_loader, ds_name)
        if kind == "classifier":
            _figure("MAP decision surface", nplot.map_2d_classification(state, tr[0]),
                    figures, nplot.draw_map_2d, tr[0], tr[1],
                    os.path.join(args.fig_dir, f"{ds_name}_{kind}_map.png"))
        print("[DONE] MAP training.")
        if args.mode == "train_map":
            return result
    else:
        state = load_state(args.ckpt_map, f"map_{ds_name}", model, kind, device)

    # ---- inducing points ----------------------------------------------------
    m = ip_cfg["m"]
    z_init = torch.as_tensor(tr[0][:m], dtype=torch.float32, device=device)
    ip_loader = make_dataloaders(ArrayDataset(*tr), ArrayDataset(*te), ArrayDataset(*va),
                                 batch_size=ip_cfg["batch_size"],
                                 seed=ip_cfg["seed"] % 2**31)[0]
    objective = args.objective or ("stochastic" if args.scalable else ip_cfg["objective"])
    alpha_ip = args.alpha_ip
    if alpha_ip is None and args.alpha_mode == "config":
        alpha_ip = float(alpha)
        print(f"[alpha] using config alpha end-to-end: {alpha_ip}")
    if alpha_ip is None:
        # the reference driver's toy grid: 16 points in [1e-3, 10]
        alpha_ip = grid_search_alpha(
            state, z_init, val_loader, full_set_size=full_set_size,
            num_mc_samples=ip_cfg["mc_samples"], log10_min=-3.0, log10_max=1.0,
            n_coarse=16, range_clip_min=args.range_clip if args.range_clip > 0 else None)
    result["alpha_ip"] = float(alpha_ip)

    if args.mode in ("train_inducing", "full_pipeline"):
        plot_cb = None
        if args.plot_Z and kind == "classifier":
            plot_cb = nplot.make_inducing_callback(ds_name, xtrain=tr[0], ytrain=tr[1],
                                                   fig_dir=args.fig_dir)
        alpha_train = (args.alpha_train if args.alpha_train is not None
                       else ip_cfg.get("alpha_train"))
        if alpha_train is not None and float(alpha_train) != float(alpha_ip):
            print(f"[alpha] Z-training at alpha_train={alpha_train} "
                  f"(posterior/eval alpha stays {alpha_ip})")
        clock, losses = StepClock(device), []

        def callback(step, Z, loss):
            clock.tick()
            losses.append(loss)
            if plot_cb is not None:
                plot_cb(step, Z, loss)

        n_restarts = args.restarts if args.restarts is not None else ip_cfg["restarts"]
        train_kwargs = dict(
            alpha=float(alpha_train) if alpha_train is not None else alpha_ip,
            num_steps=ip_cfg["epochs"], lr=ip_cfg["lr"], full_set_size=full_set_size,
            objective=objective, st_samples=ip_cfg["st_samples"],
            slq_samples=ip_cfg["slq_samples"], slq_num_matvecs=ip_cfg["slq_num_matvecs"],
            example_block=ip_cfg["example_block"], cg_tol=ip_cfg["cg_tol"],
            cg_maxiter=ip_cfg["cg_maxiter"], precond_rank=ip_cfg["precond_rank"],
            precond_power=ip_cfg["precond_power"], callback=callback)
        meta = {"alpha_ip": float(alpha_ip), "objective": objective}
        if alpha_train is not None:
            meta["alpha_train"] = float(alpha_train)
        seed = ip_cfg["seed"] % 2**31
        if n_restarts > 1:
            Z, kl_best, kls = train_inducing_points_restarts(
                state, z_init, cycling_batches(ip_loader),
                selection_X=torch.as_tensor(tr[0], dtype=torch.float32, device=device),
                n_restarts=n_restarts, seed=seed, **train_kwargs)
            meta.update(restarts=n_restarts, full_set_kl=kl_best, restart_kls=kls)
        else:
            Z = train_inducing_points(
                state, z_init, cycling_batches(ip_loader),
                generator=torch.Generator(device=device).manual_seed(seed), **train_kwargs)
        result["inducing"] = {**clock.summary(), "objective": objective,
                              "loss_first": losses[0], "loss_last": losses[-1],
                              "z_moved": float(torch.max(torch.abs(Z - z_init))),
                              **{k: meta[k] for k in ("full_set_kl", "restart_kls")
                                 if k in meta}}
        print(f"[inducing] {result['inducing']['steps']} steps, "
              f"{result['inducing']['s_per_step']:.5f} s per step (median)")
        save_array(Z, args.ckpt_induc, f"ind_{ds_name}", ip_cfg["epochs"])
        save_run_meta(args.ckpt_induc, f"ind_{ds_name}", meta)
        print("[DONE] Inducing training.")
    else:
        Z = torch.as_tensor(load_array(args.ckpt_induc, f"ind_{ds_name}", ip_cfg["epochs"]),
                            dtype=torch.float32, device=device)

    # ---- figures ------------------------------------------------------------
    if args.mode in ("visualize", "full_pipeline"):
        Z_plot = torch.as_tensor(tr[0], dtype=torch.float32, device=device) if args.full else Z
        z_np = Z_plot.cpu().numpy()
        ip_set_size = None if args.full else full_set_size
        if kind == "classifier":
            suffix = "_mf" if args.scalable else ""
            res = nplot.lla_2d_classification(
                state, tr[0], Z_plot, alpha_ip,
                generator=torch.Generator(device=device).manual_seed(
                    ip_cfg["seed"] % 2**31 + 1),
                num_mc_samples=args.num_mc_samples_lla, full_set_size=ip_set_size,
                scalable=args.scalable)
            _figure("LLA predictive on the grid", res, figures, nplot.draw_lla_2d, tr[0], tr[1],
                    z_np, os.path.join(args.fig_dir, f"{ds_name}_{kind}_lla_"
                                       f"{'full' if args.full else 'ip'}{suffix}.png"),
                    plot_Z=args.plot_Z, plot_X=args.plot_X)
        else:
            res = nplot.regression_lla_1d(state, tr[0], Z_plot, alpha_ip,
                                          full_set_size=ip_set_size)
            result["regression_1d"] = res
            _figure("1-D LLA predictive", res, figures, nplot.draw_regression_1d, tr[0], tr[1],
                    z_np, os.path.join(args.fig_dir, f"{ds_name}_{kind}_lla.png"))
        if args.comparison and kind == "classifier":
            mc = min(args.num_mc_samples_lla, 100)
            res = nplot.predictive_mean_comparison(
                state, tr[0], alpha_ip, num_mc_samples=mc,
                generator=torch.Generator(device=device).manual_seed(7))
            _figure("LA-vs-LLA predictive means", res, figures, nplot.draw_predictive_mean,
                    tr[0], tr[1], os.path.join(args.fig_dir, f"{ds_name}_mean_comparison.png"))
            res = nplot.ip_lla_comparison(
                state, tr[0], Z_plot, alpha_ip, num_mc_samples=mc, scalable=args.scalable,
                full_set_size=ip_set_size,
                generator=torch.Generator(device=device).manual_seed(8))
            _figure("IP-LLA mean and std", res, figures, nplot.draw_comparison, tr[0], tr[1],
                    z_np, os.path.join(args.fig_dir, f"{ds_name}_ip_lla_comparison.png"))
        print("[DONE] Visualization.")
    return result


if __name__ == "__main__":
    main()
