"""Driver of Z-training traffic: a closed loop of the program's
``training.inducing.optimize_step`` on fresh data batches, with no
synchronisation between steps.

Set-up builds one training object from the seed (the weights, the points
``Z`` with their Adam state) and drives it through its first
``check_steps`` steps on batches 0, 1, 2, ...; the window goes on with the
same object on the batches after them. The batches are consecutive slices
of ``ip.batch_size`` images of a pool of ``full_set_size`` synthetic images,
taken in order and cycled.

The check replays those first steps with the plain reference in float64
from the same points and batches and compares the first step's loss, the
first gradient as Adam holds it after one step, and the points' change after
the last of them. Before every step of the window the points and Adam's
moments are copied aside (three copies on the device, no synchronisation),
so the window's last step can be replayed too: the reference takes it from
the program's own state before it, on the same batch, and the check compares
its loss, its gradient (worked out from Adam's first moment before and after)
and the points' change.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import inputs, work
from perfbench.reference import lla


MOMENTS = ("exp_avg", "exp_avg_sq")


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """``| |a| - |b| | / |b|`` of two norms, in float64."""
    na, nb = float(torch.linalg.norm(a.double())), float(torch.linalg.norm(b.double()))
    return abs(na - nb) / nb


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / |b|``, in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


class Session:
    def __init__(self, run):
        from laplace_inducing_points_tpu_torch.models.registry import get_model
        from laplace_inducing_points_tpu_torch.models.state import ModelState
        from laplace_inducing_points_tpu_torch.training import inducing
        from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy

        self.run, cfg, dev = run, run.config, run.device
        set_f32_policy(dev)
        self.inducing = inducing
        ip = cfg["ip"]
        self.M, self.n, self.N = ip["m"], ip["batch_size"], cfg["full_set_size"]
        self.alpha, self.lr = cfg["alpha"], ip["lr"]
        self.example_block = ip["example_block"]
        self.objective = run.mix["objective"]
        self.flat = inputs.weights(run.net, run.seed, dev)
        self.stats = inputs.batch_stats(run.net, dev)
        model = get_model(cfg["model"], tuple(cfg["input_shape"])).to(dev)
        self.state = ModelState(model, self.flat.clone(), cfg["model"]["type"],
                                {k: v.clone() for k, v in self.stats.items()})
        self.pool = inputs.images(self.N, cfg["input_shape"], cfg["num_classes"], run.seed,
                                  inputs.IMAGES, dev)
        pick = torch.randperm(self.N, generator=inputs.generator(dev, run.seed, inputs.SAMPLE),
                              device=dev)[:self.M]
        self.Z0 = self.pool[pick].clone()
        self.Z = self.Z0.clone()
        self.opt = inducing.make_optimizer(self.Z, self.lr)
        self.beta1 = self.opt.param_groups[0]["betas"][0]
        self.next = 0
        # the first steps: the check's readings, and the warm-up of every shape
        self.losses = []
        for i in range(run.mix["check_steps"]):
            self.losses.append(self._step())
            if i == 0:      # Adam's first moment after one step is (1 - beta1) g
                self.first_grad = self.opt.state[self.Z]["exp_avg"] / (1 - self.beta1)
        self.Z_checked = self.Z.detach().clone()
        # the state before the window's latest step: the points, Adam's
        # moments, and the step's index (Adam's step count before it)
        self.before = {k: torch.empty_like(self.Z) for k in ("Z",) + MOMENTS}
        self._keep_state()          # warmed up here, like every step of the window
        self.last_loss = None

    def batch(self, i: int) -> torch.Tensor:
        b = i % (self.N // self.n)
        return self.pool[b * self.n:(b + 1) * self.n]

    def _step(self) -> torch.Tensor:
        loss = self.inducing.optimize_step(self.Z, self.batch(self.next), self.state,
                                           self.alpha, self.opt, objective=self.objective,
                                           full_set_size=self.N,
                                           example_block=self.example_block)
        self.next += 1
        return loss

    def _keep_state(self) -> None:
        moments = self.opt.state[self.Z]
        with torch.no_grad():
            self.before["Z"].copy_(self.Z)
            for k in MOMENTS:
                self.before[k].copy_(moments[k])
        self.before_step = self.next

    def window(self, seconds: float) -> dict:
        self.run.sync()
        losses, t0 = [], time.perf_counter()
        while True:
            self._keep_state()
            losses.append(self._step())
            if time.perf_counter() - t0 >= seconds:
                break
        self.run.sync()
        elapsed = time.perf_counter() - t0
        self.last_loss = losses[-1]
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"units": len(losses), "attempted": len(losses), "failed": failed,
                "elapsed_s": elapsed,
                "metrics": {"z_step_ms": elapsed * 1e3 / len(losses),
                            "z_train_img_per_s": self.n * len(losses) / elapsed}}

    def flops_per_unit(self) -> float:
        K, D = self.run.config["num_classes"], self.run.config["num_params"]
        return work.gram_step_flops(self.M, self.n, K, D, self.run.net.forward_flops())

    def kernel_calls(self) -> list:
        """The port's public B1 and B2 with their backwards at the step's
        shapes, on seeded operands."""
        from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nt
        from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
        K, D = self.run.config["num_classes"], self.run.config["num_params"]
        d_z, d_x = self.M * K, self.n * K
        g = inputs.generator(self.run.device, self.run.seed, inputs.KERNELS)
        Rz = torch.randn(d_z, D, generator=g, device=self.run.device).requires_grad_()
        Rx = torch.randn(d_x, D, generator=g, device=self.run.device)
        c_zz = torch.randn(d_z, d_z, generator=g, device=self.run.device)
        c_xz = torch.randn(d_x, d_z, generator=g, device=self.run.device)
        return [
            ("syrk+backward", lambda: torch.autograd.grad(syrk(Rz), Rz, c_zz),
             work.syrk(d_z, D) + work.syrk_backward(d_z, D)),
            ("matmul_nt+backward", lambda: torch.autograd.grad(matmul_nt(Rx, Rz), Rz, c_xz),
             work.matmul_nt(d_x, d_z, D) + work.matmul_nt_backward_b(d_x, d_z, D)),
        ]

    def free(self) -> None:
        """Drop the program's training state; keep what the check reads."""
        self.program = {"losses": [float(v) for v in self.losses],
                        "first_grad": self.first_grad.detach().clone(),
                        "Z": self.Z_checked}
        if self.last_loss is not None:
            self.program["window"] = {
                "step": self.before_step, "loss": float(self.last_loss),
                "before": self.before, "Z": self.Z.detach().clone(),
                "exp_avg": self.opt.state[self.Z]["exp_avg"].detach().clone()}
        del self.Z, self.opt, self.state, self.first_grad
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, steps: int, window: dict | None = None) -> dict:
        """The plain reference in float64: the first ``steps`` steps from the
        run's points, and the window's step from the state that ``window``
        holds (the program's, before that step)."""
        cfg, net, dt = self.run.config, self.run.net, torch.float64
        flat = self.flat.to(dt)
        stats = {k: v.to(dt) for k, v in self.stats.items()}

        def value_and_grad(Z, i):
            return lla.kl_value_and_grad(net, flat, stats, Z, self.batch(i).to(dt),
                                         self.alpha, self.N, cfg["reference_block"])
        Z, adam, losses = self.Z0.to(dt), lla.Adam(self.lr), []
        for i in range(steps):
            loss, grad = value_and_grad(Z, i)
            losses.append(float(loss))
            if i == 0:
                first_grad = grad
            Z = adam.step(Z, grad)
        out = {"losses": losses, "first_grad": first_grad, "Z": Z}
        if window is not None:
            before = {k: v.to(dt) for k, v in window["before"].items()}
            adam = lla.Adam(self.lr)
            adam.t, adam.m, adam.v = window["step"], before["exp_avg"], before["exp_avg_sq"]
            loss, grad = value_and_grad(before["Z"], window["step"])
            out["window"] = {"loss": float(loss), "grad": grad,
                             "Z": adam.step(before["Z"], grad)}
        return out

    def compare(self, got: dict, ref: dict) -> dict:
        """The numbers that decide ``correct``. Of the first steps: the first
        step's loss only (the later steps start from points that Adam has
        moved by round-off where a gradient entry is near 0, and their gaps
        swing 40x from seed to seed), the gap of the first gradient's norm
        and of the norm of the points' change. Of the window's last step,
        taken from the same state on both sides: its loss, and its gradient
        and the points' change by the norm of their difference, so that a
        gradient of the right size in a wrong direction shows. A loss's scale
        is floored at D, the size of the KL's terms, since the KL itself can
        pass near 0."""
        D = float(self.run.config["num_params"])
        out = {
            "loss_gap": abs(got["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]), D),
            "grad_norm_gap": _rel_gap(got["first_grad"], ref["first_grad"]),
            "change_norm_gap": _rel_gap(got["Z"] - self.Z0, ref["Z"] - self.Z0),
        }
        w, rw = got["window"], ref["window"]
        before = w["before"]
        grad = (w["exp_avg"].double() - self.beta1 * before["exp_avg"].double()) / (1 - self.beta1)
        out["window_loss_gap"] = abs(w["loss"] - rw["loss"]) / max(abs(rw["loss"]), D)
        out["window_grad_gap"] = _gap(grad, rw["grad"])
        out["window_step_gap"] = _gap(w["Z"].double() - before["Z"].double(),
                                      rw["Z"] - before["Z"].double())
        return out

    def check(self) -> dict:
        window = self.program["window"]
        if not all(bool(torch.isfinite(t).all()) for t in
                   (window["Z"], window["exp_avg"], *window["before"].values())):
            return {name: math.nan for name in self.run.limits}
        return self.compare(self.program, self.reference(self.run.mix["check_steps"], window))
