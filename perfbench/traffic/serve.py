"""Driver of predictive serving traffic: one client in a closed loop, each
request the program's ``ScalableLLAPredictor.logit_samples`` on a batch of
test images, complete when its ``(S, B, K)`` logit samples are on the device.

Set-up builds the predictor (its factor: the rows of the points ``Z``, their
Gram, its eigendecomposition) from the seed and serves ``warmup_requests``
requests on draws of their own. Request k takes batch ``k mod (test_set_size
// B)`` of the test images and draws its noise from a generator of its own,
seeded from the run's seed and k. The check takes the requests drawn from
the seed among the first ``sample_within``, and the last request, and
computes their samples again with the plain reference in float64 from the
same images and noise, the factor included.
"""

from __future__ import annotations

import statistics
import time

import torch

from perfbench import inputs, work
from perfbench.reference import lla


class Session:
    def __init__(self, run):
        from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
        from laplace_inducing_points_tpu_torch.models.registry import get_model
        from laplace_inducing_points_tpu_torch.models.state import ModelState
        from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy

        self.run, cfg, dev, mix = run, run.config, run.device, run.mix
        set_f32_policy(dev)
        sv = cfg["serve"]
        self.M, self.N = cfg["ip"]["m"], cfg["full_set_size"]
        self.B, self.S, self.alpha = sv["batch_size"], sv["mc_samples"], cfg["alpha"]
        self.flat = inputs.weights(run.net, run.seed, dev)
        self.stats = inputs.batch_stats(run.net, dev)
        model = get_model(cfg["model"], tuple(cfg["input_shape"])).to(dev)
        state = ModelState(model, self.flat.clone(), cfg["model"]["type"],
                           {k: v.clone() for k, v in self.stats.items()})
        self.Z = inputs.images(self.M, cfg["input_shape"], cfg["num_classes"], run.seed,
                               inputs.IMAGES, dev)
        self.test = inputs.images(sv["test_set_size"], cfg["input_shape"], cfg["num_classes"],
                                  run.seed, inputs.TEST_IMAGES, dev)
        self.predictor = ScalableLLAPredictor(state, self.Z, full_set_size=self.N,
                                              method=mix["method"],
                                              example_block=cfg["ip"]["example_block"],
                                              rank_tol=sv["rank_tol"],
                                              sample_block=sv["sample_block"])
        self.sampled = set(torch.randperm(
            mix["sample_within"], generator=inputs.generator(torch.device("cpu"), run.seed,
                                                             inputs.SAMPLE)
        )[:mix["check_requests"]].tolist())
        self.kept: dict[int, torch.Tensor] = {}
        for i in range(mix["warmup_requests"]):
            self._serve(i, inputs.WARMUP)
        self.next = 0

    def images(self, k: int) -> torch.Tensor:
        b = k % (self.test.shape[0] // self.B)
        return self.test[b * self.B:(b + 1) * self.B]

    def request(self, k: int, stream: int = inputs.DRAWS) -> torch.Tensor:
        g = inputs.generator(self.run.device, self.run.seed, stream, k)
        return self.predictor.logit_samples(self.images(k), self.alpha, g, self.S)

    def _serve(self, k: int, stream: int = inputs.DRAWS):
        """One request as the client makes it: its samples, whether they
        are all finite, both on the device when it returns."""
        out = self.request(k, stream)
        finite = torch.isfinite(out).all()
        self.run.sync()
        return out, finite

    def window(self, seconds: float) -> dict:
        latencies, finite, out = [], [], None
        self.run.sync()
        t0 = done = time.perf_counter()
        while done - t0 < seconds:
            k, sent = self.next, time.perf_counter()
            out, ok = self._serve(k)
            finite.append(ok)
            done = time.perf_counter()
            latencies.append(done - sent)
            if k in self.sampled:
                self.kept[k] = out
            self.next += 1
        self.kept[self.next - 1] = out
        n = len(latencies)
        return {"units": n, "attempted": n, "failed": n - int(torch.stack(finite).sum()),
                "elapsed_s": done - t0,
                "metrics": {"predict_img_per_s": self.B * n / (done - t0),
                            "predict_batch_ms_p95":
                                statistics.quantiles(latencies, n=20)[-1] * 1e3
                                if n > 1 else latencies[0] * 1e3}}

    def flops_per_unit(self) -> float:
        cfg = self.run.config
        return work.serve_batch_flops(self.S, self.B, self.M, cfg["num_classes"],
                                      cfg["num_params"], self.run.net.forward_flops())

    def kernel_calls(self) -> list:
        """The port's public B2 and B3 at one batch's shapes, on seeded
        operands."""
        from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
        d, D, dev = self.M * self.run.config["num_classes"], self.run.config["num_params"], \
            self.run.device
        g = inputs.generator(dev, self.run.seed, inputs.KERNELS)
        eps = torch.randn(self.S, D, generator=g, device=dev)
        R = torch.randn(d, D, generator=g, device=dev)
        mixed = torch.randn(self.S, d, generator=g, device=dev)
        return [("matmul_nt", lambda: matmul_nt(eps, R), work.matmul_nt(self.S, d, D)),
                ("matmul_nn", lambda: matmul_nn(mixed, R), work.matmul_nn(self.S, d, D))]

    def free(self) -> None:
        """Drop the predictor; keep the samples the check reads."""
        self.program = dict(self.kept)
        del self.predictor, self.kept
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mode: str, ks) -> dict:
        """The samples of requests ``ks`` by the plain reference in ``mode``
        (``float64``: the judge; ``tf32``: the control), and each image's
        logits."""
        cfg, net, dev = self.run.config, self.run.net, self.run.device
        block = cfg["reference_block"]
        out = {}
        with lla.precision(mode) as dt:
            flat = self.flat.to(dt)
            stats = {k: v.to(dt) for k, v in self.stats.items()}
            R = lla.rows(net, flat, stats, self.Z.to(dt), block)
            lam, V = lla.weight_factor(R)
            beta = self.N / self.M
            for k in ks:
                # the program's draw: the same generator, call and dtype
                eps = torch.randn(self.S, R.shape[1], dtype=torch.float32, device=dev,
                                  generator=inputs.generator(dev, self.run.seed,
                                                             inputs.DRAWS, k))
                x = self.images(k).to(dt)
                with torch.no_grad():
                    f = lla.logits(net, flat, stats, x)
                samples = lla.logit_samples(net, flat, stats, x, R, lam, V, eps.to(dt),
                                            self.alpha, beta, cfg["serve"]["rank_tol"], block)
                out[k] = (samples, f)
        return out

    def compare(self, got: dict, ref: dict) -> dict:
        """``draw_gap``: the widest, over the requests and their images, of
        ``|samples - reference| / |reference - logits|`` over one image's
        draws, in float64."""
        gap = 0.0
        for k, (samples, f) in ref.items():
            diff = torch.linalg.norm((got[k].double() - samples.double()).transpose(0, 1)
                                     .flatten(1), dim=1)
            spread = torch.linalg.norm((samples.double() - f.double()[None]).transpose(0, 1)
                                       .flatten(1), dim=1)
            gap = max(gap, float(torch.max(diff / spread)))
        return {"draw_gap": gap}

    def check(self) -> dict:
        return self.compare(self.program, self.reference("float64", sorted(self.program)))
