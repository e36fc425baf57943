"""The readings that the limits of ``correct`` are set from, on the chip at a
cell's own size, all seeds in one process:

    python3 perfbench/calibrate.py --workload <cell> --seconds 10 \\
        --seeds 1 2 ... [--control 1 2 3] [--faults 1 2 3]

Each reading is a whole run of the cell through ``harness.execute``: set-up,
a window of ``--seconds``, the check. For each of ``--seeds``: the program's
numbers against the float64 reference. For each of ``--control``: the
control's. In a Z-training cell the control is the program with its Gram
products and their backward on ``torch.matmul`` in TF32 (the tensor cores'
lower precision, which the port never uses); in serving it is the plain
reference computed in TF32 put in the program's place. For each of
``--faults`` (Z-training cells): the program with half of each data batch
left out (the KL's data term then averages over the half that is left). One
JSON line per reading, then the largest sound reading and the smallest
control and fault reading of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402
from perfbench.reference import lla  # noqa: E402


def half_batch(inducing):
    """``(optimize_step, the same step on the first half of its batch)``."""
    step = inducing.optimize_step

    def broken(Z, X, *args, **kwargs):
        return step(Z, X[:X.shape[0] // 2], *args, **kwargs)
    return step, broken


def tf32_grams(inducing):
    """``(kl_rows_value_and_grad, the same with the Gram products Rz Rz^T and
    Rx Rz^T, forward and backward, on torch.matmul in TF32)``."""
    rows_value_and_grad, grams = inducing.kl_rows_value_and_grad, inducing.grams_from_rows

    def tf32(*args, **kwargs):
        inducing.grams_from_rows = lambda Rz, Rx: (Rz @ Rz.T, Rx @ Rz.T, torch.sum(Rx * Rx),
                                                   Rz.shape[1])
        try:
            with lla.precision("tf32"):
                return rows_value_and_grad(*args, **kwargs)
        finally:
            inducing.grams_from_rows = grams
    return rows_value_and_grad, tf32


@contextlib.contextmanager
def planted(run: harness.Run, what: str):
    """The program as ``what`` asks: ``program`` as it is, ``fault`` with
    half of each batch left out, ``control`` with its Gram products in TF32
    (Z-training cells; serving's control is the reference, below)."""
    if run.mix["driver"] != "ztrain" or what == "program":
        yield
        return
    from laplace_inducing_points_tpu_torch.training import inducing
    name, (saved, broken) = {"fault": ("optimize_step", half_batch(inducing)),
                             "control": ("kl_rows_value_and_grad", tf32_grams(inducing))}[what]
    setattr(inducing, name, broken)
    try:
        yield
    finally:
        setattr(inducing, name, saved)


def serve_control(run: harness.Run, seconds: float) -> dict:
    """Serving's control: the samples of the checked requests by the plain
    reference in TF32 in the program's place, against the float64 one."""
    session = run.driver.Session(run)
    session.window(seconds)
    run.sync()
    session.free()
    ks = sorted(session.program)
    try:
        got = {k: samples for k, (samples, _) in session.reference("tf32", ks).items()}
    except torch.linalg.LinAlgError as err:          # a crash fails; it gives no number
        return {"crashed": str(err)[:200]}
    return session.compare(got, session.reference("float64", ks))


def readings(cell: str, seed: int, what: str, device: torch.device, seconds: float = 5.0,
             config_overrides: dict | None = None) -> dict:
    """One reading of ``what`` (``program``, ``control`` or ``fault``): the
    numbers compared, and for a run through the harness whether it came out
    ``correct``."""
    run = harness.Run(cell, seed, device, config_overrides=config_overrides)
    if what == "control" and run.mix["driver"] == "serve":
        return serve_control(run, seconds)
    with planted(run, what):
        result = harness.execute(run, seconds, False, time.perf_counter())
    return {**{k: c["value"] for k, c in result["check"].items()},
            "correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"]}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--faults", type=int, nargs="*", default=[])
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {harness.nvidia_smi()}",
          flush=True)
    out: dict[str, list] = {"program": [], "control": [], "fault": []}
    for what, seeds in (("program", args.seeds), ("control", args.control),
                        ("fault", args.faults)):
        for seed in seeds:
            r = readings(args.workload, seed, what, torch.device("cuda", 0), args.seconds)
            out[what].append(r)
            print(json.dumps({"workload": args.workload, "what": what, "seed": seed, **r}),
                  flush=True)
    summary = {}
    for what, pick in (("program", max), ("control", min), ("fault", min)):
        numbers = [r for r in out[what] if "crashed" not in r]
        if numbers:
            summary[what] = {k: pick(r[k] for r in numbers) for k in numbers[0]
                             if isinstance(numbers[0][k], float)}
        if len(numbers) < len(out[what]):
            summary[f"{what}_crashed"] = len(out[what]) - len(numbers)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
