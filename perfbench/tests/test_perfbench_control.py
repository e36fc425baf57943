"""On the card: the control comes out not correct in every cell, where the
program comes out correct, each through the whole run at the cell's own size
on three seeds. In the Z-training cells the control is the program with its
Gram products in TF32, run through ``harness.execute``; in serving it is the
plain reference computed in TF32 and put in the program's place. Run on the
card with

    python3 -m pytest perfbench/tests -m cuda
"""

from __future__ import annotations

import pytest

from perfbench import calibrate, harness

CELLS = ["lenet5_mnist.ztrain_gram", "lenet5_mnist.serve_weight",
         "resnet1m_cifar10.ztrain_gram"]


def _correct(numbers: dict, cell: str) -> bool:
    if "crashed" in numbers:
        return False
    if "correct" in numbers:
        return numbers["correct"]
    limits = harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")["limits"]
    return harness.check_lines(numbers, limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cuda, cell):
    for seed in (901, 902, 903):
        assert _correct(calibrate.readings(cell, seed, "program", cuda, 3.0), cell)
        assert not _correct(calibrate.readings(cell, seed, "control", cuda, 3.0), cell)
