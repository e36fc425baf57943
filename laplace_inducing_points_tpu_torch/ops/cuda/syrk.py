"""SYRK ``C = A Aᵀ`` in true FP32: the hand-written Hopper kernel, its plain
version and its gradient.

Replaces the Pallas kernel ``_syrk_pallas``
(``laplace_inducing_points_tpu/ops/pallas/syrk.py:71``). The kernel is
``csrc/syrk.cu`` on the 3xTF32 tile machinery of the B2/B3 tiled paths
(``csrc/tiled.cuh``: FP32 accuracy, Kahan-folded sums with the tensor cores'
truncation loss put back): only the 64×128 tiles that touch the lower
triangle are launched, the contraction axis is split across blocks by wave
fill (:func:`syrk_plan`, a pure function of the shape and the
:class:`~.matmul.Geometry` the library reports), and a second pass sums the
partials in split order and writes each lower element and its mirror, so
``C`` is exactly symmetric. Its source note says what bounds it on an H100.

The wrapper is a ``torch.autograd.Function`` with the reference's custom VJP
(``_syrk_diff_bwd``, ``syrk.py:122``): ``dA = (Ĉ + Ĉᵀ) A``, one launch of the
tiled NN path of ``csrc/matmul_tiled.cu`` over the long axis. ``syrk.launches`` counts
the forward's launches, ``syrk.backward_launches`` the backward's, and
``syrk.path_launches`` the Gram kernel's launches on its one (tiled) path.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from laplace_inducing_points_tpu_torch.ops.cuda._build import (check_matrix,
                                                               load_library,
                                                               raise_on_status,
                                                               stream_of)
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (Geometry, Plan, geometry, nn,
                                                               wave_splits)

SYRK_TILE_ROWS = 64   # measured against 32 on an H100 (PERF.md)


def syrk_plain(A: torch.Tensor) -> torch.Tensor:
    """``A Aᵀ`` through ``torch.matmul`` (f32; TF32 must be off on CUDA)."""
    return torch.matmul(A, A.T)


def lower_tiles(d: int, rows: int, cols: int) -> int:
    """Output tiles of ``rows × cols`` that hold an element on or below the
    diagonal of a ``(d, d)`` Gram: row tile ``i`` reaches column
    ``rows·(i + 1) − 1`` (``lower_tiles`` in ``csrc/tiled.cuh``)."""
    col_tiles = math.ceil(d / cols)
    return sum(min(col_tiles, (rows * i + rows - 1) // cols + 1)
               for i in range(math.ceil(d / rows)))


def syrk_plan(d: int, D: int, geo: Geometry) -> Plan:
    """The Gram's tiles (``SYRK_TILE_ROWS`` × ``geo.tile_cols``, lower ones
    only) and the split of ``D`` that fills the waves of the card."""
    rows = SYRK_TILE_ROWS
    slots = geo.syrk_blocks[geo.tile_rows.index(rows)] * geo.sms
    return Plan("tiled", rows, wave_splits(lower_tiles(d, rows, geo.tile_cols), D, slots))


def launch_syrk(A: torch.Tensor, plan: Plan) -> torch.Tensor:
    """``A Aᵀ`` of a checked CUDA operand on ``plan``'s tiles and splits: one
    launch (and the second pass when split)."""
    d, D = A.shape
    C = torch.empty((d, d), dtype=torch.float32, device=A.device)
    part = C if plan.splits == 1 else torch.empty((plan.splits, d, d), dtype=torch.float32,
                                                  device=A.device)
    with torch.cuda.device(A.device):
        status = load_library().lip_syrk_f32(A.data_ptr(), part.data_ptr(), C.data_ptr(), d, D,
                                             plan.tile_rows, plan.splits, stream_of(A))
    raise_on_status(status, "syrk")
    syrk.path_launches["tiled"] += 1
    return C


def syrk_vjp(A: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Cotangent of ``C = A Aᵀ``: ``dA = (Ĉ + Ĉᵀ) A``."""
    dA = nn((ct + ct.T).contiguous(), A)
    if A.device.type == "cuda":
        syrk.backward_launches += 1
    return dA


class _Syrk(torch.autograd.Function):
    @staticmethod
    def forward(A):
        if A.device.type == "cpu":
            return syrk_plain(A)
        C = launch_syrk(A, syrk_plan(*A.shape, geometry(A.device)))
        syrk.launches += 1
        return C

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        return syrk_vjp(*ctx.saved_tensors, ct)


def syrk(A: torch.Tensor) -> torch.Tensor:
    """Gram ``A Aᵀ`` of a ``(d, D)`` f32 matrix, ``(d, d)`` and symmetric."""
    check_matrix("A", A)
    return _Syrk.apply(A)


syrk.launches = syrk.backward_launches = 0
syrk.path_launches = {"tiled": 0}
