"""Long-contraction FP32 products ``A Bᵀ`` and ``A B``: the hand-written Hopper
kernels, their plain versions and their gradients.

* ``matmul_nt`` replaces ``_matmul_nt_pallas``
  (``laplace_inducing_points_tpu/ops/pallas/matmul.py:68``): ``(m, D)·(n, D)ᵀ``
  contracting the long shared axis without forming ``Bᵀ`` — the sample
  projection ``U = ε Rᵀ``, the cross-Gram ``Gxz = Rx Rzᵀ``, the Woodbury
  projection and the SLQ loop's ``Rz v``.
* ``matmul_nn`` replaces ``_matmul_nn_pallas``
  (``laplace_inducing_points_tpu/ops/pallas/matmul.py:153``): a small
  ``(m, z)`` times a long ``(z, D)`` — the sample push-back ``(·) R``, the
  SLQ loop's ``Rzᵀ u`` and the backward passes of ``syrk`` and ``matmul_nt``.

Each product takes one of several kernel paths, chosen from its shape alone
by :func:`nt_plan` and :func:`nn_plan` (``csrc/matmul.cu`` and
``csrc/matmul_tiled.cu``; the source notes say what bounds each on an H100).
The planners are pure functions of the shape and a :class:`Geometry`: what
the kernels' library reports of its tiles, its limits and their occupancy on
the card (:func:`geometry`).

* ``"row"`` (at most ``row_max`` output rows): bound by one read of the long
  operand — NT streams the rows of ``B`` and dots each with ``A``'s rows; NN
  walks ``B``'s rows once per column, ``z`` split across blocks and the
  partials summed in split order;
* ``"rank"`` (NN, contraction depth at most ``rank_max``): bound by one
  write of ``C`` — the rank-one products of the SLQ loop's backward;
* ``"tiled"`` (the rest): 3xTF32 tensor-core tiles (``mma.sync``, a
  ``cp.async`` ring), NT split across blocks along ``D`` where its few output
  tiles would leave SMs idle, partials summed in split order.

Every path sums in FP32 with Kahan-compensated strips and deterministic
reductions. On a CPU tensor the wrappers compute the plain version; on a CUDA
tensor they launch a kernel path or raise.

Each wrapper is a ``torch.autograd.Function`` with the reference's custom VJP
(``_matmul_nt_bwd`` ``:105``, ``_matmul_nn_bwd`` ``:190``). The backward
contractions run over the same long axis, so they go through the same kernels,
never ``torch.matmul``; only the short operand is ever transposed into a
contiguous copy. A call with no gradient to record skips the Function,
whose ``apply`` would only add host time. ``wrapper.launches`` counts the
forward's kernel launches,
``wrapper.backward_launches`` those of its backward, and
``wrapper.path_launches`` every launch of the kernels by path (forward and
backward, the sweep's FP32 products included).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from laplace_inducing_points_tpu_torch.ops.cuda._build import (check_matrix,
                                                               load_library,
                                                               raise_on_status,
                                                               stream_of)


def _check_pair(A: torch.Tensor, B: torch.Tensor) -> None:
    check_matrix("A", A)
    check_matrix("B", B)
    if A.device != B.device:
        raise ValueError(f"A is on {A.device} but B is on {B.device}")


def matmul_nt_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A Bᵀ`` through ``torch.matmul`` (f32; TF32 must be off on CUDA)."""
    return torch.matmul(A, B.T)


def matmul_nn_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A B`` through ``torch.matmul`` (f32; TF32 must be off on CUDA)."""
    return torch.matmul(A, B)


MIN_SPLIT_DEPTH = 1024   # the least contraction a split tiled block takes
WAVE_FILL = 0.85         # the least share of the last wave's SMs a split plan keeps busy
ROW_BLOCKS_PER_SM = 8    # NN row path: blocks per SM that its z split aims for
ROW_MIN_DEPTH = 64       # the least z a block of the NN row path takes


class Geometry(NamedTuple):
    """What the planners need of the kernels on one card, as the kernels'
    library reports it (``lip_matmul_geometry`` in ``csrc/matmul_tiled.cu``)."""
    sms: int
    row_max: int                 # output rows of the row paths at most
    rank_max: int                # contraction depth of the rank path at most
    row_cols: int                # output columns of a block of the NN row path
    tile_cols: int               # output columns of a tiled block
    tile_rows: tuple[int, int]   # output rows of a tiled block: small, large
    nt_blocks: tuple[int, int]   # resident tiled NT blocks per SM: small, large tiles
    nn_blocks: tuple[int, int]   # the same for NN
    syrk_blocks: tuple[int, int]  # the same for the Gram's lower tiles (``csrc/syrk.cu``)


class Plan(NamedTuple):
    """A product's kernel path: ``"row"``, ``"rank"`` or ``"tiled"``; the tiled
    block's output rows (0 on the other paths); how many blocks share the
    contraction (1: no split)."""
    path: str
    tile_rows: int
    splits: int


def wave_splits(tiles: int, depth: int, slots: int, min_depth: int = MIN_SPLIT_DEPTH) -> int:
    """The fewest parts of a contraction of ``depth`` over ``tiles`` output
    tiles that keep every wave of ``slots`` resident blocks at least
    ``WAVE_FILL`` full, none shallower than ``min_depth``."""
    most = max(1, depth // min_depth)
    for splits in range(1, most + 1):
        blocks = tiles * splits
        if blocks / (slots * math.ceil(blocks / slots)) >= WAVE_FILL:
            return splits
    return most


def _tiled_plan(m: int, n: int, depth: int, geo: Geometry,
                blocks_per_sm: tuple[int, int]) -> Plan:
    """Tiles of the small height (when ``m`` fits it) or the large one over
    ``(m, n)``, the contraction split by :func:`wave_splits`."""
    small, large = geo.tile_rows
    rows = small if m <= small else large
    tiles = math.ceil(m / rows) * math.ceil(n / geo.tile_cols)
    slots = blocks_per_sm[rows != small] * geo.sms
    return Plan("tiled", rows, wave_splits(tiles, depth, slots))


def nt_plan(m: int, n: int, D: int, geo: Geometry) -> Plan:
    """The path of ``A (m, D) · B (n, D)ᵀ`` on a card of geometry ``geo``."""
    if m <= geo.row_max:
        return Plan("row", 0, 1)
    return _tiled_plan(m, n, D, geo, geo.nt_blocks)


def nn_plan(m: int, z: int, N: int, geo: Geometry) -> Plan:
    """The path of ``A (m, z) · B (z, N)`` on a card of geometry ``geo``."""
    if z <= geo.rank_max:
        return Plan("rank", 0, 1)
    if m <= geo.row_max:
        col_blocks = math.ceil(N / geo.row_cols)
        splits = min(math.ceil(ROW_BLOCKS_PER_SM * geo.sms / col_blocks), z // ROW_MIN_DEPTH)
        return Plan("row", 0, max(1, splits))
    return _tiled_plan(m, N, z, geo, geo.nn_blocks)


@functools.lru_cache(maxsize=None)
def geometry(device: torch.device) -> Geometry:
    """The planners' :class:`Geometry` of a CUDA ``device``, from the
    kernels' library (built at the first call)."""
    out = (ctypes.c_int64 * 13)()
    with torch.cuda.device(device):
        raise_on_status(load_library().lip_matmul_geometry(out), "lip_matmul_geometry")
    v = list(out)
    if min(v[7:]) < 1:
        raise RuntimeError(f"a tiled kernel fits no block on an SM of {device}: {v}")
    return Geometry(*v[:5], tuple(v[5:7]), tuple(v[7:9]), tuple(v[9:11]), tuple(v[11:13]))


def _partials(plan: Plan, C: torch.Tensor) -> torch.Tensor:
    """The split partials' workspace, or ``C`` itself without a split."""
    if plan.splits == 1:
        return C
    return torch.empty((plan.splits, *C.shape), dtype=torch.float32, device=C.device)


def launch_nt(A: torch.Tensor, B: torch.Tensor, plan: Plan) -> torch.Tensor:
    """``A Bᵀ`` of checked CUDA operands on ``plan``'s path: one launch,
    counted in ``matmul_nt.path_launches``."""
    (m, D), n = A.shape, B.shape[0]
    C = torch.empty((m, n), dtype=torch.float32, device=A.device)
    lib = load_library()
    with torch.cuda.device(A.device):
        if plan.path == "row":
            status = lib.lip_nt_rows_f32(A.data_ptr(), B.data_ptr(), C.data_ptr(), m, n, D,
                                         stream_of(A))
        elif plan.path == "tiled":
            status = lib.lip_nt_tiled_f32(A.data_ptr(), B.data_ptr(),
                                          _partials(plan, C).data_ptr(), C.data_ptr(), m, n,
                                          D, plan.tile_rows, plan.splits, stream_of(A))
        else:
            raise ValueError(f"matmul_nt has no {plan.path!r} path")
    raise_on_status(status, f"matmul_nt ({plan.path})")
    matmul_nt.path_launches[plan.path] += 1
    return C


def launch_nn(A: torch.Tensor, B: torch.Tensor, plan: Plan) -> torch.Tensor:
    """``A B`` of checked CUDA operands on ``plan``'s path: one launch,
    counted in ``matmul_nn.path_launches``."""
    (m, z), N = A.shape, B.shape[1]
    C = torch.empty((m, N), dtype=torch.float32, device=A.device)
    lib = load_library()
    with torch.cuda.device(A.device):
        if plan.path == "rank":
            status = lib.lip_nn_rank_f32(A.data_ptr(), B.data_ptr(), C.data_ptr(), m, z, N,
                                         stream_of(A))
        elif plan.path == "row":
            status = lib.lip_nn_rows_f32(A.data_ptr(), B.data_ptr(),
                                         _partials(plan, C).data_ptr(), C.data_ptr(), m, z, N,
                                         plan.splits, stream_of(A))
        elif plan.path == "tiled":
            status = lib.lip_nn_tiled_f32(A.data_ptr(), B.data_ptr(),
                                          _partials(plan, C).data_ptr(), C.data_ptr(), m, z,
                                          N, plan.tile_rows, plan.splits, stream_of(A))
        else:
            raise ValueError(f"matmul_nn has no {plan.path!r} path")
    raise_on_status(status, f"matmul_nn ({plan.path})")
    matmul_nn.path_launches[plan.path] += 1
    return C


def nt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A Bᵀ`` of checked operands: the plain version on the CPU, one launch
    of the NT kernel path that :func:`nt_plan` picks on CUDA. Records no
    gradient."""
    if A.device.type == "cpu":
        return matmul_nt_plain(A, B)
    (m, D), n = A.shape, B.shape[0]
    return launch_nt(A, B, nt_plan(m, n, D, geometry(A.device)))


def nn(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A B`` of checked operands: the plain version on the CPU, one launch
    of the NN kernel path that :func:`nn_plan` picks on CUDA. Records no
    gradient."""
    if A.device.type == "cpu":
        return matmul_nn_plain(A, B)
    (m, z), N = A.shape, B.shape[1]
    return launch_nn(A, B, nn_plan(m, z, N, geometry(A.device)))


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _records_graph(A: torch.Tensor, B: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (A.requires_grad or B.requires_grad)


def _nt_forward(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    C = nt(A, B)
    if _on_cuda(A):
        matmul_nt.launches += 1
    return C


def _nn_forward(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    C = nn(A, B)
    if _on_cuda(A):
        matmul_nn.launches += 1
    return C


def matmul_nt_vjp(A, B, ct, need_a: bool = True, need_b: bool = True):
    """Cotangents of ``C = A Bᵀ``: ``dA = Ĉ B``, ``dB = Ĉᵀ A``, each one NN
    product over the long axis; a gradient not needed is not computed."""
    ct = ct.contiguous()
    dA = nn(ct, B) if need_a else None
    dB = nn(ct.T.contiguous(), A) if need_b else None
    if _on_cuda(ct):
        matmul_nt.backward_launches += int(need_a) + int(need_b)
    return dA, dB


def matmul_nn_vjp(A, B, ct, need_a: bool = True, need_b: bool = True):
    """Cotangents of ``C = A B``: ``dA = Ĉ Bᵀ`` (an NT product over the long
    axis) and ``dB = Aᵀ Ĉ`` (an NN product)."""
    ct = ct.contiguous()
    dA = nt(ct, B) if need_a else None
    dB = nn(A.T.contiguous(), ct) if need_b else None
    if _on_cuda(ct):
        matmul_nn.backward_launches += int(need_a) + int(need_b)
    return dA, dB


class _MatmulNT(torch.autograd.Function):
    @staticmethod
    def forward(A, B):
        return _nt_forward(A, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        return matmul_nt_vjp(*ctx.saved_tensors, ct, *ctx.needs_input_grad)


class _MatmulNN(torch.autograd.Function):
    @staticmethod
    def forward(A, B):
        return _nn_forward(A, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        return matmul_nn_vjp(*ctx.saved_tensors, ct, *ctx.needs_input_grad)


def matmul_nt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A Bᵀ`` for ``A (m, D)`` and ``B (n, D)``: ``(m, n)``."""
    _check_pair(A, B)
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"contraction mismatch: {tuple(A.shape)} x {tuple(B.shape)}ᵀ")
    return _MatmulNT.apply(A, B) if _records_graph(A, B) else _nt_forward(A, B)


def matmul_nn(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A B`` for ``A (m, z)`` and ``B (z, D)``: ``(m, D)``."""
    _check_pair(A, B)
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(A.shape)} x {tuple(B.shape)}")
    return _MatmulNN.apply(A, B) if _records_graph(A, B) else _nn_forward(A, B)


matmul_nt.launches = matmul_nt.backward_launches = 0
matmul_nn.launches = matmul_nn.backward_launches = 0
matmul_nt.path_launches = {"row": 0, "tiled": 0}
matmul_nn.path_launches = {"row": 0, "rank": 0, "tiled": 0}
