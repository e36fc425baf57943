"""GGN probe sweep ``scale·(V Rᵀ) R`` at estimator precision: the hand-written
Hopper kernel, its plain version and its gradient.

Replaces ``ggn_sweep`` (``laplace_inducing_points_tpu/ops/pallas/matmul.py:213``):
``_matmul_nt_pallas`` then ``_matmul_nn_pallas`` at the estimator precision
DEFAULT, one reduced-precision pass with f32 accumulation. The kernel is
``csrc/ggn_sweep.cu``: TF32 ``wgmma`` products with FP32 accumulators, every
operand rounded to TF32 to nearest (the tensor cores would truncate it), in
two stages that each read ``R`` from memory once: ``T = V Rᵀ``, split across
blocks along D by wave fill and summed (and rounded) in a second pass, then
``Y = scale·T R``, each block owning a strip of D's columns for a whole group
of probes (up to 256). :func:`sweep_plan` picks the group and the split from
the shape and the :class:`SweepGeometry` the library reports. Its source
note says what bounds it on an H100 and why TF32 is allowed here and nowhere
else in the port.

``precision="highest"`` keeps the reference's argument: the sweep then runs
through the true-FP32 ``matmul_nt`` and ``matmul_nn`` kernels.

The wrapper is a ``torch.autograd.Function``. The GGN is symmetric, so
``dV = ggn_sweep(Ĉ, R, scale)``, the same TF32 kernel;
``dR = scale·(Tᵀ Ĉ + (Ĉ Rᵀ)ᵀ V)`` runs through the FP32 NT/NN kernels and only
when ``R`` needs a gradient. ``ggn_sweep.launches`` counts the forward's kernel
launches, ``ggn_sweep.backward_launches`` those of its backward.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from laplace_inducing_points_tpu_torch.ops.cuda._build import (check_matrix,
                                                               load_library,
                                                               raise_on_status,
                                                               stream_of)
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                               matmul_nn_plain,
                                                               matmul_nt,
                                                               matmul_nt_plain, nn, nt,
                                                               wave_splits)


def ggn_sweep_plain(V: torch.Tensor, R: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``scale·(V Rᵀ) R`` through ``torch.matmul`` (f32; TF32 must be off on
    CUDA)."""
    return scale * torch.matmul(torch.matmul(V, R.T), R)


STRIP = 32   # the contraction strip of the kernel's operand tiles (lip_tc::BK)
# The least D a stage-1 block contracts. The tensor cores truncate each FP32 sum
# toward zero, so the bias of a partial grows with its length; the partials are
# summed in FP32, rounded to nearest. At the path shapes the waves, not this, set
# the splits.
MIN_SPLIT_DEPTH = 256


class SweepGeometry(NamedTuple):
    """What the sweep's planner needs of its kernels on one card, as the
    library reports it (``lip_sweep_geometry`` in ``csrc/ggn_sweep.cu``)."""
    sms: int
    tile: int                    # rows of R per stage-1 block
    groups: tuple[int, int]      # probes per block: small, large (twice the wgmma N)
    blocks: tuple[int, int]      # resident stage-1 blocks per SM at each group


class SweepPlan(NamedTuple):
    """Probes per block, and how many stage-1 blocks share the D axis."""
    group: int
    splits: int


@functools.lru_cache(maxsize=256)
def sweep_plan(P: int, d: int, D: int, geo: SweepGeometry) -> SweepPlan:
    """The small group when ``P`` fits it, else the large one (``P`` beyond it
    takes more groups); ``D`` split over the stage-1 tiles
    ``ceil(P/group)·ceil(d/tile)`` so that every wave is ``WAVE_FILL`` full, no
    block contracting fewer than ``MIN_SPLIT_DEPTH`` of it."""
    small, large = geo.groups
    group = small if P <= small else large
    tiles = -(-P // group) * -(-d // geo.tile)
    slots = geo.blocks[group != small] * geo.sms
    return SweepPlan(group, wave_splits(tiles, D, slots, MIN_SPLIT_DEPTH))


@functools.lru_cache(maxsize=None)
def sweep_geometry(device: torch.device) -> SweepGeometry:
    """The sweep planner's :class:`SweepGeometry` of a CUDA ``device``, from
    the kernels' library (built at the first call)."""
    out = (ctypes.c_int64 * 6)()
    with torch.cuda.device(device):
        raise_on_status(load_library().lip_sweep_geometry(out), "lip_sweep_geometry")
    v = list(out)
    if min(v[4:]) < 1:
        raise RuntimeError(f"a sweep kernel fits no block on an SM of {device}: {v}")
    return SweepGeometry(v[0], v[1], tuple(v[2:4]), tuple(v[4:6]))


def launch_sweep(V: torch.Tensor, R: torch.Tensor, scale: float,
                 plan: SweepPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """``(scale·T R, T)`` of checked CUDA operands on ``plan``'s probe group
    and split: one launch of the TF32 kernel (``T`` rounded to TF32)."""
    (P, D), d = V.shape, R.shape[0]
    rows = -(-P // plan.group) * plan.group            # the probes in whole groups
    sizes = (rows * -(-D // STRIP) * STRIP, rows * -(-d // STRIP) * STRIP, plan.splits * P * d)
    # one workspace: V's and T's operand tiles (lengths multiples of 32 floats, so
    # each starts 16-byte aligned) and the stage-1 partials
    Vt, Tt, part = torch.empty(sum(sizes), dtype=torch.float32, device=V.device).split(sizes)
    T = torch.empty((P, d), dtype=torch.float32, device=V.device)
    Y = torch.empty((P, D), dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        status = load_library().lip_ggn_sweep_tf32(
            V.data_ptr(), R.data_ptr(), Vt.data_ptr(), part.data_ptr(), T.data_ptr(),
            Tt.data_ptr(), Y.data_ptr(), P, d, D, plan.group, plan.splits, scale, stream_of(V))
    raise_on_status(status, "ggn_sweep")
    return Y, T


def _sweep(V: torch.Tensor, R: torch.Tensor, scale: float):
    """``(scale·T R, T)`` with ``T = V Rᵀ`` of checked operands: the plain
    version on the CPU, one launch of the TF32 kernel on CUDA on the plan of
    :func:`sweep_plan`. Counts nothing and records no gradient."""
    if V.device.type == "cpu":
        T = matmul_nt_plain(V, R)
        return scale * matmul_nn_plain(T, R), T
    (P, D), d = V.shape, R.shape[0]
    return launch_sweep(V, R, scale, sweep_plan(P, d, D, sweep_geometry(V.device)))


def ggn_sweep_vjp(V, R, T, scale: float, ct, need_v: bool = True, need_r: bool = True):
    """Cotangents of ``Y = scale·(V Rᵀ) R``: ``dV = scale·(Ĉ Rᵀ) R`` (the sweep
    itself) and ``dR = scale·(Tᵀ Ĉ + (Ĉ Rᵀ)ᵀ V)`` (one NT and two NN products
    over the long axis); a gradient not needed is not computed."""
    ct = ct.contiguous()
    dV = _sweep(ct, R, scale)[0] if need_v else None
    dR = None
    if need_r:
        U = nt(ct, R)                                           # Ĉ Rᵀ (P, d)
        dR = scale * (nn(T.T.contiguous(), ct) + nn(U.T.contiguous(), V))
    if ct.device.type == "cuda":
        ggn_sweep.backward_launches += int(need_v) + 3 * int(need_r)
    return dV, dR


class _GGNSweep(torch.autograd.Function):
    @staticmethod
    def forward(V, R, scale):
        Y, T = _sweep(V, R, scale)
        if V.device.type == "cuda":
            ggn_sweep.launches += 1
        return Y, T

    @staticmethod
    def setup_context(ctx, inputs, output):
        V, R, scale = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.set_materialize_grads(False)   # T has no gradient: no zeros for it
        ctx.save_for_backward(V, R, output[1])
        ctx.scale = scale

    @staticmethod
    @once_differentiable
    def backward(ctx, ct, _ct_T):
        if ct is None:
            return None, None, None
        V, R, T = ctx.saved_tensors
        need_v, need_r, _ = ctx.needs_input_grad
        return (*ggn_sweep_vjp(V, R, T, ctx.scale, ct, need_v, need_r), None)


def ggn_sweep(V: torch.Tensor, R: torch.Tensor, scale: float = 1.0, *,
              precision: Optional[str] = None) -> torch.Tensor:
    """GGN probe sweep ``scale·(V Rᵀ) R`` for probes ``V (P, D)`` and rows
    ``R (d, D)``: ``(P, D)``.

    ``precision``: ``None`` or ``"default"``, the estimator precision (the
    TF32 kernel); ``"highest"``, true FP32 through ``matmul_nt`` then
    ``matmul_nn``.
    """
    check_matrix("V", V)
    check_matrix("R", R)
    if V.device != R.device:
        raise ValueError(f"V is on {V.device} but R is on {R.device}")
    if V.shape[1] != R.shape[1]:
        raise ValueError(f"contraction mismatch: {tuple(V.shape)} x {tuple(R.shape)}ᵀ")
    if precision in (None, "default"):
        return _GGNSweep.apply(V, R, float(scale))[0]
    if precision == "highest":
        return scale * matmul_nn(matmul_nt(V, R), R)
    raise ValueError(f"unknown precision {precision!r}: use 'default' or 'highest'")


ggn_sweep.launches = ggn_sweep.backward_launches = 0
