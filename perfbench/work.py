"""Operations and bytes of the work a cell does, counted from its sizes alone,
and the least time one H100 could take for it.

Counted the same way whatever implements the work, so a later change to a
kernel's arithmetic or to the row build does not move its own yardstick:

- the long products: B1's Gram ``A A^T`` of ``A (d, D)`` counts its lower
  half, ``d (d + 1) D``; the others ``2 m n k``; a backward counts the
  products of its cotangent formulas (``dA = (C + C^T) A``; ``dB = C^T A``);
- the network: each JVP or VJP of one point counts twice that point's forward
  operations (``reference/<net>.py::forward_flops``), a forward once. The
  rows of a point are its forward and K VJPs; the pullback of the rows in Z is
  one VJP of the row build, twice its operations;
- bytes: every input read once, every output written once, float32.

The bound is ``max(flops / PEAK_FLOPS, bytes / PEAK_BYTES)``. PEAK_FLOPS is
the H100 SXM's dense TF32 tensor-core rate, the highest that any path
keeping the float32 precision contract can reach, so no share reads above
100% whichever arithmetic a kernel uses. Both rates are NVIDIA's data sheet
at the full 700 W; the run prints the card's power limit beside them.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 495e12     # H100 SXM dense TF32, FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s
F32 = 4


@dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, n: float) -> "Work":
        return Work(self.flops * n, self.bytes * n)

    def bound_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)


NONE = Work(0.0, 0.0)


def syrk(d: int, D: int) -> Work:
    """``A A^T`` of ``A (d, D)``."""
    return Work(d * (d + 1) * D, F32 * (d * D + d * d))


def syrk_backward(d: int, D: int) -> Work:
    """``dA = (C + C^T) A`` from the cotangent ``C (d, d)``."""
    return Work(2 * d * d * D, F32 * (d * d + 2 * d * D))


def matmul_nt(m: int, n: int, D: int) -> Work:
    """``A B^T`` of ``A (m, D)``, ``B (n, D)``."""
    return Work(2 * m * n * D, F32 * (m * D + n * D + m * n))


def matmul_nt_backward_b(m: int, n: int, D: int) -> Work:
    """``dB = C^T A`` of ``A B^T`` from ``C (m, n)``: ``(n, D)``."""
    return Work(2 * m * n * D, F32 * (m * n + m * D + n * D))


def matmul_nn(m: int, z: int, N: int) -> Work:
    """``A B`` of ``A (m, z)``, ``B (z, N)``."""
    return Work(2 * m * z * N, F32 * (m * z + z * N + m * N))


def gram_step_products(d_z: int, d_x: int, D: int) -> Work:
    """B1 and B2 of a gram Z step and their backwards (only ``Rz`` has a
    gradient)."""
    return (syrk(d_z, D) + matmul_nt(d_x, d_z, D) + syrk_backward(d_z, D)
            + matmul_nt_backward_b(d_x, d_z, D))


def serve_products(S: int, d: int, D: int) -> Work:
    """B2 ``eps R^T`` and B3 ``(.) R`` of one batch of S draws."""
    return matmul_nt(S, d, D) + matmul_nn(S, d, D)


def rows_flops(points: int, K: int, fwd: int) -> float:
    return points * fwd * (1 + 2 * K)


def gram_step_flops(M: int, n: int, K: int, D: int, fwd: int) -> float:
    """A gram Z step: rows of the M points and the n data points, the
    products and their backwards, the pullback of Z's rows."""
    return (rows_flops(M + n, K, fwd) + 2 * rows_flops(M, K, fwd)
            + gram_step_products(M * K, n * K, D).flops)


def serve_batch_flops(S: int, B: int, M: int, K: int, D: int, fwd: int) -> float:
    """One predictive batch: B2 and B3, the two small ``d x d`` products, the
    images' forward and the S x B push-forward JVPs."""
    d = M * K
    return (serve_products(S, d, D).flops + 2 * (2 * S * d * d)
            + B * fwd + 2 * S * B * fwd)
