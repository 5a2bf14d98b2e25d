"""The kernels' split products in plain torch: the CPU twins of
``csrc/mma_tf32x3.cuh`` (3 x TF32) and ``csrc/mma_bf16x3.cuh`` (bf16x3).

The CUDA kernels take their float32 products on the tensor cores as three
TF32 passes: every operand is written as ``big + small``, both rounded to
TF32's 10 mantissa bits, and ``a * b`` is taken as
``small_a * big_b + big_a * small_b + big_a * big_b`` with float32
accumulation. This module repeats that arithmetic with float32 tensors on
any device, so the split's accuracy is testable without a card and
``chip_smoke.py`` can hold each kernel against it as a second yardstick. No
main path calls it: the plain versions of the kernels stay exact float32.

The sums are taken in another order than the kernels take them (three whole
products here, depth-8 steps there), so a kernel agrees with its split
reference to float32 rounding, not bit for bit.

Under the THROUGHPUT preset's "high" products the kernels take bf16x3
instead: every operand is written as ``hi + lo``, both rounded to bfloat16
(8 significant bits, round to nearest, ties to even), and ``a * b`` is taken
as ``lo_a * hi_b + hi_a * lo_b + hi_a * hi_b`` (the JAX package's HIGH, which
its Pallas kernels split by hand). :func:`matmul_bf16x3` is that arithmetic,
and the plain version of the alt-grid and permutation kernels under "high"
on any device; the LOD step's on the card (``liteqtl_bf16x3_reference``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.config import check_gemm_precision, with_highest_matmul

_LOW_BITS = 13  # float32's 23 mantissa bits less TF32's 10
_HALF = 1 << (_LOW_BITS - 1)
_KEEP = -(1 << _LOW_BITS)  # int32 mask of the sign, the exponent and 10 mantissa bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 and held as float32: the 13 low
    mantissa bits are zero. Round to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: half a unit is added to the magnitude's bit
    pattern and the low bits are cut. Infinities stay as they are."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + _HALF) & _KEEP).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``(big, small)`` with ``big = tf32_round(x)`` and
    ``small = tf32_round(x - big)``; ``big + small`` restores ``x`` within
    2^-21 |x|."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


@with_highest_matmul()
def matmul_tf32x3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` (float32, batched as ``torch.matmul``) as the three float32
    products of the operands' TF32 halves, the small terms first. Each
    elementwise product of two halves is exact in float32; only the sums
    round."""
    A_big, A_small = tf32_split(A)
    B_big, B_small = tf32_split(B)
    return (A_small @ B_big + A_big @ B_small) + A_big @ B_big


@with_highest_matmul()
def matmul_tf32x3_chunked(A: torch.Tensor, B: torch.Tensor, chunk: int, *,
                          fold: int | None = None) -> torch.Tensor:
    """``A @ B`` as the chunked LOD kernels take it: the contraction in
    chunks of ``chunk``, each chunk's three products of the TF32 halves added
    one after another to one float32 sum, the small terms first (A small x
    B big, A big x B small) and the leading term after them. With ``fold``,
    that sum starts again from zero every ``fold`` chunks and each finished
    sum is added into a float32 running total, as the kernels fold their
    accumulators (``csrc/liteqtl_chunked.cuh``); without it one sum runs
    across every chunk."""
    A_big, A_small = tf32_split(A)
    B_big, B_small = tf32_split(B)
    depth = A.shape[-1]
    run = depth if fold is None else chunk * fold
    total = None
    for r0 in range(0, depth, run):
        part = None
        for k0 in range(r0, min(r0 + run, depth), chunk):
            a_big, a_small = A_big[..., k0 : k0 + chunk], A_small[..., k0 : k0 + chunk]
            b_big, b_small = B_big[..., k0 : k0 + chunk, :], B_small[..., k0 : k0 + chunk, :]
            for a, b in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
                part = a @ b if part is None else part + a @ b
        total = part if total is None else total + part
    return total


@with_highest_matmul()
def matmul_tf32x1(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The leading term alone: what one TF32 pass gives. For comparisons."""
    return tf32_round(A) @ tf32_round(B)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to bfloat16 and held as float32: round to
    nearest, ties to even, as ``cvt.rn.bf16x2.f32`` and JAX's
    ``astype(bfloat16)`` round; subnormals, zeros and infinities keep their
    class."""
    if x.dtype != torch.float32:
        raise TypeError(f"bf16_round takes float32, got {x.dtype}")
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_split(x: torch.Tensor):
    """``(hi, lo)`` with ``hi = bf16_round(x)`` and ``lo = bf16_round(x -
    hi)``; ``hi + lo`` restores ``x`` within 2^-16 |x|."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


@with_highest_matmul()
def matmul_bf16x3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` (float32, batched as ``torch.matmul``) as the three float32
    products of the operands' bf16 halves, the small terms first, as the
    kernels accumulate them; the ``lo * lo`` term is dropped. Each
    elementwise product of two halves is exact in float32; only the sums
    round."""
    A_hi, A_lo = bf16_split(A)
    B_hi, B_lo = bf16_split(B)
    return (A_lo @ B_hi + A_hi @ B_lo) + A_hi @ B_hi


def uses_bf16x3(dot_precision: str) -> bool:
    """Whether a kernel's products are bf16x3 (``"high"``) rather than three
    TF32 passes (``"highest"``); any other name raises."""
    return check_gemm_precision(dot_precision) == "high"


def rows_at_16_bytes(X: torch.Tensor) -> torch.Tensor:
    """``X`` (contiguous float32) with every row of its last axis starting at
    a multiple of 16 bytes, as the kernels' 16-byte asynchronous copies need:
    ``X`` itself where its row length is a multiple of 4 and its storage is
    aligned, else a copy whose rows are padded with zeros to the next
    multiple of 4. The kernels take the row length as the rows' stride."""
    pad = -X.shape[-1] % 4
    if pad == 0 and X.data_ptr() % 16 == 0:
        return X
    return F.pad(X, (0, pad)) if pad else X.clone()
