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

The tensor cores do not sum as float32 on the CUDA cores does: they cut
(csrc/accumulate_probe.cu; :data:`TENSOR_CORE_SUM`). :func:`tensor_core_sum`
is that sum and :func:`matmul_tf32x3_emulated` a kernel's whole product
under it, in the kernel's order of depth steps, passes and runs: the
kernels' split references, so that a kernel agrees with its split
reference but for the epilogue's arithmetic. :func:`matmul_tf32x3` keeps
round-to-nearest sums (three whole products), for comparisons: what the
3 x TF32 products give without the tensor cores' cuts.

Under the THROUGHPUT preset's "high" products the kernels take bf16x3
instead: every operand is written as ``hi + lo``, both rounded to bfloat16
(8 significant bits, round to nearest, ties to even), and ``a * b`` is taken
as ``lo_a * hi_b + hi_a * lo_b + hi_a * hi_b`` (the JAX package's HIGH, which
its Pallas kernels split by hand). :func:`matmul_bf16x3` is that arithmetic,
and the plain version of the alt-grid and permutation kernels under "high"
on any device; the LOD step's resident kernel's on the card
(``liteqtl_bf16x3_reference``). :func:`matmul_bf16x3_emulated` takes it in
the chunked LOD kernels' order and sums as the tensor cores sum bf16
products (:data:`BF16_TENSOR_CORE_SUM`): their plain version on the card
(``liteqtl_bf16x3_chunked_reference``).
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


def round_to_float32(s: torch.Tensor, mode: str) -> torch.Tensor:
    """``s`` (float64) as float32, rounded to nearest even (``"rn"``) or cut
    toward zero (``"rz"``)."""
    y = s.to(torch.float32)
    if mode == "rn":
        return y
    if mode != "rz":
        raise ValueError(f"round_to_float32: mode is 'rn' or 'rz', got {mode!r}")
    over = y.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def tensor_core_sum(acc: torch.Tensor, prods: torch.Tensor, *, extra: int, addend: str,
                    finish: str, group: int) -> torch.Tensor:
    """A model of one tensor-core product's float32 sum: ``acc`` (float32,
    any shape) plus the exact products ``prods`` (float64, the same shape
    and one more axis, the depth), ``group`` products at a time in depth
    order. Each group and the running value are aligned to the largest
    exponent among them and every addend is cut to ``extra`` bits below
    float32's last place there (``addend``: "rz" toward zero, "rd" toward
    minus infinity, as a two's complement cut), the cut addends are summed
    exactly, and the sum is made float32 by ``finish`` ("rz" or "rn"). The
    probe (``kernels/accumulate_probe.py``) finds which parameters the card
    follows; float64 holds every step exactly for ``extra`` up to 24."""
    if not 0 <= extra <= 24:
        raise ValueError(f"tensor_core_sum: extra is 0 to 24 bits, got {extra}")
    out = acc.double()
    depth = prods.shape[-1]
    for k0 in range(0, depth, group):
        terms = torch.cat([out[..., None], prods[..., k0 : k0 + group]], -1)
        _, exp = torch.frexp(terms)
        exp = torch.where(terms == 0, torch.iinfo(exp.dtype).min, exp)
        top = exp.max(-1, keepdim=True).values.clamp(min=-900)
        quantum = torch.ldexp(torch.ones_like(terms[..., :1]), top - 24 - extra)
        scaled = terms / quantum
        cut = torch.trunc(scaled) if addend == "rz" else torch.floor(scaled)
        out = round_to_float32((cut.sum(-1, keepdim=True) * quantum)[..., 0], finish).double()
    return out.to(torch.float32)


#: How the card's tensor cores finish a float32 sum, as the probe found it
#: on an H100 for mma.sync m16n8k8 and wgmma m64n64k8 alike
#: (``kernels/accumulate_probe.py``, chip_smoke.py's phase 2b): the eight
#: products of a step and the accumulator aligned to the largest of them,
#: every addend cut toward zero 2 bits below float32's last place there, the
#: sum cut toward zero to float32 (:func:`tensor_core_sum`'s parameters)
TENSOR_CORE_SUM = dict(extra=2, addend="rz", finish="rz", group=8)
STEP = 8  # samples of one TF32 depth step (mma.sync m16n8k8, wgmma m64nNk8)
#: How the card's tensor cores finish a float32 sum of bf16 products, as the
#: probe found it on an H100 for mma.sync m16n8k16 and wgmma m64n64k16 alike
#: (chip_smoke.py's phase 2b)
BF16_TENSOR_CORE_SUM = dict(extra=2, addend="rz", finish="rz", group=16)
BF16_STEP = 16  # samples of one bf16 depth step (mma.sync m16n8k16, wgmma m64nNk16)
#: float64 elements of the expanded products of one block of rows
_BLOCK_ELEMENTS = 1 << 25


def _tensor_core_step(acc, a, b, model=TENSOR_CORE_SUM):
    """``acc + a @ b`` as the tensor cores take one product of one depth
    step (``model``: :data:`TENSOR_CORE_SUM`, or :data:`BF16_TENSOR_CORE_SUM`
    for bf16 halves): ``a`` (..., M, k) and ``b`` (..., k, N) hold TF32 (or
    bf16) values, so every elementwise product is exact in float64; ``acc``
    is float32 of the product's shape, or None for zero. Rows of ``a`` in
    blocks, so that the (..., M, N, k) products stay under
    :data:`_BLOCK_ELEMENTS`."""
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-1])
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    rows = max(1, _BLOCK_ELEMENTS // max(1, out[..., :1, :].numel() * a.shape[-1]))
    bt = b.double().mT[..., None, :, :]  # (..., 1, N, k)
    for r0 in range(0, shape[-2], rows):
        prods = a[..., r0 : r0 + rows, None, :].double() * bt  # (..., rows, N, k)
        part = (torch.zeros(prods.shape[:-1], dtype=torch.float32, device=a.device)
                if acc is None else acc[..., r0 : r0 + rows, :])
        out[..., r0 : r0 + rows, :] = tensor_core_sum(part, prods, **model)
    return out


@with_highest_matmul()
def matmul_tf32x3_emulated(A: torch.Tensor, B: torch.Tensor, *, chunk: int = STEP,
                           run: int | None = None, smalls_first: bool = False) -> torch.Tensor:
    """``A @ B`` (float32, batched as ``torch.matmul``) as the kernels take it
    on the tensor cores: the three products of the TF32 halves (A small x B
    big, A big x B small, A big x B big) in depth steps of :data:`STEP`,
    each step's products added into a float32 accumulator as the tensor
    cores add them (:func:`_tensor_core_step`, bit for bit as the probe
    found them). The kernels' split references are this function in their
    kernel's order:

    - the depth in chunks of ``chunk`` samples, each chunk's three passes
      one after another over its steps (:data:`STEP`: a step's three
      products together);
    - ``run`` chunks into one accumulator that starts from zero, and every
      finished run added into a float32 total rounded to nearest (None: one
      accumulator for the whole depth);
    - ``smalls_first``: the small terms of every step first, into the
      total, and then the leading terms in runs (the resident kernels' two
      passes over the depth).
    """
    A_big, A_small = tf32_split(A)
    B_big, B_small = tf32_split(B)
    chunks = _chunk_steps(A.shape[-1], chunk, STEP)
    total = None
    passes = [(A_small, B_big), (A_big, B_small), (A_big, B_big)]
    if smalls_first:
        for s in (s for chunk_steps in chunks for s in chunk_steps):
            for a, b in passes[:2]:
                total = _tensor_core_step(total, a[..., s], b[..., s, :])
        passes = passes[2:]
    return _runs(total, chunks, passes, run, TENSOR_CORE_SUM)


def _runs(total, chunks, passes, run, model):
    """``total`` plus the passes over the chunks' depth steps (each chunk's
    passes one after another), ``run`` chunks into one accumulator that
    starts from zero and is then added into the float32 total rounded to
    nearest (None: one accumulator from ``total`` over the whole depth)."""
    every = len(chunks) if run is None else run
    for r0 in range(0, len(chunks), every):
        part = total if run is None else None
        for chunk_steps in chunks[r0 : r0 + every]:
            for a, b in passes:
                for s in chunk_steps:
                    part = _tensor_core_step(part, a[..., s], b[..., s, :], model)
        total = part if run is None or total is None else total + part
    return total


def _chunk_steps(depth: int, chunk: int, step: int):
    """The depth's chunks of ``chunk`` samples, each a list of its steps of
    ``step`` samples (slices; the last ones cut at the depth)."""
    return [[slice(k, min(k + step, c0 + chunk, depth))
             for k in range(c0, min(c0 + chunk, depth), step)]
            for c0 in range(0, depth, chunk)]


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


@with_highest_matmul()
def matmul_bf16x3_emulated(A: torch.Tensor, B: torch.Tensor, *, chunk: int = BF16_STEP,
                           run: int | None = None) -> torch.Tensor:
    """``A @ B`` (float32, batched as ``torch.matmul``) as the chunked LOD
    kernels take it under "high" (``csrc/liteqtl_chunked.cuh`` on
    ``bf16x3::Policy``): the three products of the bf16 halves (A lo x B hi,
    A hi x B lo, A hi x B hi) in depth steps of :data:`BF16_STEP`, the depth
    in chunks of ``chunk`` samples whose three passes follow one another
    over the chunk's steps, each step's products added into a float32
    accumulator as the tensor cores add bf16 products
    (:data:`BF16_TENSOR_CORE_SUM`), ``run`` chunks into one accumulator
    added into a float32 total rounded to nearest (None: one accumulator
    for the whole depth), as :func:`matmul_tf32x3_emulated` takes its TF32
    halves. The ``lo * lo`` term is dropped, as in :func:`matmul_bf16x3`."""
    A_hi, A_lo = bf16_split(A)
    B_hi, B_lo = bf16_split(B)
    chunks = _chunk_steps(A.shape[-1], chunk, BF16_STEP)
    passes = [(A_lo, B_hi), (A_hi, B_lo), (A_hi, B_hi)]
    return _runs(None, chunks, passes, run, BF16_TENSOR_CORE_SUM)


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
