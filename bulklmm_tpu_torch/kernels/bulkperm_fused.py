"""Fused bulk-permutation maxima: the CUDA kernel and its plain version.

Replaces ``bulklmm_tpu/pallas/bulkperm_fused.py::fused_perm_maxlods`` (the
Pallas kernel ``_kernel``) with ``csrc/bulkperm_fused.cu``, a hand-written
CUDA C++ kernel for sm_90a. For every trait t of a block and every
permutation k it computes

    out[t, k] = max over markers i of (sum_s X[s, i] S2[t, s, k])^2 inv_xn[t, i]

the genome-wide maximum squared correlation, without the (traits x markers x
permutations) tensor ever reaching device memory (at 79 samples x 7,321
markers x 35,554 traits x 1,001 columns it would be ~1 TB). The monotone
LOD transform runs outside (``ops/bulkperm.py::maxr2_to_lod``).

What bounds it on an H100: 2 n p mb K float32-grade flops (4.1e13 over all
35,554 traits) against reading S2 (4 mb n K bytes) and inv_xn once;
operations by two orders of magnitude. The kernel takes the product on the
tensor cores as three TF32 passes (``csrc/mma_tf32x3.cuh``), which is
float32-grade but not bit-equal to the plain version's product. Under
``dot_precision="high"`` (THROUGHPUT) both of its paths take three bf16
passes instead (bf16x3, ``csrc/mma_bf16x3.cuh``), the TPU kernel's HIGH
branch, and the plain version takes the same split
(``split.py::matmul_bf16x3``) on any device, as the Pallas kernel emulates
bf16x3 in interpret mode. ``dot_precision`` is "highest" or "high"; any other
name raises.

Layers:

- :func:`prepare_trait_block`: the permutation-independent ``inv_xn``
  (mb, p) of a trait block, once per block.
- :func:`prepare_chunk_inputs`: ``S2`` (mb, n, Kc) of one (trait block,
  permutation chunk): the shuffled unit residuals, residualized against each
  trait's weighted-covariate orthobasis and folded with its sqrt-weights,
  ``sw_t * (I - Q_t^T Q_t) S_t`` (the projector moved from the marker side by
  self-adjointness, so the kernel runs one product per trait).
- :func:`bulkperm_maxr2_cuda`: the kernel's wrapper. CUDA tensors only; it
  checks its inputs, allocates the output (zeros on the chunked path, whose
  marker groups take their maxima into it), launches on the current stream,
  raises on a launch error and counts each launch under its route
  (``utils/profiling.py::count_launch``; a chunked launch whose marker walk
  was split across blocks under the path "chunked_split").
- :func:`bulkperm_maxr2_plain`: the same function in plain torch, exact
  float32 (bf16x3 under "high"). :func:`bulkperm_maxr2_split_reference`
  repeats the kernel's 3 x TF32 arithmetic instead (``kernels/split.py``),
  for comparisons: on the chunked path the samples in chunks of
  :data:`CHUNK_SAMPLES`, each chunk's three passes one after another, and
  every run of :data:`FOLD_CHUNKS` chunks added into float32 running totals
  rounded to nearest, as the kernel's warpgroup products take them.
- :func:`kernel_path`: whether the trait's operand stays in shared memory
  for the launch, from n; :func:`kernel_route` names the products beside
  it; :func:`marker_groups` is the chunked launch's split of the marker
  walk across blocks (``bulklmm_bulkperm_marker_groups`` in the kernel's
  library states the same rule for the current device).
- :func:`fused_perm_maxlods`: max LODs through the kernel on CUDA tensors,
  through its plain version on CPU tensors.
  :func:`fused_perm_maxlods_reference` always takes the plain version (the
  counterpart of the Pallas interpret mode, and the comparison's yardstick).

The kernel's operands must be finite: its running max drops a NaN where
``torch.max`` would carry it. ``inv_xn`` is made finite here, and S2 is
finite whenever the traits are (the entry point's finiteness guard).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.bulkperm import maxr2_to_lod, perm_trait_marker_parts
from ..utils.config import with_highest_matmul
from ..utils.profiling import count_launch, spanned
from .split import matmul_bf16x3, matmul_tf32x3_emulated, rows_at_16_bytes, uses_bf16x3

#: permutations per thread block of the kernel
TILE_K = 256

#: shared memory a block can use on sm_90, bytes
SHARED_LIMIT_BYTES = 232_448

#: the most depth steps of 8 samples the resident kernel is built for
RESIDENT_STEPS = 11

#: markers and permutations of a thread block of the chunked kernel (n > 88)
CHUNK_TILE = 128

#: samples of one chunk of the chunked kernel's walk over n
CHUNK_SAMPLES = 32

#: chunks whose products the chunked kernel carries in one accumulator
#: before adding them into float32 running totals rounded to nearest
FOLD_CHUNKS = 2

#: blocks an SM that the chunked kernel's marker groups aim at
MARKER_WAVES = 8

#: the plain version's (traits, p, K) numerator stays under this many bytes
PLAIN_BUDGET_BYTES = 1024**3

_F32 = torch.float32


@spanned("bulklmm.prep.inputs")
def prepare_trait_block(X0m, sqrtw_blk, Qblk, *, precision):
    """``inv_xn`` (mb, p) float32: ``1 / |(I - P_t)(x_i * sw_t)|^2`` from
    ``ops/bulkperm.py::perm_trait_marker_parts``, 0 where the marker is
    masked (``xn = +inf`` there) or where ``1 / xn`` is not finite."""
    _, xns = perm_trait_marker_parts(X0m, sqrtw_blk, Qblk, precision=precision)
    inv = (1.0 / xns).to(_F32)
    return torch.where(torch.isfinite(inv), inv, torch.zeros_like(inv)).contiguous()


@spanned("bulklmm.prep.inputs")
@with_highest_matmul()
def prepare_chunk_inputs(sqrtw_blk, Qblk, wrn_blk, idx_blk):
    """``S2`` (mb, n, Kc) float32 contiguous, from ``sqrtw_blk`` (mb, n),
    ``Qblk`` (mb, c, n), ``wrn_blk`` (n, mb) and ``idx_blk`` (Kc, n). The
    gathered block is residualized and scaled in place."""
    # St[t, s, k] = wrn_blk[idx_blk[k, s], t], gathered in the kernel's layout
    St = wrn_blk.T.to(_F32).contiguous()[:, idx_blk.T].contiguous()
    Q = Qblk.to(_F32)
    St -= Q.mT @ (Q @ St)
    return St.mul_(sqrtw_blk.to(_F32)[:, :, None])


def _check_operands(X0m, S2, inv_xn):
    if X0m.ndim != 2 or S2.ndim != 3:
        raise ValueError("bulkperm_maxr2_cuda: X0m must be (n, p) and S2 (mb, n, K)")
    n, p = X0m.shape
    mb, _, K = S2.shape
    expected = {"X0m": (X0m, (n, p)), "S2": (S2, (mb, n, K)), "inv_xn": (inv_xn, (mb, p))}
    for name, (t, shape) in expected.items():
        if not t.is_cuda:
            raise ValueError(f"bulkperm_maxr2_cuda: {name} lies on {t.device}, not on a CUDA device")
        if t.device != X0m.device:
            raise ValueError(f"bulkperm_maxr2_cuda: {name} lies on {t.device}, X0m on {X0m.device}")
        if t.dtype != _F32:
            raise TypeError(f"bulkperm_maxr2_cuda: {name} is {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"bulkperm_maxr2_cuda: {name} has shape {tuple(t.shape)}, expected {shape}"
            )
        if not t.is_contiguous():
            raise ValueError(f"bulkperm_maxr2_cuda: {name} must be contiguous")
    if min(n, p, mb, K) == 0 or max(p, K, mb * n, mb * -(-K // TILE_K)) >= 2**31:
        raise ValueError(
            "bulkperm_maxr2_cuda: the kernel takes non-empty samples, markers, "
            "traits and permutations, markers and permutations below 2^31 and "
            "traits x samples and traits x permutation tiles below 2^31; got "
            f"n={n}, p={p}, mb={mb}, K={K}"
        )
    return n, p, mb, K


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load_library

    lib = load_library()
    fn = lib.bulklmm_bulkperm_maxr2
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 5, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.bulklmm_bulkperm_is_resident.argtypes = [ctypes.c_int]
    lib.bulklmm_bulkperm_is_resident.restype = ctypes.c_int
    lib.bulklmm_bulkperm_marker_groups.argtypes = [ctypes.c_int] * 4
    lib.bulklmm_bulkperm_marker_groups.restype = ctypes.c_int
    lib.bulklmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bulklmm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def padded_depth(n: int, dot_precision: str = "highest") -> int:
    """n rounded up to the depth of one tensor-core step, 8 samples (3 x
    TF32) or 16 (bf16x3, "high"); the padding rows are zeros in shared
    memory."""
    step = 16 if uses_bf16x3(dot_precision) else 8
    return -(-n // step) * step


def resident_shared_bytes(n: int, dot_precision: str = "highest") -> int:
    """Shared memory of a block that keeps its trait's operand resident:
    both halves of the (padded n, 256) tile, 4 bytes a value as TF32 and 2
    as bf16, and two stages of 64 markers and a row of inv_xn, their rows 8
    floats longer than the tile."""
    depth = padded_depth(n, dot_precision)
    value_bytes = 2 if uses_bf16x3(dot_precision) else 4
    return 2 * depth * TILE_K * value_bytes + 4 * 2 * (depth + 1) * (64 + 8)


def kernel_path(n: int) -> str:
    """"resident" where the trait's operand fits shared memory beside the
    marker stages (n <= 88): asynchronous warpgroup products on it. Else
    "chunked": the kernel walks n in staged chunks of :data:`CHUNK_SAMPLES`
    samples. The launcher in ``csrc/bulkperm_fused.cu`` applies the same rule
    (``bulklmm_bulkperm_is_resident``)."""
    fits = padded_depth(n) <= 8 * RESIDENT_STEPS and resident_shared_bytes(n) <= SHARED_LIMIT_BYTES
    return "resident" if fits else "chunked"


def kernel_route(n: int, dot_precision: str = "highest") -> tuple[str, str]:
    """``(kernel_path(n), products)``: the path that a launch at n samples
    takes (the same for both products) and its products, "tf32x3" or, under
    ``dot_precision="high"``, "bf16x3" (both paths have them)."""
    return kernel_path(n), "bf16x3" if uses_bf16x3(dot_precision) else "tf32x3"


def marker_groups(n: int, p: int, mb: int, K: int, sms: int) -> int:
    """The blocks that share one (trait, 128-permutation tile)'s marker walk
    in a launch at n samples, p markers, mb traits and K permutations on a
    card of ``sms`` SMs: 1 on the resident path; on the chunked path as
    many as give about :data:`MARKER_WAVES` blocks an SM where the (trait,
    permutation tile) pairs alone do not, each an equal run of 128-marker
    tiles and none empty. ``csrc/bulkperm_fused.cu``'s launcher takes the
    same rule (``bulklmm_bulkperm_marker_groups``, for the current device)."""
    if kernel_path(n) == "resident":
        return 1
    pairs = mb * -(-K // CHUNK_TILE)
    ptiles = -(-p // CHUNK_TILE)
    groups = min(max(-(-MARKER_WAVES * sms // pairs), 1), ptiles)
    group_tiles = -(-ptiles // groups)
    return -(-ptiles // group_tiles)


def bulkperm_maxr2_cuda(X0m, S2, inv_xn, *, dot_precision: str = "highest"):
    """(mb, K) float32 max r^2 from the kernel's operands, on their CUDA
    device: ``X0m`` (n, p), ``S2`` (mb, n, K), ``inv_xn`` (mb, p), all
    float32 and contiguous. The products are three TF32 passes, or three
    bf16 passes under ``dot_precision="high"``.

    A launch counts under "bulkperm_maxr2", its path (:func:`kernel_route`;
    "chunked_split" where :func:`marker_groups` is above 1) and its
    products. Raises on a CPU tensor, a wrong dtype, shape or layout, an
    unknown ``dot_precision``, a failed build or a launch error. Does not
    synchronize.
    """
    bf16 = uses_bf16x3(dot_precision)
    n, p, mb, K = _check_operands(X0m, S2, inv_xn)
    lib = _library()
    path, products = kernel_route(n, dot_precision)
    chunked = path == "chunked"
    out = (torch.zeros if chunked else torch.empty)((mb, K), dtype=_F32, device=X0m.device)
    with torch.cuda.device(X0m.device):
        groups = lib.bulklmm_bulkperm_marker_groups(n, p, mb, K)
        Xa = rows_at_16_bytes(X0m)
        # the chunked path copies S2's rows from 16-byte boundaries
        S2 = S2 if S2.data_ptr() % 16 == 0 else S2.clone()
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bulklmm_bulkperm_maxr2(
            Xa.data_ptr(), Xa.shape[-1], S2.data_ptr(), inv_xn.data_ptr(), out.data_ptr(),
            n, p, mb, K, int(bf16), stream,
        )
    if groups < 1 or rc != 0:
        raise RuntimeError(
            "bulkperm kernel launch failed: "
            + lib.bulklmm_cuda_error_string(rc if rc else -groups).decode()
        )
    count_launch("bulkperm_maxr2", "chunked_split" if groups > 1 else path, products)
    return out


def _maxr2_by_blocks(X0m, S2, inv_xn, product):
    """max over markers of ``product(X0m.T, S2)^2 inv_xn``, over sub-blocks of
    traits sized so that the (traits, p, K) numerator stays under
    :data:`PLAIN_BUDGET_BYTES`."""
    mb, _, K = S2.shape
    p = X0m.shape[1]
    step = max(1, PLAIN_BUDGET_BYTES // (4 * p * K))
    Xt = X0m.T.contiguous()
    out = torch.empty((mb, K), dtype=S2.dtype, device=S2.device)
    for s in range(0, mb, step):
        num = product(Xt, S2[s : s + step])  # (traits, p, K)
        r2 = num.square_().mul_(inv_xn[s : s + step, :, None])
        out[s : s + step] = r2.max(1).values
    return out


@with_highest_matmul()
def bulkperm_maxr2_plain(X0m, S2, inv_xn, *, dot_precision: str = "highest"):
    """The kernel's function in plain torch, on any device: exact float32
    products, or under ``dot_precision="high"`` the kernel's bf16x3 products
    (``split.py::matmul_bf16x3``)."""
    product = matmul_bf16x3 if uses_bf16x3(dot_precision) else torch.matmul
    return _maxr2_by_blocks(X0m, S2, inv_xn, product)


def bulkperm_maxr2_split_reference(X0m, S2, inv_xn):
    """The kernel's function with the kernel's arithmetic: the product as
    three TF32 passes summed as the kernel's tensor cores sum them
    (``split.py::matmul_tf32x3_emulated``), in the order of the path that n
    takes: the resident path's small terms of every depth step first and
    its leading terms after them, all in one accumulator; the chunked
    path's samples in chunks of :data:`CHUNK_SAMPLES`, each chunk's three
    passes one after another over its depth steps, every run of
    :data:`FOLD_CHUNKS` chunks in one accumulator that starts from zero and
    is then added into the total rounded to nearest. On any device; no main
    path takes it."""
    if kernel_path(X0m.shape[0]) == "resident":
        def product(A, B):
            return matmul_tf32x3_emulated(A, B, smalls_first=True)
    else:
        def product(A, B):
            return matmul_tf32x3_emulated(A, B, chunk=CHUNK_SAMPLES, run=FOLD_CHUNKS)

    return _maxr2_by_blocks(X0m, S2, inv_xn, product)


def fused_perm_maxlods(X0m, S2, inv_xn, *, n: int, dot_precision: str = "highest"):
    """(mb, K) float32 genome-wide max LODs of a trait block: the CUDA kernel
    on CUDA tensors, its plain version on CPU tensors, both with
    ``dot_precision``'s products. ``n`` is the sample count of the LOD
    factor."""
    run = bulkperm_maxr2_cuda if S2.is_cuda else bulkperm_maxr2_plain
    return maxr2_to_lod(run(X0m, S2, inv_xn, dot_precision=dot_precision), n)


def fused_perm_maxlods_reference(X0m, S2, inv_xn, *, n: int, dot_precision: str = "highest"):
    """:func:`fused_perm_maxlods` through the plain version on any device."""
    return maxr2_to_lod(bulkperm_maxr2_plain(X0m, S2, inv_xn, dot_precision=dot_precision), n)
