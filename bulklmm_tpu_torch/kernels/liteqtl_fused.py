"""Fused per-trait-weight correlation -> LOD: the CUDA kernels and their plain
version.

Replaces ``bulklmm_tpu/pallas/liteqtl_fused.py::fused_lods_per_trait`` (the
Pallas kernel ``_kernel``) with ``csrc/liteqtl_fused.cu``, hand-written CUDA
C++ for sm_90a. It computes the float32 form of
``ops/liteqtl.py::lods_per_trait`` and writes only the (p, m) LOD matrix,
so the (c+2) (p, m) products of the plain form never reach device memory.

What bounds it on an H100: 2 (c+2) n p m float32-grade flops against one
4 p m byte write. At 79 samples x 7,321 markers x 35,554 traits with c = 1
that is 1.23e11 flops and a 1.04 GB write, so it is bound by operations.
Three kernels, picked by :func:`kernel_path` from n and c (the launcher in
the source applies the same rule), all of them taking the products on the
tensor cores as three TF32 passes (``csrc/mma_tf32x3.cuh``), float32-grade
but not bit-equal to the plain version's products: the resident kernel
(n <= 88, c <= 3; ``csrc/liteqtl_resident.cuh``) keeps the traits' operands
in shared memory and copies the marker tiles asynchronously, and its
epilogue takes reciprocals and the hardware's log2 where the plain version
divides and calls log10; the general kernel (c <= 3 at any n, taken for
n > 88; ``csrc/liteqtl_general.cuh``) walks the samples in chunks of
:data:`CHUNK_SAMPLES` through a ring of asynchronous copies
(``csrc/liteqtl_chunked.cuh``) and, past 200 samples, float32 running
totals in device memory that the wrapper allocates, with the exact
epilogue; the wide kernel
(any c > 3, ``csrc/liteqtl_wide.cuh``) runs the same chunked walk on
operands whose covariates are already whitened per trait, V = W (C L^{-T})
(c, n, m), formed here in the inputs' dtype, so that it holds the same five
accumulator sets a thread for any c and needs no substitution (see the
sources for the designs).

Under ``dot_precision="high"`` (THROUGHPUT) each of the three kernels takes
its products as three bf16 passes instead (bf16x3, ``csrc/mma_bf16x3.cuh``,
the JAX package's HIGH), an instantiation of its own
(:func:`kernel_route` names the products that run): the general and wide
kernels walk the samples in chunks of :data:`BF16_CHUNK_SAMPLES` then, with
no running totals (:func:`fold_chunks`). The plain versions split the same
way the JAX package does: on the CPU the LOD step's plain version keeps
float32 products under "high", as ``ops/liteqtl.py::lods_per_trait`` at
HIGH computes in XLA on a CPU, and :func:`liteqtl_bf16x3_reference` (the
resident kernel) and :func:`liteqtl_bf16x3_chunked_reference` (the general
and wide kernels) are the bf16x3 kernels' plain versions, which
``chip_smoke.py`` holds them against on the card. ``dot_precision`` is
"highest" or "high"; any other name raises.

The effects variant of both kernels (``effects=True``; the path of
``bulkscan(output_effects=True)`` under the float32 presets) writes, from
the same products and the same residualization, the marker's effect and its
standard error beside the LOD, as ``ops/liteqtl.py::_effects_from_nd``
defines them: three (p, m) outputs, so at the shape above its bound is the
3.1 GB write. Its LODs are those of the LOD-only kernel.

Layers:

- :func:`prepare_inputs`: the thin per-trait scalars (packed covariate
  Cholesky factor, zeta, masked 1/nrm2, and nrm2 for the effects variant),
  in plain torch (the JAX wrapper's lines 131-159), and X with rows that
  start at multiples of 16 bytes; for the wide kernel V in the place of C
  and a scalar block without the factor.
- :func:`liteqtl_lod_cuda`: the kernels' wrapper. CUDA tensors only; it
  checks its inputs, allocates the outputs, launches on the current stream,
  raises on a launch error and counts each launch under its route
  (``utils/profiling.py::count_launch``).
- :func:`liteqtl_lod_plain`: the same function in plain torch, exact
  float32, on either form of the operands (the wide one walks V a column
  at a time, as the wide kernel does). :func:`liteqtl_split_reference`
  repeats the resident kernel's 3 x TF32 arithmetic instead
  (``kernels/split.py``), and :func:`liteqtl_chunked_reference` the
  general and wide kernels' (the same split, the samples in chunks of 40,
  each run of :data:`FOLD_CHUNKS` chunks summed and added into a running
  total), for comparisons; :func:`liteqtl_bf16x3_reference` the resident
  kernel's under "high", :func:`liteqtl_bf16x3_chunked_reference` the
  general and wide kernels'.
- :func:`fused_lods_per_trait` and :func:`fused_lods_and_effects_per_trait`:
  the kernel on CUDA tensors, its plain version on CPU tensors.
  :func:`fused_lods_per_trait_reference` always takes the plain version on
  the general kernel's operands (the packed factor and the substitution, as
  the TPU kernel computes), for comparisons.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.smallchol import (
    cancel_keep_mask, fwd_subst, off_covariates, pair_indices, residual_sq, unrolled_cholesky,
)
from ..ops.weights import make_weights
from ..utils.config import with_highest_matmul
from ..utils.profiling import count_launch, span, spanned
from .split import (
    matmul_bf16x3, matmul_bf16x3_emulated, matmul_tf32x3_emulated, rows_at_16_bytes, uses_bf16x3,
)

#: covariate columns (intercept included) the general kernel is instantiated
#: for ((c + 2) accumulator sets of 32 registers a thread); the wide kernel
#: takes any more
GENERAL_COVARIATES = 3

#: samples a chunk of the general and wide kernels' walk under 3 x TF32
#: (``Chunking<tf32x3::Policy>::kChunk`` in ``csrc/liteqtl_chunked.cuh``):
#: five depth steps of 8
CHUNK_SAMPLES = 40

#: the same under bf16x3 ("high"): two depth steps of 16, as far as the wide
#: kernel's shared memory allows
BF16_CHUNK_SAMPLES = 32

#: chunks that the general and wide kernels add into one product set before
#: adding the set into its float32 running total past 200 samples
#: (kFoldChunks); up to 200 samples they add it after every chunk
#: (:func:`fold_chunks`); under bf16x3 they never fold
FOLD_CHUNKS = 5


def chunk_samples(dot_precision: str = "highest") -> int:
    """Samples a chunk of the general and wide kernels' walk under the
    products that ``dot_precision`` names."""
    return BF16_CHUNK_SAMPLES if uses_bf16x3(dot_precision) else CHUNK_SAMPLES


def walk_samples(n: int, dot_precision: str = "highest") -> int:
    """Samples that the general and wide kernels walk for n: n up to a whole
    chunk, the samples past n zeros (BXD's 79: 80 under 3 x TF32, 96 under
    bf16x3)."""
    chunk = chunk_samples(dot_precision)
    return -(-n // chunk) * chunk


def fold_chunks(n: int, dot_precision: str = "highest") -> int | None:
    """Chunks that the general and wide kernels carry in a product set
    before they add it into its running total, for n samples
    (``fold_chunks()`` in ``csrc/liteqtl_chunked.cuh``); None under bf16x3,
    whose sets never join running totals (``kFoldChunks`` 0): their folds
    cost 1.16-1.72x the time for an accuracy far inside THROUGHPUT's bar
    (PERF.md)."""
    if uses_bf16x3(dot_precision):
        return None
    return FOLD_CHUNKS if n > FOLD_CHUNKS * CHUNK_SAMPLES else 1

#: covariate columns the resident kernel is instantiated for: it keeps
#: (c + 2) accumulator sets of 32 registers a thread
RESIDENT_COVARIATES = 3

#: the most depth steps of 8 samples the resident kernel is built for (its
#: limit under either products; bf16x3 steps are 16 samples, 6 of them)
RESIDENT_STEPS = 11

#: (covariate columns, most depth steps) of the resident 3 x TF32 effects
#: instantiations that add their leading terms straight into their sets: a
#: scratch set for them spilled there (:func:`lead_runs`)
DIRECT_LEAD_EFFECTS = (3, 2)


def lead_runs(c: int, steps: int, effects: bool) -> bool:
    """Whether the resident 3 x TF32 kernel for c covariate columns and
    ``steps`` depth steps takes its leading terms a depth step at a time
    into a scratch set, each step added into its set rounded to nearest,
    rather than straight into its sets (``lead_runs()`` in
    ``csrc/liteqtl_resident.cuh``; ``chip_smoke.py`` holds the two
    together over every instantiation that ptxas reports)."""
    return not (effects and c == DIRECT_LEAD_EFFECTS[0] and steps <= DIRECT_LEAD_EFFECTS[1])

#: shared memory a block can use on sm_90, bytes
SHARED_LIMIT_BYTES = 232_448

#: markers a tile and traits a block of both kernels
TILE_P = TILE_M = 64

_F32 = torch.float32


def scalar_rows(c: int, effects: bool = False, *, wide: bool = False) -> int:
    """Rows of the per-trait scalar block: packed L, zeta, inv_nrm2, and
    nrm2 for the effects variant; the wide kernel's has no packed L."""
    return (0 if wide else c * (c + 1) // 2) + c + 1 + int(effects)


def resident_steps(n: int, dot_precision: str = "highest") -> int:
    """Depth steps that the resident kernel runs for n: of 8 samples, even
    counts up to 10, then 11; under "high" (bf16x3) of 16 samples, any count
    from 2 (the kernel is built for each count; the rows between n and the
    steps are zeros in shared memory)."""
    if uses_bf16x3(dot_precision):
        return max(2, -(-n // 16))
    steps = -(-n // 8)
    return steps if steps > 10 else steps + steps % 2


def resident_shared_bytes(n: int, c: int, effects: bool = False,
                          dot_precision: str = "highest") -> int:
    """Shared memory of a block of the resident kernel: both halves of its
    (depth, 64) tiles of W and WY (4 bytes a value as TF32, 2 as bf16), for
    each of its two warpgroups two stages of 64 markers (rows 8 floats
    longer than the tile) and one finished 64 x 64 tile (rows 4 floats
    longer), the covariates and the scalar block."""
    bf16 = uses_bf16x3(dot_precision)
    depth = (16 if bf16 else 8) * resident_steps(n, dot_precision)
    per_group = 2 * depth * (TILE_P + 8) + TILE_P * (TILE_M + 4)
    operands = 4 * depth * TILE_M // (2 if bf16 else 1)
    return 4 * (operands + 2 * per_group + c * depth + scalar_rows(c, effects) * TILE_M)


def kernel_path(n: int, c: int, effects: bool = False) -> str:
    """"resident" where the traits' operands fit shared memory and the
    (c + 2) accumulator sets fit the registers (n <= 88, c <= 3). "wide" for
    more than :data:`GENERAL_COVARIATES` covariate columns, at any n: the
    whitened operands. Else "general": the samples in chunks. All three take
    3 x TF32 warpgroup products, or bf16x3 under "high", on the same path
    (:func:`kernel_route`). The effects variant's scalar block is one
    row longer; it fits wherever the LOD-only kernel does. The launcher in
    ``csrc/liteqtl_fused.cu`` applies the same rule
    (``bulklmm_liteqtl_path``, :func:`launcher_path`)."""
    if c > GENERAL_COVARIATES:
        return "wide"
    fits = (
        1 <= c <= RESIDENT_COVARIATES
        and resident_steps(n) <= RESIDENT_STEPS
        and resident_shared_bytes(n, c, effects) <= SHARED_LIMIT_BYTES
    )
    return "resident" if fits else "general"


def kernel_route(n: int, c: int, effects: bool = False,
                 dot_precision: str = "highest") -> tuple[str, str]:
    """``(kernel_path(n, c, effects), products)``: the kernel that a launch
    takes (the same under both products) and the products that run in it,
    "bf16x3" on every path under ``dot_precision="high"``, else "tf32x3"."""
    return kernel_path(n, c, effects), "bf16x3" if uses_bf16x3(dot_precision) else "tf32x3"


def _descending(lam) -> bool:
    """Whether the eigenvalues fall from first to last, as the svd scheme
    gives them (``ops/rotation.py::kinship_eigen``); one synchronization on
    a CUDA device.

    The products add the rotated samples in their order, and the largest
    eigenvalue's direction carries the mean of the markers and of the
    intercept, terms an order of magnitude above the rest: added first, they
    make every later term round at their magnitude. :func:`prepare_inputs`
    then reverses the samples, which the LOD does not depend on (BALANCED
    null-grid at 79 x 512 x 64 on the CPU, against EXACT64: 4.1e-5 in LOD in
    the svd order, 6.2e-6 reversed)."""
    if lam.numel() < 2:
        return False
    with span("bulklmm.sync.scalar"):
        return bool(((lam[1:] <= lam[:-1]).all() & (lam[0] > lam[-1])).item())


def _marker_operand(X0m):
    """X0m as float32, contiguous, or where p is no multiple of 4 the first
    p columns of a zero-padded (n, p + pad) array."""
    n, p = X0m.shape
    if p % 4:
        X = X0m.new_zeros((n, p + -p % 4), dtype=_F32)[:, :p]
        X.copy_(X0m)
        return X
    return X0m.to(_F32).contiguous()


@spanned("bulklmm.prep.inputs")
@with_highest_matmul()
def prepare_inputs(Y0, X0m, C0, lam, h2_per_trait, *, effects: bool = False,
                   path: str | None = None):
    """(X, C, W, WY, scal): the float32 operands of the kernel that ``path``
    names (default: :func:`kernel_path`'s for the shape).

    X (n, p) holds the markers off the covariates' span
    (``ops/smallchol.py::off_covariates``, in X0m's dtype), C (n, c), W and
    WY (n, m), and scal (S, m) with rows
    ``[L[(i, k)] for k in range(c) for i in range(k, c)] + zeta + [inv_nrm2]``,
    and ``[nrm2]`` after them for the effects variant; for "wide" C is V
    (c, n, m) and scal has no L rows (:func:`_prepare_wide`).
    All are contiguous but X where p is no multiple of 4: it is then the
    first p columns of a zero-padded (n, p + pad) array, so that its rows
    start at multiples of 16 bytes as the resident kernel's copies need and
    the wrapper has nothing to copy. Weights are formed in the inputs' dtype
    and then rounded, like the plain path's. Samples whose eigenvalues fall
    (the svd scheme) are taken in reverse order (:func:`_descending`).
    """
    n, c = X0m.shape[0], C0.shape[1]
    if _descending(lam):
        Y0, X0m, C0, lam = Y0.flip(0), X0m.flip(0), C0.flip(0), lam.flip(0)
    X0m = off_covariates(X0m, C0)
    if (path or kernel_path(n, c, effects)) == "wide":
        return _prepare_wide(Y0, X0m, C0, lam, h2_per_trait, effects)
    W = make_weights(h2_per_trait, lam).abs().T.to(_F32).contiguous()  # (n, m)
    Y = Y0.to(_F32)
    C = C0.to(_F32).contiguous()
    X = _marker_operand(X0m)
    WY = (W * Y).contiguous()

    t = C.T @ WY  # (c, m)
    pairs = pair_indices(c)
    CC = torch.stack([C[:, k] * C[:, l] for k, l in pairs], dim=1)
    Gv = CC.T @ W  # (npair, m)
    Lc = unrolled_cholesky({kl: Gv[i] for i, kl in enumerate(pairs)}, c)
    zeta = fwd_subst(Lc, [t[k] for k in range(c)], c)
    yty = (WY * Y).sum(0)
    nrm2 = residual_sq(yty, zeta)
    # fully covariate-explained traits get inv_nrm2 = 0, hence r2 = 0
    inv_nrm2 = cancel_keep_mask(nrm2, yty) / torch.clamp(nrm2, min=torch.finfo(_F32).tiny)
    scal = torch.stack(
        [Lc[(i, k)] for k in range(c) for i in range(k, c)] + zeta + [inv_nrm2]
        + ([nrm2] if effects else [])
    ).contiguous()
    return X, C, W, WY, scal


def _prepare_wide(Y0, X0m, C0, lam, h2_per_trait, effects):
    """The wide kernel's operands (X, V, W, WY, scal).

    With L_j the Cholesky factor of C^T diag(w_j) C, the trait's covariates
    whitened, C L_j^{-T}, are W-orthonormal, and V[k, :, j] = w_j (C
    L_j^{-T})[:, k], so that the substitution Z = L^{-1} U becomes the
    products Z_k = X^T V_k. V, zeta = V^T y, nrm2 and its keep mask are
    formed in the inputs' dtype (float64 under BALANCED) by one batched
    Cholesky factorization and triangular solve over the traits, then
    rounded; the mask keeps float32's eps, since the products that meet
    these scalars are float32. scal rows: zeta (c), inv_nrm2, and nrm2 for
    the effects variant. X, W and WY are the general kernel's."""
    n, c = C0.shape
    sd = torch.promote_types(torch.promote_types(Y0.dtype, C0.dtype), torch.float32)
    Wd = make_weights(h2_per_trait.to(sd), lam.to(sd)).abs().T  # (n, m)
    m = Wd.shape[1]
    W = Wd.to(_F32).contiguous()
    WY = (W * Y0.to(_F32)).contiguous()
    C = C0.to(sd)
    with span("bulklmm.prep.whiten"):
        gram = ((C[:, :, None] * C[:, None, :]).reshape(n, c * c).T @ Wd).T.reshape(m, c, c)
        with span("bulklmm.sync.cholesky"):  # on a card it waits for its error check
            chol = torch.linalg.cholesky(gram)
        whitened_t = torch.linalg.solve_triangular(chol, C.T.expand(m, c, n), upper=False)
        del gram, chol
        V = whitened_t.permute(1, 2, 0) * Wd  # (c, n, m)
        del whitened_t
    Y = Y0.to(sd)
    zeta = (V * Y).sum(1)  # (c, m)
    yty = (Wd * Y * Y).sum(0)
    nrm2 = residual_sq(yty, list(zeta))
    inv_nrm2 = cancel_keep_mask(nrm2, yty, eps=torch.finfo(_F32).eps) / torch.clamp(
        nrm2, min=torch.finfo(_F32).tiny)
    scal = torch.cat([zeta, inv_nrm2[None]] + ([nrm2[None]] if effects else []))
    return _marker_operand(X0m), V.to(_F32).contiguous(), W, WY, scal.to(_F32).contiguous()


def _check_operands(X, C, W, WY, scal, effects):
    n, p = X.shape
    wide = C.dim() == 3
    c = C.shape[0] if wide else C.shape[1]
    m = W.shape[1]
    expected = {
        "X": (X, (n, p)), "C": (C, (c, n, m) if wide else (n, c)), "W": (W, (n, m)),
        "WY": (WY, (n, m)), "scal": (scal, (scalar_rows(c, effects, wide=wide), m)),
    }
    for name, (t, shape) in expected.items():
        if not t.is_cuda:
            raise ValueError(f"liteqtl_lod_cuda: {name} lies on {t.device}, not on a CUDA device")
        if t.device != X.device:
            raise ValueError(f"liteqtl_lod_cuda: {name} lies on {t.device}, X on {X.device}")
        if t.dtype != _F32:
            raise TypeError(f"liteqtl_lod_cuda: {name} is {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"liteqtl_lod_cuda: {name} has shape {tuple(t.shape)}, expected {shape}")
        # X may be the first p columns of an array with longer rows
        if not (t.is_contiguous() or (t is X and p > 0 and X.stride(1) == 1 and X.stride(0) >= p)):
            raise ValueError(f"liteqtl_lod_cuda: {name} must be contiguous")
    if wide != (kernel_path(n, c, effects) == "wide"):
        raise ValueError(
            f"liteqtl_lod_cuda: {c} covariate columns take the "
            f"{kernel_path(n, c, effects)} kernel, whose operands prepare_inputs gives"
        )
    if wide and n <= c + 1:
        raise ValueError(f"liteqtl_lod_cuda: n = {n} samples leave no residual degree of "
                         f"freedom beside {c} covariate columns")
    return n, p, m, c


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load_library

    lib = load_library()
    fn = lib.bulklmm_liteqtl_lod
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 7, *[ctypes.c_int] * 6,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.bulklmm_liteqtl_totals.argtypes = [*[ctypes.c_int] * 5, ctypes.POINTER(ctypes.c_int)]
    lib.bulklmm_liteqtl_totals.restype = ctypes.c_longlong
    lib.bulklmm_liteqtl_path.argtypes = [ctypes.c_int] * 3
    lib.bulklmm_liteqtl_path.restype = ctypes.c_int
    lib.bulklmm_liteqtl_lead_runs.argtypes = [ctypes.c_int] * 3
    lib.bulklmm_liteqtl_lead_runs.restype = ctypes.c_int
    lib.bulklmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bulklmm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launcher_path(n: int, c: int, effects: bool = False) -> str:
    """The kernel that the launcher takes for the shape, by its own rule
    (builds the library; :func:`kernel_path` states the same rule without
    it)."""
    return ("general", "resident", "wide")[_library().bulklmm_liteqtl_path(n, c, int(effects))]


def _totals_floats(lib, n: int, c: int, effects: bool, general: bool, bf16: bool) -> int:
    """Floats of the running totals that a launch at n samples and c columns
    with the products ``bf16`` names needs on the current device (0 where
    its walks do not fold)."""
    err = ctypes.c_int(0)
    floats = lib.bulklmm_liteqtl_totals(n, c, int(effects), int(general), int(bf16),
                                        ctypes.byref(err))
    if floats < 0:
        raise RuntimeError("liteqtl_lod kernel: sizing its running totals failed: "
                           + lib.bulklmm_cuda_error_string(err.value).decode())
    return floats


def liteqtl_lod_cuda(X, C, W, WY, scal, *, general: bool = False, effects: bool = False,
                     dot_precision: str = "highest"):
    """(p, m) float32 LOD from the kernel's operands, on their CUDA device;
    with ``effects=True`` (the effects variant, whose ``scal`` has the nrm2
    row) the tuple (LOD, effect, standard error).

    Takes the kernel that :func:`kernel_path` names for the shape, on the
    operands :func:`prepare_inputs` gives for it; ``general=True`` takes the
    general kernel whatever n is, up to :data:`GENERAL_COVARIATES` columns
    (for comparisons at a resident shape). ``dot_precision="high"`` takes
    the kernel's bf16x3 instantiation, on every path (:func:`kernel_route`).
    A launch counts under "liteqtl_lod" or "liteqtl_lod_effects", its path
    and its products. Raises on a CPU tensor, a wrong dtype, shape or
    layout, operands of another kernel, an unknown ``dot_precision``, a
    failed build or a launch error. Does not synchronize.
    """
    bf16 = uses_bf16x3(dot_precision)
    n, p, m, c = _check_operands(X, C, W, WY, scal, effects)
    if general and c > GENERAL_COVARIATES:
        raise ValueError(f"liteqtl_lod_cuda: the general kernel is instantiated for at most "
                         f"{GENERAL_COVARIATES} covariate columns, not {c}")
    lib = _library()
    outs = [torch.empty((p, m), dtype=_F32, device=X.device) for _ in range(3 if effects else 1)]
    beta_ptr, se_ptr = (outs[1].data_ptr(), outs[2].data_ptr()) if effects else (None, None)
    with torch.cuda.device(X.device):
        # every kernel copies X in 16-byte pieces
        if X.stride(0) % 4 or X.data_ptr() % 16:
            X = rows_at_16_bytes(X.contiguous())
        stream = torch.cuda.current_stream().cuda_stream
        # a walk of more than one chunk keeps running totals in device memory
        floats = _totals_floats(lib, n, c, effects, general, bf16)
        totals = torch.zeros(floats, dtype=_F32, device=X.device) if floats else None
        rc = lib.bulklmm_liteqtl_lod(
            X.data_ptr(), X.stride(0), C.data_ptr(), W.data_ptr(), WY.data_ptr(),
            scal.data_ptr(), outs[0].data_ptr(), beta_ptr, se_ptr, n, p, m, c, int(general),
            int(bf16), None if totals is None else totals.data_ptr(), floats, stream,
        )
    if rc != 0:
        raise RuntimeError(
            "liteqtl_lod kernel launch failed: "
            + lib.bulklmm_cuda_error_string(rc).decode()
        )
    path, products = kernel_route(n, c, effects, dot_precision)
    count_launch("liteqtl_lod_effects" if effects else "liteqtl_lod",
                 "general" if general else path, products)
    return tuple(outs) if effects else outs[0]


def _lod_from_products(B, D1, U, scal, n: int, effects: bool = False):
    """The kernels' epilogue in plain torch, from the (p, m) products:
    forward substitution, then :func:`_lod_from_residualized`."""
    c = len(U)
    rows = iter(scal)
    Lc = {(i, k): next(rows) for k in range(c) for i in range(k, c)}
    zeta = [next(rows) for _ in range(c)]
    Z = fwd_subst(Lc, U, c)
    N, D = B, D1
    for k in range(c):
        N = N - Z[k] * zeta[k]
        D = D - Z[k] * Z[k]
    return _lod_from_residualized(N, D, D1, list(rows), n, c, effects)


def _lod_from_residualized(N, D, D1, rest, n: int, c: int, effects: bool):
    """The cancel-keep mask and floor, r2 and the LOD from the residualized
    N and D (``rest``: the scalar block's inv_nrm2 row, and nrm2 for the
    effects variant); with ``effects`` also the marker's effect and its
    standard error, ``ops/liteqtl.py::_effects_from_nd`` on the same N and D
    (N masked by both keep tests, the trait's being inv_nrm2 > 0; D at least
    FLT_MIN)."""
    rows = iter(rest)
    inv_nrm2 = next(rows)
    eps = torch.finfo(_F32).eps
    tiny = torch.finfo(_F32).tiny
    keep = D > 1024.0 * eps * D1
    D = torch.maximum(D, 4.0 * eps * D1)
    # where keep is False, r2 = 0 exactly (an all-zero marker has D = 0)
    r2 = torch.where(keep, N * N * inv_nrm2 / D, 0.0)
    one_minus = torch.clamp(1.0 - r2, min=tiny)
    lod = (-0.5 * n) * torch.log10(one_minus)
    if not effects:
        return lod
    nrm2 = next(rows)
    Nk = torch.where(keep & (inv_nrm2 > 0), N, 0.0)
    Dt = torch.clamp(D, min=tiny)
    dof = float(max(n - c - 1, 1))
    rss = torch.clamp(nrm2 - Nk * Nk / Dt, min=0.0)
    return lod, Nk / Dt, torch.sqrt(rss / dof / Dt)


def _lod_with_product(X, C, W, WY, scal, product, effects=False):
    B = product(X.T, WY)
    D1 = product((X * X).T, W)
    if C.dim() == 3:
        # the wide kernel's operands: one Z_k at a time, subtracted as the
        # kernel subtracts it (c (p, m) products never live at once)
        c, n, _ = C.shape
        N, D = B, D1
        for k in range(c):
            Z = product(X.T, C[k])
            N = N - Z * scal[k]
            D = D - Z * Z
        return _lod_from_residualized(N, D, D1, scal[c:], n, c, effects)
    n, c = C.shape
    U = [product((X * C[:, k : k + 1]).T, W) for k in range(c)]
    return _lod_from_products(B, D1, U, scal, n, effects)


@with_highest_matmul()
def liteqtl_lod_plain(X, C, W, WY, scal, *, effects: bool = False):
    """The kernel's function in plain torch, on any device: exact float32
    products, on the operands of whichever kernel :func:`prepare_inputs`
    gave (the wide kernel's walk V a column at a time). ``effects`` as for
    :func:`liteqtl_lod_cuda`."""
    return _lod_with_product(X, C, W, WY, scal, torch.matmul, effects)


def liteqtl_split_reference(X, C, W, WY, scal, *, effects: bool = False):
    """The kernel's function with the resident kernel's arithmetic: X, X * X
    and X * C_k (or V_k) rounded to float32, then each product as three TF32
    passes in the resident kernel's order, summed as its tensor cores sum
    them (``split.py::matmul_tf32x3_emulated``: the small terms of every
    depth step first, then the leading terms a step at a time, each step
    added into the total rounded to nearest, or straight into the total
    where that instantiation of the kernel takes them so:
    :func:`lead_runs`). On any device; no main path takes it."""
    n, c = X.shape[0], C.shape[0] if C.dim() == 3 else C.shape[1]
    run = 1 if lead_runs(c, resident_steps(n), effects) else None

    def product(A, B):
        return matmul_tf32x3_emulated(A, B, smalls_first=True, run=run)

    return _lod_with_product(X, C, W, WY, scal, product, effects)


def liteqtl_bf16x3_reference(X, C, W, WY, scal, *, effects: bool = False):
    """The kernel's function with the resident kernel's arithmetic under
    ``dot_precision="high"``: the operands rounded as
    :func:`liteqtl_split_reference` rounds them, then each product as three
    bf16 passes (``split.py::matmul_bf16x3``). The plain version that the
    bf16x3 kernel is held against on the card; on any device."""
    return _lod_with_product(X, C, W, WY, scal, matmul_bf16x3, effects)


def liteqtl_chunked_reference(X, C, W, WY, scal, *, effects: bool = False):
    """The kernel's function with the general and wide kernels' arithmetic:
    the operands rounded as :func:`liteqtl_split_reference` rounds them, the
    samples in chunks of :data:`CHUNK_SAMPLES`, each chunk's three TF32
    passes added to one float32 sum as the tensor cores add them, its small
    terms first, and that sum added into a running total every
    :func:`fold_chunks` chunks (``split.py::matmul_tf32x3_emulated``). On
    either operand form and any device; no main path takes it."""
    def product(A, B):
        return matmul_tf32x3_emulated(A, B, chunk=CHUNK_SAMPLES, run=fold_chunks(A.shape[-1]))

    return _lod_with_product(X, C, W, WY, scal, product, effects)


def liteqtl_bf16x3_chunked_reference(X, C, W, WY, scal, *, effects: bool = False):
    """The kernel's function with the general and wide kernels' arithmetic
    under ``dot_precision="high"``: the operands rounded as
    :func:`liteqtl_split_reference` rounds them, the samples in chunks of
    :data:`BF16_CHUNK_SAMPLES`, each chunk's three bf16 passes (lo x hi,
    hi x lo, hi x hi) added to one float32 sum as the tensor cores add bf16
    products, over the whole walk in one accumulator
    (``split.py::matmul_bf16x3_emulated``). The plain version that the
    bf16x3 general and wide kernels are held against on the card; on either
    operand form and any device."""
    def product(A, B):
        return matmul_bf16x3_emulated(A, B, chunk=BF16_CHUNK_SAMPLES)

    return _lod_with_product(X, C, W, WY, scal, product, effects)


def fused_lods_per_trait(Y0, X0m, C0, lam, h2_per_trait,
                         dot_precision: str = "highest") -> torch.Tensor:
    """(p, m) float32 LOD with per-trait h2: the CUDA kernel on CUDA tensors
    (``dot_precision`` as :func:`liteqtl_lod_cuda` takes it), its plain
    version on CPU tensors (float32 products under either name)."""
    uses_bf16x3(dot_precision)
    ops = prepare_inputs(Y0, X0m, C0, lam, h2_per_trait)
    if ops[0].is_cuda:
        return liteqtl_lod_cuda(*ops, dot_precision=dot_precision)
    return liteqtl_lod_plain(*ops)


def fused_lods_and_effects_per_trait(Y0, X0m, C0, lam, h2_per_trait,
                                     dot_precision: str = "highest"):
    """(LOD, effect, standard error), each (p, m) float32, with per-trait h2:
    the effects variant of the CUDA kernel on CUDA tensors, its plain version
    on CPU tensors; ``dot_precision`` as for :func:`fused_lods_per_trait`."""
    uses_bf16x3(dot_precision)
    ops = prepare_inputs(Y0, X0m, C0, lam, h2_per_trait, effects=True)
    if ops[0].is_cuda:
        return liteqtl_lod_cuda(*ops, effects=True, dot_precision=dot_precision)
    return liteqtl_lod_plain(*ops, effects=True)


def fused_lods_per_trait_reference(Y0, X0m, C0, lam, h2_per_trait,
                                   dot_precision: str = "highest") -> torch.Tensor:
    """:func:`fused_lods_per_trait` through the plain version on any device,
    on the general kernel's operands at any c: the packed factor and the
    forward substitution, as the TPU kernel computes. Float32 products
    under either ``dot_precision``, as the CPU path takes them
    (:func:`liteqtl_bf16x3_reference` is the bf16x3 kernel's)."""
    uses_bf16x3(dot_precision)
    return liteqtl_lod_plain(*prepare_inputs(Y0, X0m, C0, lam, h2_per_trait, path="general"))
