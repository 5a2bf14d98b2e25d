"""Fused per-trait-weight correlation -> LOD: the CUDA kernel and its plain
version.

Replaces ``bulklmm_tpu/pallas/liteqtl_fused.py::fused_lods_per_trait`` (the
Pallas kernel ``_kernel``) with ``csrc/liteqtl_fused.cu``, a hand-written
CUDA C++ kernel for sm_90a. It computes the float32 form of
``ops/liteqtl.py::lods_per_trait`` and writes only the (p, m) LOD matrix,
so the (c+2) (p, m) products of the plain form never reach device memory.

What bounds it on an H100: about 2 (c+2) n p m float32 FMA-flops on the
CUDA cores against one 4 p m byte write. At 79 samples x 7,321 markers x
35,554 traits with c = 1 that is ~1.2e11 flops and a 1.04 GB write, so it
is bound by compute. The kernel keeps every product in registers, tiles
64 x 64 outputs per 256-thread block, and walks n in chunks through shared
memory (see the source for the design).

Layers:

- :func:`prepare_inputs`: the thin per-trait scalars (packed covariate
  Cholesky factor, zeta, masked 1/nrm2), in plain torch (the JAX wrapper's
  lines 131-159).
- :func:`liteqtl_lod_cuda`: the kernel's wrapper. CUDA tensors only; it
  checks its inputs, allocates the output, launches on the current stream,
  raises on a launch error and counts its launches in :data:`launches`.
- :func:`liteqtl_lod_plain`: the same function in plain torch.
- :func:`fused_lods_per_trait`: the kernel on CUDA tensors, its plain
  version on CPU tensors. :func:`fused_lods_per_trait_reference` always
  takes the plain version, for comparisons.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.smallchol import (
    cancel_keep_mask, fwd_subst, pair_indices, residual_sq, unrolled_cholesky,
)
from ..ops.weights import make_weights
from ..utils.config import with_highest_matmul

#: covariate columns (intercept included) the kernel is instantiated for
MAX_COVARIATES = 8

#: launches of the CUDA kernel in this process; chip_smoke.py resets and
#: reads it to show that the main path ran through the kernel
launches = 0

_F32 = torch.float32


def scalar_rows(c: int) -> int:
    """Rows of the per-trait scalar block: packed L, zeta, inv_nrm2."""
    return c * (c + 1) // 2 + c + 1


@with_highest_matmul()
def prepare_inputs(Y0, X0m, C0, lam, h2_per_trait):
    """(X, C, W, WY, scal): the kernel's float32 contiguous operands.

    X (n, p), C (n, c), W and WY (n, m), and scal (S, m) with rows
    ``[L[(i, k)] for k in range(c) for i in range(k, c)] + zeta + [inv_nrm2]``.
    Weights are formed in the inputs' dtype and then rounded, like the
    plain path's.
    """
    c = C0.shape[1]
    W = make_weights(h2_per_trait, lam).abs().T.to(_F32).contiguous()  # (n, m)
    Y = Y0.to(_F32)
    C = C0.to(_F32).contiguous()
    X = X0m.to(_F32).contiguous()
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
    ).contiguous()
    return X, C, W, WY, scal


def _check_operands(X, C, W, WY, scal):
    n, p = X.shape
    c = C.shape[1]
    m = W.shape[1]
    expected = {
        "X": (X, (n, p)), "C": (C, (n, c)), "W": (W, (n, m)),
        "WY": (WY, (n, m)), "scal": (scal, (scalar_rows(c), m)),
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
        if not t.is_contiguous():
            raise ValueError(f"liteqtl_lod_cuda: {name} must be contiguous")
    if not 1 <= c <= MAX_COVARIATES:
        raise ValueError(
            f"liteqtl_lod_cuda: {c} covariate columns (intercept included); the "
            f"kernel is instantiated for 1 to {MAX_COVARIATES} "
            '(ROADMAP.md "Still to port" item 5)'
        )
    return n, p, m, c


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load_library

    lib = load_library()
    fn = lib.bulklmm_liteqtl_lod
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bulklmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bulklmm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def liteqtl_lod_cuda(X, C, W, WY, scal) -> torch.Tensor:
    """(p, m) float32 LOD from the kernel's operands, on their CUDA device.

    Raises on a CPU tensor, a wrong dtype, shape or layout, more than
    :data:`MAX_COVARIATES` covariate columns, a failed build or a launch
    error. Does not synchronize.
    """
    global launches
    n, p, m, c = _check_operands(X, C, W, WY, scal)
    lib = _library()
    out = torch.empty((p, m), dtype=_F32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bulklmm_liteqtl_lod(
            X.data_ptr(), C.data_ptr(), W.data_ptr(), WY.data_ptr(),
            scal.data_ptr(), out.data_ptr(), n, p, m, c, stream,
        )
    if rc != 0:
        raise RuntimeError(
            "liteqtl_lod kernel launch failed: "
            + lib.bulklmm_cuda_error_string(rc).decode()
        )
    launches += 1
    return out


@with_highest_matmul()
def liteqtl_lod_plain(X, C, W, WY, scal) -> torch.Tensor:
    """The kernel's function in plain torch, on any device (float32)."""
    n, c = C.shape
    B = X.T @ WY
    D1 = (X * X).T @ W
    U = [(X * C[:, k : k + 1]).T @ W for k in range(c)]
    rows = iter(scal)
    Lc = {(i, k): next(rows) for k in range(c) for i in range(k, c)}
    zeta = [next(rows) for _ in range(c)]
    inv_nrm2 = next(rows)

    Z = fwd_subst(Lc, U, c)
    N, D = B, D1
    for k in range(c):
        N = N - Z[k] * zeta[k]
        D = D - Z[k] * Z[k]
    eps = torch.finfo(_F32).eps
    keep = D > 1024.0 * eps * D1
    D = torch.maximum(D, 4.0 * eps * D1)
    # where keep is False, r2 = 0 exactly (an all-zero marker has D = 0)
    r2 = torch.where(keep, N * N * inv_nrm2 / D, 0.0)
    one_minus = torch.clamp(1.0 - r2, min=torch.finfo(_F32).tiny)
    return (-0.5 * n) * torch.log10(one_minus)


def fused_lods_per_trait(Y0, X0m, C0, lam, h2_per_trait) -> torch.Tensor:
    """(p, m) float32 LOD with per-trait h2: the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors."""
    ops = prepare_inputs(Y0, X0m, C0, lam, h2_per_trait)
    if ops[0].is_cuda:
        return liteqtl_lod_cuda(*ops)
    return liteqtl_lod_plain(*ops)


def fused_lods_per_trait_reference(Y0, X0m, C0, lam, h2_per_trait) -> torch.Tensor:
    """:func:`fused_lods_per_trait` through the plain version on any device."""
    return liteqtl_lod_plain(*prepare_inputs(Y0, X0m, C0, lam, h2_per_trait))
