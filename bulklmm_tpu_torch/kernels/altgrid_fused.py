"""Fused alt-grid scan: the CUDA kernel and its plain version.

Replaces ``bulklmm_tpu/pallas/altgrid_fused.py::fused_alt_grid`` (the Pallas
kernel ``_kernel``) with ``csrc/altgrid_fused.cu``, a hand-written CUDA C++
kernel for sm_90a. For every (marker, trait) pair it finds the h2 grid step
that maximizes the alternative log-likelihood and writes the (p, m) LOD and,
optionally, that step's index. The plain formulation
(``models/bulkscan.py::_alt_grid_impl``) round-trips (p, m) running-max and
argmax carries through device memory on every grid step; the kernel keeps
them in registers and writes once.

Maximizing ``logL1_k = -(n/2) ln(1 - r_k^2) + ell0_k`` over k is minimizing
``u_k = (1 - r_k^2) exp(-(2/n)(ell0_k - max_k ell0_k))``, so the (g, m)
trait factors ``cmat`` are formed once outside and the loop needs no log:
``LOD = -(n/2) log10(min_k u_k)``.

What bounds it on an H100: 2 n p m g float32-grade flops against one 4 p m
byte write of L (and of the index). At 79 samples x 7,321 markers x 35,554
traits and the default 10-point grid that is ~4.1e11 flops. The kernel takes
the product on the tensor cores as three TF32 passes
(``csrc/mma_tf32x3.cuh``), which is float32-grade but not bit-equal to the
plain version's product. Under ``dot_precision="high"`` (THROUGHPUT) it takes
three bf16 passes instead (bf16x3, ``csrc/mma_bf16x3.cuh``), the TPU
kernel's HIGH branch, and the plain version takes the same split
(``split.py::matmul_bf16x3``) on any device, as the Pallas kernel emulates
bf16x3 in interpret mode. ``dot_precision`` is "highest" or "high"; any other
name raises.

Layers:

- :func:`prepare_inputs`: per grid step, the sqrt-weighted, covariate-
  residualized, masked and normalized markers and traits, and the trait
  factors (the JAX wrapper's lines 215-242, taken further: the kernel's
  body is then a pure contraction plus the epilogue).
- :func:`altgrid_cuda`: the kernel's wrapper. CUDA tensors only; it checks
  its inputs, allocates the outputs, launches on the current stream, raises
  on a launch error and counts each launch under its route
  (``utils/profiling.py::count_launch``).
- :func:`altgrid_plain`: the same function in plain torch, one (p, n)(n, m)
  product and the epilogue per grid step, exact float32 (bf16x3 under
  "high").
  :func:`altgrid_split_reference` repeats the kernel's 3 x TF32 arithmetic
  instead, its tensor cores' sums included (``kernels/split.py``), for
  comparisons.
- :func:`fused_alt_grid`: the kernel on CUDA tensors, its plain version on
  CPU tensors. :func:`fused_alt_grid_reference` always takes the plain
  version, for comparisons.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.smallchol import residual_keep_mask
from ..ops.weights import make_weights
from ..utils.config import with_highest_matmul
from ..utils.profiling import count_launch, span, spanned
from .split import matmul_bf16x3, matmul_tf32x3_emulated, rows_at_16_bytes, uses_bf16x3

#: the most markers one launch takes: 65,535 blocks of 128 markers on the
#: launch grid's y axis (the trait axis has no practical limit)
MAX_MARKERS = 65535 * 128

_F32 = torch.float32
_TINY = torch.finfo(_F32).tiny


@spanned("bulklmm.prep.inputs")
@with_highest_matmul()
def prepare_inputs(Y0, X0m, C0, lam, h2_grid, *, prior, reml=False):
    """(Xn, Yn, cmat): the kernel's float32 contiguous operands.

    Xn (g, n, p) and Yn (g, n, m): for grid step k, the columns of X0m and
    Y0 scaled by ``S_k = sqrt|w_k|``, with the orthobasis ``Q_k`` of
    ``S_k * C0`` projected out, masked where the residual is rounding noise
    (float32 eps, as the kernel's dtype) and normalized to unit length.
    cmat (g, m) = ``exp(-(2/n)(ells - max ells))`` from the (g, m) null
    log-likelihoods. Everything is formed in the inputs' dtype and then
    rounded to float32.
    """
    from ..models.bulkscan import grid_null_ell

    n = Y0.shape[0]
    with span("bulklmm.prep.null_fit"):
        ells = grid_null_ell(Y0, C0, lam, h2_grid, prior, reml=reml)  # (g, m)
    cmat = torch.exp(-(2.0 / n) * (ells - ells.max(0).values))

    S = torch.sqrt(make_weights(h2_grid, lam).abs())  # (g, n)
    Q = torch.linalg.qr(C0[None] * S[:, :, None], mode="reduced")[0]  # (g, n, c)
    eps32 = torch.finfo(_F32).eps

    def residualize_normalize(M):
        Mw = S[:, :, None] * M[None]  # (g, n, cols)
        Mr = Mw - Q @ (Q.mT @ Mw)
        nrm2 = (Mr * Mr).sum(1, keepdim=True)
        keep = residual_keep_mask(nrm2, (Mw * Mw).sum(1, keepdim=True), eps=eps32)
        return ((Mr * keep) / torch.sqrt(torch.clamp(nrm2, min=_TINY))).to(_F32).contiguous()

    return residualize_normalize(X0m), residualize_normalize(Y0), cmat.to(_F32).contiguous()


def _check_operands(Xn, Yn, cmat):
    if Xn.ndim != 3 or Yn.ndim != 3:
        raise ValueError("altgrid_cuda: Xn and Yn must be (g, n, p) and (g, n, m)")
    g, n, p = Xn.shape
    m = Yn.shape[2]
    expected = {"Xn": (Xn, (g, n, p)), "Yn": (Yn, (g, n, m)), "cmat": (cmat, (g, m))}
    for name, (t, shape) in expected.items():
        if not t.is_cuda:
            raise ValueError(f"altgrid_cuda: {name} lies on {t.device}, not on a CUDA device")
        if t.device != Xn.device:
            raise ValueError(f"altgrid_cuda: {name} lies on {t.device}, Xn on {Xn.device}")
        if t.dtype != _F32:
            raise TypeError(f"altgrid_cuda: {name} is {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"altgrid_cuda: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"altgrid_cuda: {name} must be contiguous")
    if min(g, n, p, m) == 0 or p > MAX_MARKERS or max(g * n, m) >= 2**31:
        raise ValueError(
            f"altgrid_cuda: the kernel takes 1 to {MAX_MARKERS} markers, a "
            "non-empty grid, samples and traits, and grid steps x samples and "
            f"traits below 2^31; got g={g}, n={n}, p={p}, m={m}"
        )
    return g, n, p, m


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load_library

    lib = load_library()
    fn = lib.bulklmm_altgrid
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 5, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.bulklmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bulklmm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def altgrid_cuda(Xn, Yn, cmat, *, panel: bool = True, dot_precision: str = "highest"):
    """(L, kidx) from the kernel's operands, on their CUDA device: L (p, m)
    float32 and kidx (p, m) int32, the first grid step of the minimum, or
    None when ``panel`` is False (the kernel then carries no index). The
    products are three TF32 passes, or three bf16 passes under
    ``dot_precision="high"``. A launch counts under "altgrid", the path
    "fused" and its products.

    Raises on a CPU tensor, a wrong dtype, shape or layout, an unknown
    ``dot_precision``, a failed build or a launch error. Does not
    synchronize.
    """
    bf16 = uses_bf16x3(dot_precision)
    g, n, p, m = _check_operands(Xn, Yn, cmat)
    lib = _library()
    out = torch.empty((p, m), dtype=_F32, device=Xn.device)
    kidx = torch.empty((p, m), dtype=torch.int32, device=Xn.device) if panel else None
    with torch.cuda.device(Xn.device):
        Xa, Ya = rows_at_16_bytes(Xn), rows_at_16_bytes(Yn)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bulklmm_altgrid(
            Xa.data_ptr(), Xa.shape[-1], Ya.data_ptr(), Ya.shape[-1], cmat.data_ptr(),
            out.data_ptr(), kidx.data_ptr() if panel else None, g, n, p, m, int(bf16), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "altgrid kernel launch failed: " + lib.bulklmm_cuda_error_string(rc).decode()
        )
    count_launch("altgrid", "fused", "bf16x3" if bf16 else "tf32x3")
    return out, kidx


def _min_over_grid(Xn, Yn, cmat, panel, product):
    """(L, kidx) with the per-step correlations from ``product``."""
    g, n, _ = Xn.shape
    umin = kidx = None
    for k in range(g):
        R = product(Xn[k].T, Yn[k])  # (p, m)
        u = torch.clamp(torch.clamp(1.0 - R * R, min=_TINY) * cmat[k], min=_TINY)
        if k == 0:
            umin = u
            kidx = torch.zeros(u.shape, dtype=torch.int32, device=u.device) if panel else None
            continue
        upd = u < umin  # strict: the first minimum wins
        umin = torch.where(upd, u, umin)
        if panel:
            kidx.masked_fill_(upd, k)
    return (-0.5 * n) * torch.log10(umin), kidx


@with_highest_matmul()
def altgrid_plain(Xn, Yn, cmat, *, panel: bool = True, dot_precision: str = "highest"):
    """The kernel's function in plain torch, on any device: exact float32
    products, or under ``dot_precision="high"`` the kernel's bf16x3 products
    (``split.py::matmul_bf16x3``)."""
    product = matmul_bf16x3 if uses_bf16x3(dot_precision) else torch.matmul
    return _min_over_grid(Xn, Yn, cmat, panel, product)


def _product_by_steps(A, B):
    """The kernel's 3 x TF32 product: each depth step's three passes into a
    sum that starts from zero, added into the total rounded to nearest."""
    return matmul_tf32x3_emulated(A, B, run=1)


def altgrid_split_reference(Xn, Yn, cmat, *, panel: bool = True):
    """The kernel's function with the kernel's arithmetic: each product as
    three TF32 passes summed as the kernel's tensor cores sum them, a depth
    step at a time (``split.py::matmul_tf32x3_emulated``). On any device;
    no main path takes it."""
    return _min_over_grid(Xn, Yn, cmat, panel, _product_by_steps)


def _finish(L, kidx, Y0, h2_grid):
    """L in Y0's dtype and the h2 panel, as the JAX wrapper returns them."""
    return L.to(Y0.dtype), None if kidx is None else h2_grid[kidx]


def fused_alt_grid(Y0, X0m, C0, lam, h2_grid, *, prior, reml=False, output_h2_panel=True,
                   dot_precision: str = "highest"):
    """(L, h2_panel) of the alt-grid scan: the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors, both with ``dot_precision``'s products.
    L (p, m) in Y0's dtype; h2_panel (p, m) ``h2_grid[argmax]``, or None when
    ``output_h2_panel`` is False."""
    ops = prepare_inputs(Y0, X0m, C0, lam, h2_grid, prior=prior, reml=reml)
    run = altgrid_cuda if ops[0].is_cuda else altgrid_plain
    return _finish(*run(*ops, panel=output_h2_panel, dot_precision=dot_precision), Y0, h2_grid)


def fused_alt_grid_reference(Y0, X0m, C0, lam, h2_grid, *, prior, reml=False, output_h2_panel=True,
                             dot_precision: str = "highest"):
    """:func:`fused_alt_grid` through the plain version on any device."""
    ops = prepare_inputs(Y0, X0m, C0, lam, h2_grid, prior=prior, reml=reml)
    return _finish(*altgrid_plain(*ops, panel=output_h2_panel, dot_precision=dot_precision),
                   Y0, h2_grid)
