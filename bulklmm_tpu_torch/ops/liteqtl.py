"""Per-trait-weight correlation -> LOD, in plain torch.

Counterpart of ``bulklmm_tpu/ops/liteqtl.py`` (``_nd_parts_per_trait``,
``weighted_correlation_per_trait``, ``lods_per_trait``; reference
src/bulkscan_helpers.jl:47-64 and :22-24). With weights W[n, j] = w_j[n]:

  t      = C^T (W*Y)                       (c, m)      thin product
  G_j    = C^T diag(w_j) C                 (m, c, c)   c(c+1)/2 thin products
  zeta   = L_j^{-1} t_j                    (c, m)      unrolled substitution
  nrm2_j = sum_n w y^2 - |zeta_j|^2        (m,)        trait residual norm^2
  B      = X^T (W*Y)                       (p, m)
  U_k    = (X*C_k)^T W                     (p, m)      one per covariate
  D1     = (X*X)^T W                       (p, m)
  Z      = L^{-1} U,  N = B - sum_k Z_k zeta_k,  D = D1 - sum_k Z_k^2
  r      = N / sqrt(D * nrm2),   LOD = -(n/2) log10(1 - r^2)

``lods_and_effects_per_trait`` adds each marker's GLS effect and its
standard error from the same (N, D, nrm2) (``_effects_from_nd``):

  beta = N / D,  SE = sqrt(max(nrm2 - N^2 / D, 0) / (n - c - 1) / D)

This is the path of the MIXED and EXACT64 presets, which combine in
float64, on every device; the float32 presets go through the fused kernel
(``kernels/liteqtl_fused.py``), whose plain version computes the same
function in float32.

``weighted_correlation_shared`` / ``lods_shared`` are the one-h2 special
case (reference ``weighted_liteqtl``, src/bulkscan_helpers.jl:175-201):
markers and traits are weighted, residualized on the weighted covariates'
orthobasis and normalized once, so the scan is one (p x m) product. The
plain alt-grid path takes one such step per grid point.
"""

from __future__ import annotations

import torch

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from .lod import r2lod
from .smallchol import (
    cancel_keep_mask, fwd_subst, pair_indices, residual_keep_mask, residual_sq,
    unrolled_cholesky,
)
from .weights import make_weights


@with_highest_matmul()
def _nd_parts_per_trait(
    Y0, X0m, C0, lam, h2_per_trait, *, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """(N, D, nrm2): the (p, m) partial covariance numerator, the (p, m)
    residualized marker norm^2 and the (m,) residualized trait norm^2, in
    each trait's weighted metric.

    Y0: (n, m) rotated traits; X0m: (n, p) rotated markers; C0: (n, c)
    rotated covariates; lam: (n,); h2_per_trait: (m,). Combines run in the
    kernel dtype, the big products in the gemm dtype.
    """
    gdt = precision.resolve_gemm()
    sdt = precision.resolve_kernel()
    c = C0.shape[1]

    # abs guard: the reference's sqrt.(abs.(makeweights(...)))
    # (src/bulkscan_helpers.jl:138) for slightly negative eigenvalues
    W = make_weights(h2_per_trait, lam).abs().T.to(sdt)  # (n, m)
    Y = Y0.to(sdt)
    C = C0.to(sdt)
    X = X0m.to(sdt)
    WY = W * Y

    t = C.T @ WY  # (c, m)
    pairs = pair_indices(c)
    CC = torch.stack([C[:, k] * C[:, l] for k, l in pairs], dim=1)  # (n, npair)
    Gv = CC.T @ W  # (npair, m)
    Lc = unrolled_cholesky({kl: Gv[i] for i, kl in enumerate(pairs)}, c)
    zeta = fwd_subst(Lc, [t[k] for k in range(c)], c)
    yty = (WY * Y).sum(0)
    nrm2 = residual_sq(yty, zeta)

    Wg = W.to(gdt)
    B = (X.to(gdt).T @ WY.to(gdt)).to(sdt)
    U = [((X * C[:, k : k + 1]).to(gdt).T @ Wg).to(sdt) for k in range(c)]
    D1 = ((X * X).to(gdt).T @ Wg).to(sdt)

    Z = fwd_subst(Lc, U, c)  # (m,) factor entries broadcast over marker rows
    N = B
    for k in range(c):
        N = N - Z[k] * zeta[k][None, :]
    D = residual_sq(D1, Z)

    # zero-information columns give r = 0 exactly (COMPAT.md #15), tested at
    # the eps of the least precise dtype the operands passed through
    eps = max(torch.finfo(gdt).eps, torch.finfo(sdt).eps)
    keep = cancel_keep_mask(D, D1, eps=eps) * cancel_keep_mask(nrm2, yty, eps=eps)[None, :]
    return N * keep, D, nrm2


def weighted_correlation_per_trait(
    Y0, X0m, C0, lam, h2_per_trait, *, precision: PrecisionConfig = DEFAULT_PRECISION
) -> torch.Tensor:
    """(p, m) partial correlations with one h2 (weight vector) per trait."""
    N, D, nrm2 = _nd_parts_per_trait(Y0, X0m, C0, lam, h2_per_trait, precision=precision)
    # an all-zero column has D == 0 and N == 0: the floor gives 0, not NaN
    den = torch.clamp(D * nrm2[None, :], min=torch.finfo(D.dtype).tiny)
    return N / torch.sqrt(den)


def _effects_from_nd(N, D, nrm2, n: int, c: int):
    """(beta, se): beta = N / D and its SE from the per-(marker, trait)
    unbiased residual variance (nrm2 - N^2/D) / (n - c - 1), the convention
    of the single-trait scan's effects (``models/scan.py``). D is floored at
    the dtype's smallest normal number: an all-zero marker has N = D = 0."""
    D = torch.clamp(D, min=torch.finfo(D.dtype).tiny)
    beta = N / D
    rss = torch.clamp(nrm2[None, :] - N * N / D, min=0.0)
    dof = max(n - c - 1, 1)
    return beta, torch.sqrt(rss / dof / D)


def _fast_log(precision: PrecisionConfig) -> bool:
    """Take the log in float32 whenever the products ran in float32."""
    return precision.resolve_gemm() == torch.float32


def lods_per_trait(
    Y0, X0m, C0, lam, h2_per_trait, *, precision: PrecisionConfig = DEFAULT_PRECISION
) -> torch.Tensor:
    """(p, m) LOD scores with per-trait h2."""
    R = weighted_correlation_per_trait(Y0, X0m, C0, lam, h2_per_trait, precision=precision)
    return r2lod(R, Y0.shape[0], fast_log=_fast_log(precision))


def lods_and_effects_per_trait(
    Y0, X0m, C0, lam, h2_per_trait, *, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """(lod, beta, se), each (p, m), from ONE parts computation."""
    n, c = C0.shape
    N, D, nrm2 = _nd_parts_per_trait(Y0, X0m, C0, lam, h2_per_trait, precision=precision)
    den = torch.clamp(D * nrm2[None, :], min=torch.finfo(D.dtype).tiny)
    lod = r2lod(N / torch.sqrt(den), n, fast_log=_fast_log(precision))
    return (lod, *_effects_from_nd(N, D, nrm2, n, c))


@with_highest_matmul()
def weighted_correlation_shared(
    Y0, X0m, C0, lam, h2, *, precision: PrecisionConfig = DEFAULT_PRECISION
) -> torch.Tensor:
    """(p, m) correlations with one h2 shared by every column of Y0.

    Weighting, residualization and normalization run in the kernel dtype
    (they cancel); only the (p x m) product drops to the gemm dtype.
    """
    gdt = precision.resolve_gemm()
    sdt = precision.resolve_kernel()
    tiny = torch.finfo(sdt).tiny
    s = torch.sqrt(make_weights(h2, lam).abs()).to(sdt)  # (n,)
    q = torch.linalg.qr(C0.to(sdt) * s[:, None], mode="reduced")[0]  # (n, c)

    def residualize_normalize(M):
        Mw = M.to(sdt) * s[:, None]
        Mr = Mw - q @ (q.T @ Mw)
        nrm2 = (Mr * Mr).sum(0)
        # a column collinear with the covariates residualizes to rounding
        # noise: the relative rank mask maps it to r = 0 (COMPAT.md #15)
        keep = residual_keep_mask(nrm2, (Mw * Mw).sum(0), eps=torch.finfo(sdt).eps)
        return (Mr * keep[None, :]) / torch.sqrt(torch.clamp(nrm2, min=tiny))

    X00 = residualize_normalize(X0m).to(gdt)
    Y00 = residualize_normalize(Y0).to(gdt)
    return (X00.T @ Y00).to(sdt)


def lods_shared(
    Y0, X0m, C0, lam, h2, *, precision: PrecisionConfig = DEFAULT_PRECISION
) -> torch.Tensor:
    """(p, m) LOD scores with one h2 shared by every trait."""
    R = weighted_correlation_shared(Y0, X0m, C0, lam, h2, precision=precision)
    return r2lod(R, Y0.shape[0], fast_log=_fast_log(precision))
