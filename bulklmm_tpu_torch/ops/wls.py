"""Weighted least squares with a Scaled-Inv-Chi^2 prior.

Counterpart of ``bulklmm_tpu/ops/wls.py`` (reference src/wls.jl:27-101,
formulas (2) and (3) of Kang 2008):

  rss     = ||W^1/2 (y - X coef)||^2
  prior_df = prior_b + 2 if prior_b > 0 else prior_b
  sigma2  = (rss + prior_a prior_b) / ((n - p reml) + prior_df)
  ell     = -1/2 [ (n + prior_b) log sigma2 - sum(log w) + (rss + prior_a prior_b) / sigma2 ]
  reml:  ell += 1/2 [ p log sigma2 - logdet(X^T W X) ]

- :func:`wls`: coefficients by QR or normal equations (Cholesky);
- :func:`wls_multivar`: :func:`wls` with a matrix ``y`` (the reference's
  per-column loop, src/wls.jl:103-180, is one solve here);
- :func:`wls_ell` and :func:`wls_ell_columns`: the likelihood alone, with no
  linear-algebra primitive (the unrolled covariate Cholesky), for a shared
  weight vector or a batch of them, and for one weight vector per column;
  :func:`wls_ell` past :data:`UNROLLED_COLUMNS` columns by one batched
  factorization;
- :func:`wls_ell_markers`: the likelihood of the design ``[C, x_j]`` for
  every marker j at once, the objective of the single-trait alt scan;
- :func:`resid` and :func:`rss`: OLS residuals and their sums of squares
  (reference src/wls.jl:191-263).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.config import with_highest_matmul
from .smallchol import fwd_subst, residual_sq, unrolled_cholesky


class WLSResult(NamedTuple):
    """Estimates from one weighted LS fit; q is the number of y columns.

    b: (p, q) coefficients; sigma2, ell, rss: (q,) per column.
    """

    b: torch.Tensor
    sigma2: torch.Tensor
    ell: torch.Tensor
    rss: torch.Tensor


def _likelihood(rss0, sum_log_w, logdet, n, p, prior, reml):
    """(ell, sigma2) from the residual sum of squares; ``logdet`` is that of
    the weighted Gram X^T W X (read only under REML)."""
    prior_a, prior_b = prior
    prior_df = prior_b + 2.0 if prior_b > 0.0 else prior_b
    denom = (n - p if reml else n) + prior_df
    # degenerate columns (rss0 == 0 with a zero prior) floor at the dtype's
    # tiny, so the log stays finite
    sigma2 = torch.clamp((rss0 + prior_a * prior_b) / denom, min=torch.finfo(rss0.dtype).tiny)
    ell = -0.5 * (
        (n + prior_b) * torch.log(sigma2) - sum_log_w + (rss0 + prior_a * prior_b) / sigma2
    )
    if reml:
        ell = ell + 0.5 * (p * torch.log(sigma2) - logdet)
    return ell, sigma2


@with_highest_matmul()
def wls(
    y: torch.Tensor,
    X: torch.Tensor,
    w: torch.Tensor,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
    method: str = "qr",
) -> WLSResult:
    """Weighted least squares of ``y`` (n,) or (n, q) on ``X`` (n, p).

    ``w`` is one (n,) weight vector for every column, as in the JAX
    package, or (q, n), one weight vector per column (the batched refit of
    :func:`~bulklmm_tpu_torch.ops.lmm.fit_lmm_traits`). ``method`` is "qr"
    (reduced QR and a triangular solve) or "cholesky" (normal equations).
    """
    y = y[:, None] if y.ndim == 1 else y
    n, p = X.shape
    sqrtw = torch.sqrt(w)
    if w.ndim == 1:
        XX, yy = X * sqrtw[:, None], y * sqrtw[:, None]  # (n, p), (n, q)
    else:
        XX = X[None] * sqrtw[:, :, None]  # (q, n, p)
        yy = (y.T * sqrtw)[:, :, None]  # (q, n, 1)

    if method == "qr":
        Q, R = torch.linalg.qr(XX, mode="reduced")
        coef = torch.linalg.solve_triangular(R, Q.mT @ yy, upper=True)
        logdet = 2.0 * torch.log(torch.diagonal(R, dim1=-2, dim2=-1).abs()).sum(-1)
    elif method == "cholesky":
        chol = torch.linalg.cholesky(XX.mT @ XX)
        z = torch.linalg.solve_triangular(chol, XX.mT @ yy, upper=False)
        coef = torch.linalg.solve_triangular(chol.mT, z, upper=True)
        logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    else:
        raise ValueError(f"unknown method {method!r}; use 'qr' or 'cholesky'")

    resid = yy - XX @ coef
    rss0 = (resid * resid).sum(-2)
    if w.ndim > 1:
        coef, rss0 = coef[..., 0].T, rss0[:, 0]  # (p, q), (q,)
    ell, sigma2 = _likelihood(rss0, torch.log(w).sum(-1), logdet, n, p, prior, reml)
    return WLSResult(b=coef, sigma2=sigma2, ell=ell, rss=rss0)


def _chol_logdet(Lc, p):
    return sum(2.0 * torch.log(Lc[(k, k)]) for k in range(p))


#: design columns up to which :func:`wls_ell` factors the weighted Gram by
#: the unrolled Cholesky, ~p^3 / 3 elementwise operations on the batch's
#: shape, each a launch on a card: at GTEx v8's 69 covariate columns that
#: was 124,788 launches a null-grid scan and most of its time, on the host
#: (an H100, PERF.md). Every count up to 16, the widest the tests hold
#: against the JAX package, keeps the unrolled form and its rounding.
UNROLLED_COLUMNS = 16


def _batched_zeta(y, X, w):
    """``(zeta, logdet)`` of :func:`wls_ell` by one batched factorization:
    zeta, the list of the p rows of ``L^{-1} X^T W y``, each (..., q), and
    log det(X^T W X), (..., 1), with L the Cholesky factor of the weighted
    Gram for each weight vector of ``w`` ((n,) or (..., n)). ``cholesky_ex``
    leaves its error flag on the device, as the unrolled factor leaves a
    NaN; the caller's covariates are checked for full rank beforehand."""
    Xw = w[..., :, None] * X  # (..., n, p)
    L = torch.linalg.cholesky_ex(Xw.mT @ X).L  # (..., p, p)
    zeta = torch.linalg.solve_triangular(L, Xw.mT @ y, upper=False)  # (..., p, q)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1, keepdim=True)
    return list(zeta.unbind(-2)), logdet


@with_highest_matmul()
def wls_ell(
    y: torch.Tensor,
    X: torch.Tensor,
    w: torch.Tensor,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ell, sigma2) per column of ``y``, with no linear-algebra primitive
    up to :data:`UNROLLED_COLUMNS` design columns.

    ``y``: (n,) or (n, q); ``X``: (n, p) design; ``w``: (n,) weights, or
    (g, n) for g weight vectors at once (the batch dimension that replaces
    JAX's ``vmap`` over the h2 grid), giving (q,) or (g, q) outputs.

    Uses ``rss = ||W^1/2 y||^2 - ||L^{-1} X^T W y||^2`` with ``L`` the
    unrolled Cholesky factor of the weighted Gram ``X^T W X`` (p is tiny);
    past :data:`UNROLLED_COLUMNS` columns, the factor of one batched
    factorization and its triangular solve (:func:`_batched_zeta`).
    """
    y = y[:, None] if y.ndim == 1 else y
    n, p = X.shape
    if p > UNROLLED_COLUMNS:
        zeta, logdet = _batched_zeta(y, X, w)
        rss0 = residual_sq(w @ (y * y), zeta)
        return _likelihood(rss0, torch.log(w).sum(-1, keepdim=True), logdet if reml else None,
                           n, p, prior, reml)

    # Gram entries (..., 1) broadcast against the (..., q) right-hand sides
    G = {
        (k, l): (w @ (X[:, k] * X[:, l]))[..., None]
        for k in range(p)
        for l in range(k, p)
    }
    t = [w @ (X[:, k : k + 1] * y) for k in range(p)]
    Lc = unrolled_cholesky(G, p)
    zeta = fwd_subst(Lc, t, p)
    rss0 = residual_sq(w @ (y * y), zeta)
    logdet = _chol_logdet(Lc, p) if reml else None
    return _likelihood(rss0, torch.log(w).sum(-1, keepdim=True), logdet, n, p, prior, reml)


@with_highest_matmul()
def wls_ell_columns(
    y: torch.Tensor,
    X: torch.Tensor,
    w: torch.Tensor,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`wls_ell` with one weight vector per column of ``y``.

    ``y``: (n, q); ``X``: (n, p); ``w``: (..., q, n), where ``w[..., j, :]``
    weighs column j. Returns (ell, sigma2) of shape (..., q). This is the
    per-trait objective of the batched Brent: every trait at its own h2,
    with no (q x q) table.
    """
    n, p = X.shape
    yt = y.T  # (q, n)
    G = {(k, l): w @ (X[:, k] * X[:, l]) for k in range(p) for l in range(k, p)}
    wy = w * yt
    t = [wy @ X[:, k] for k in range(p)]
    Lc = unrolled_cholesky(G, p)
    zeta = fwd_subst(Lc, t, p)
    rss0 = residual_sq((wy * yt).sum(-1), zeta)
    logdet = _chol_logdet(Lc, p) if reml else None
    return _likelihood(rss0, torch.log(w).sum(-1), logdet, n, p, prior, reml)


def wls_multivar(
    Y: torch.Tensor,
    X: torch.Tensor,
    w: torch.Tensor,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
    method: str = "qr",
) -> WLSResult:
    """Multi-trait WLS: one shared design, per-column sigma2 and ell; the
    same computation as :func:`wls` with a matrix ``Y``."""
    return wls(Y, X, w, prior, reml=reml, method=method)


@with_highest_matmul()
def wls_ell_markers(
    y: torch.Tensor,
    C: torch.Tensor,
    Xm: torch.Tensor,
    w: torch.Tensor,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ell, sigma2) of the design ``[C, x_j]`` for every marker j at once.

    ``y``: (n,) or (n, 1), one trait; ``C``: (n, c) covariates; ``Xm``:
    (n, p) markers; ``w``: (p, L, n) or (p, n), marker j's weight vectors
    in ``w[j]``. Returns (p, L) or (p,). Every entry of the (c+1) x (c+1)
    weighted Gram and of ``[C, x_j]^T W y`` is a weighted reduction over n,
    solved with the unrolled Cholesky as in :func:`wls_ell`: no per-marker
    QR. The torch form of the JAX package's ``vmap(fit_lmm)`` objective
    over markers.
    """
    y = y.reshape(-1)
    n, c = C.shape
    W = w if w.ndim == 3 else w[:, None, :]  # (p, L, n)
    Xt = Xm.T[:, None, :]  # (p, 1, n)
    pairs = [(k, l) for k in range(c) for l in range(k, c)]
    CC = torch.stack([C[:, k] * C[:, l] for k, l in pairs] + [C[:, k] * y for k in range(c)]
                     + [y * y], dim=1)  # (n, npair + c + 1)
    S = W @ CC  # (p, L, npair + c + 1): the covariate-only reductions
    WX = W * Xt  # (p, L, n)
    G = {kl: S[..., i] for i, kl in enumerate(pairs)}
    xC = WX @ C  # (p, L, c)
    for k in range(c):
        G[(k, c)] = xC[..., k]
    G[(c, c)] = (WX @ Xm.T[:, :, None])[..., 0]  # batched over markers, no (p, L, n) temporary
    np_ = len(pairs)
    t = [S[..., np_ + k] for k in range(c)] + [WX @ y]
    Lc = unrolled_cholesky(G, c + 1)
    zeta = fwd_subst(Lc, t, c + 1)
    rss0 = residual_sq(S[..., -1], zeta)
    logdet = _chol_logdet(Lc, c + 1) if reml else None
    ell, sigma2 = _likelihood(rss0, torch.log(W).sum(-1), logdet, n, c + 1, prior, reml)
    if w.ndim == 2:
        return ell[:, 0], sigma2[:, 0]
    return ell, sigma2


@with_highest_matmul()
def resid(y: torch.Tensor, X: torch.Tensor, *, method: str = "qr") -> torch.Tensor:
    """Residuals of ``y`` (n,) or (n, q) after OLS on ``X`` (reference
    ``resid``, src/wls.jl:221-263)."""
    y2 = y[:, None] if y.ndim == 1 else y
    if method == "qr":
        Q = torch.linalg.qr(X, mode="reduced")[0]
        out = y2 - Q @ (Q.T @ y2)
    elif method == "cholesky":
        out = y2 - X @ torch.linalg.solve(X.T @ X, X.T @ y2)
    else:
        raise ValueError(f"unknown method {method!r}")
    return out[:, 0] if y.ndim == 1 else out


def rss(y: torch.Tensor, X: torch.Tensor, *, method: str = "qr") -> torch.Tensor:
    """Residual sum of squares per column of ``y`` (reference ``rss``,
    src/wls.jl:191-218)."""
    r = resid(y, X, method=method)
    r2 = r[:, None] if r.ndim == 1 else r
    return (r2 * r2).sum(0)
