"""The plain reference: the linear mixed model of BulkLMM.jl's ``bulkscan``
and its permutation test, in float64 torch, written from the model.

The model for a trait y (n,) with covariates C (n, c) and kinship K is
``y ~ N(C b, s2 (h2 K + (1 - h2) I))``. With ``K = U diag(lam) U^T`` and
``delta = h2 / (1 - h2)``, rotating by U^T makes the covariance diagonal,
``s2 (1 - h2) (delta lam + 1)``, so each h2 is a weighted least-squares fit
with weights ``w = 1 / (delta lam + 1)``. At the ML estimate of s2,

    ell(h2) = -1/2 (n log(rss / n) - sum(log w) + n),

with rss the weighted residual sum of squares. A marker x is scored at a
trait's h2 by the squared correlation r2 of the weighted, covariate-
residualized x and y, ``LOD = -(n / 2) log10(1 - r2)``.

- null-grid: each trait's h2 is the grid point of largest ell (the first
  of equal ones); every marker is scored at it.
- alt-grid: for each (marker, trait) the grid point of largest
  ``ell_k + (n / 2) ln(1 / (1 - r2_k))``, the alternative's log-likelihood;
  ``L = (max_k ell1_k - max_k ell0_k) / ln 10``.
- permutations: the trait's weighted residual, normalized, is shuffled in
  the rotated coordinates (row k of the shuffle indices puts its entry
  ``idx[k, t]`` at position t); a shuffle's statistic is the largest LOD
  over markers of its correlation with the weighted, residualized markers.
  The shuffles live in U's coordinates, so the eigenvectors are LAPACK's
  (``numpy.linalg.eigh``) and their signs matter.

``LMM(control=True)`` is the same arithmetic one precision lower than the
port's BALANCED preset states: float32 throughout, the eigenvectors cast
from the same float64 factors, and products on TF32.

Imports torch and numpy only.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_LN10 = math.log(10.0)


@contextlib.contextmanager
def products(tf32: bool):
    """Matrix products in TF32 (``tf32``) or in full precision, for the
    duration of the block; the process's settings are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


class LMM:
    """The reference for one data set: kinship ``K`` (n, n) float64 on the
    host, genotypes ``G`` (n, p), extra covariates ``covar`` (n, c - 1) or
    None (the intercept is always the first column), the h2 grid."""

    def __init__(self, K: np.ndarray, G: torch.Tensor, covar, h2_grid, *, control=False,
                 marker_block: int = 16384):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64
        device = G.device
        lam, U = np.linalg.eigh(np.asarray(K, dtype=np.float64))
        self.U = torch.as_tensor(U, device=device).to(self.dtype)
        self.lam = torch.as_tensor(lam, device=device).to(self.dtype)
        self.grid = torch.as_tensor(np.asarray(h2_grid, dtype=np.float64), device=device)
        n = G.shape[0]
        C = torch.ones((n, 1), dtype=self.dtype, device=device)
        if covar is not None:
            C = torch.cat([C, covar.to(self.dtype)], dim=1)
        self.n = n
        self.marker_block = marker_block
        with products(control):
            self.C0 = self.U.T @ C
            self.X0 = torch.empty((n, G.shape[1]), dtype=self.dtype, device=device)
            for s in range(0, G.shape[1], marker_block):
                block = G[:, s : s + marker_block].to(self.dtype)
                self.X0[:, s : s + marker_block] = self.U.T @ block

    # -- pieces -------------------------------------------------------------

    def rotate(self, Y: torch.Tensor) -> torch.Tensor:
        with products(self.control):
            return self.U.T @ Y.to(self.dtype)

    def weights(self, h2: float) -> torch.Tensor:
        h2 = float(h2)
        delta = h2 / (1.0 - h2)
        return (1.0 / (delta * self.lam + 1.0)).abs()

    def _basis(self, sw: torch.Tensor) -> torch.Tensor:
        """Orthonormal basis (n, c) of the weighted covariates."""
        return torch.linalg.qr(sw[:, None] * self.C0, mode="reduced")[0]

    @staticmethod
    def _resid(M, sw, Q):
        Mw = sw[:, None] * M
        return Mw - Q @ (Q.T @ Mw)

    def null_ells(self, Y0: torch.Tensor) -> torch.Tensor:
        """(g, m) null log-likelihoods of the rotated traits over the grid."""
        n = self.n
        out = []
        with products(self.control):
            for h2 in self.grid.tolist():
                w = self.weights(h2)
                sw = torch.sqrt(w)
                R = self._resid(Y0, sw, self._basis(sw))
                rss = (R * R).sum(0)
                out.append(-0.5 * (n * torch.log(rss / n) - torch.log(w).sum() + n))
        return torch.stack(out)

    def grid_fit(self, Y0: torch.Tensor):
        """(index, h2, ells): each trait's grid point of largest ell."""
        ells = self.null_ells(Y0)
        idx = torch.argmax(ells, dim=0)  # the first of equal maxima
        return idx, self.grid[idx], ells

    def _markers(self, sw, Q, s, e):
        Xr = self._resid(self.X0[:, s:e], sw, Q)
        return Xr, (Xr * Xr).sum(0)

    # -- the three scans ----------------------------------------------------

    def lods(self, Y0: torch.Tensor, h2: torch.Tensor):
        """Yields ``(cols, L)``: the (p, len(cols)) LODs of the traits
        ``cols`` of Y0, each scored at its own h2 (``h2`` (m,)), grouped by
        h2 value."""
        n = self.n
        for u in torch.unique(h2).tolist():
            cols = torch.nonzero(h2 == u).flatten()
            w = self.weights(u)
            sw = torch.sqrt(w)
            with products(self.control):
                Q = self._basis(sw)
                Yr = self._resid(Y0[:, cols], sw, Q)
                Yr = Yr / torch.sqrt((Yr * Yr).sum(0))
                Xr, xn = self._markers(sw, Q, 0, self.X0.shape[1])
                Xr = Xr / torch.sqrt(xn)
                for b in range(0, cols.numel(), 2048):
                    R = Xr.T @ Yr[:, b : b + 2048]
                    yield cols[b : b + 2048], -(n / 2.0) * torch.log10(1.0 - R * R)

    def alt_grid(self, Y0: torch.Tensor, k_out: torch.Tensor | None = None):
        """``(L, k, best, short)`` of the alt-grid scan of the rotated traits
        Y0 (n, m): L (p, m), the grid index of each pair's maximum (the
        first of equal ones), the alternative's largest log-likelihood and,
        given another scan's indices ``k_out`` (p, m), how far the
        alternative's log-likelihood at them lies below it (else None)."""
        n = self.n
        p, m = self.X0.shape[1], Y0.shape[1]
        best = torch.full((p, m), -math.inf, dtype=self.dtype, device=Y0.device)
        kbest = torch.zeros((p, m), dtype=torch.int64, device=Y0.device)
        at_out = None if k_out is None else torch.empty_like(best)
        ell0_max = torch.full((m,), -math.inf, dtype=self.dtype, device=Y0.device)
        ells = self.null_ells(Y0)
        with products(self.control):
            for k, h2 in enumerate(self.grid.tolist()):
                sw = torch.sqrt(self.weights(h2))
                Q = self._basis(sw)
                Yr = self._resid(Y0, sw, Q)
                Yr = Yr / torch.sqrt((Yr * Yr).sum(0))
                Xr, xn = self._markers(sw, Q, 0, p)
                R = (Xr / torch.sqrt(xn)).T @ Yr
                ell1 = ells[k][None, :] - (n / 2.0) * torch.log1p(-R * R)
                upd = ell1 > best  # strict: the first maximum stays
                best = torch.where(upd, ell1, best)
                kbest.masked_fill_(upd, k)
                if at_out is not None:
                    at_out = torch.where(k_out == k, ell1, at_out)
                ell0_max = torch.maximum(ell0_max, ells[k])
                del R, ell1, upd
        L = (best - ell0_max[None, :]) / _LN10
        return L, kbest, best, None if at_out is None else best - at_out

    def perm_maxlods(self, Y0: torch.Tensor, h2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(m, K) largest LOD over markers of each trait (column of the
        rotated Y0) under each shuffle (row of ``idx`` (K, n)), each trait at
        its own h2."""
        n, p = self.n, self.X0.shape[1]
        out = torch.empty((Y0.shape[1], idx.shape[0]), dtype=self.dtype, device=Y0.device)
        idx = idx.to(Y0.device)
        with products(self.control):
            for j in range(Y0.shape[1]):
                sw = torch.sqrt(self.weights(float(h2[j])))
                Q = self._basis(sw)
                r = self._resid(Y0[:, j : j + 1], sw, Q)[:, 0]
                S = r[idx].T / torch.sqrt((r * r).sum())  # (n, K), unit columns
                best = torch.zeros(idx.shape[0], dtype=self.dtype, device=Y0.device)
                for s in range(0, p, self.marker_block):
                    Xr, xn = self._markers(sw, Q, s, min(s + self.marker_block, p))
                    r2 = (Xr.T @ S) ** 2 / xn[:, None]
                    best = torch.maximum(best, r2.max(0).values)
                out[j] = -(n / 2.0) * torch.log10(1.0 - best)
        return out
