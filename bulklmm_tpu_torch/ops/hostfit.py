"""Host float64 null-model fit for the single-trait scans.

Counterpart of ``bulklmm_tpu/ops/hostfit.py`` (its full-rank half), kept in
numpy with the same operations in the same order, so that the two packages
give bit-identical h2, coefficients, sigma2 and ell from the same inputs,
whatever device the scan then runs on. The profile likelihood is flat near
its optimum, so a device Brent would converge to points up to ~1e-4 apart on
different backends and move single-trait LODs by as much; this fit removes
that. It evaluates the (RE)ML objective of ``ops/wls.py`` (reference
src/wls.jl:69-93, src/lmm.jl:56-86) with a deterministic bounded Brent on
Python floats: O(n c^2) an iteration, ~50 iterations.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np

_CGOLD = 0.3819660112501051  # 2 - golden ratio
_MAX_DELTA = 1e18  # the h2 -> 1 clamp of ops/weights.py
# an all-zero phenotype gives rss0 == 0 exactly: floor sigma2 so math.log
# stays defined and the fit returns a finite degenerate likelihood
_SIGMA2_FLOOR = np.finfo(np.float64).tiny


class HostFit(NamedTuple):
    b: np.ndarray  # (c, 1) null coefficients, float64
    sigma2: float
    h2: float
    ell: float


def _make_weights(h2: float, lam: np.ndarray) -> np.ndarray:
    delta = h2 / (1.0 - h2) if h2 < 1.0 else _MAX_DELTA
    delta = min(max(delta, -_MAX_DELTA), _MAX_DELTA)
    return 1.0 / (delta * lam + 1.0)


def _wls(y0, X0, w, prior, reml):
    """float64 WLS estimates (coef, sigma2, ell); the formulas of
    ``ops/wls.py::wls``."""
    n, c = X0.shape
    prior_a, prior_b = prior
    sw = np.sqrt(w)
    yy = y0 * sw[:, None]
    XX = X0 * sw[:, None]
    q, r = np.linalg.qr(XX)
    try:
        coef = np.linalg.solve(r, q.T @ yy)
    except np.linalg.LinAlgError:
        # a rank-deficient design (an all-zero covariate column): the
        # minimum-norm solution, so the objective never raises mid-Brent
        coef = np.linalg.lstsq(XX, yy, rcond=None)[0]
    res = yy - XX @ coef
    rss0 = float(np.sum(res * res))
    prior_df = prior_b + 2.0 if prior_b > 0.0 else prior_b
    denom = (n - c if reml else n) + prior_df
    sigma2 = max((rss0 + prior_a * prior_b) / denom, _SIGMA2_FLOOR)
    ell = -0.5 * (
        (n + prior_b) * math.log(sigma2)
        - float(np.sum(np.log(w)))
        + (rss0 + prior_a * prior_b) / sigma2
    )
    if reml:
        logdet = 2.0 * float(np.sum(np.log(np.abs(np.diag(r)))))
        ell = ell + 0.5 * (c * math.log(sigma2) - logdet)
    return coef, sigma2, ell


def _brent_bounded(f, lo: float, hi: float, rel_tol: float = 1e-9,
                   abs_tol: float = 1e-12, maxiter: int = 300):
    """Bounded Brent minimization on Python floats: ``(fmin, xmin)``.

    The algorithm of ``ops/brent.py`` run eagerly in float64, with tighter
    tolerances than the device version since an iteration costs the host
    almost nothing.
    """
    a, b = lo, hi
    x = w = v = a + _CGOLD * (b - a)
    fx = fw = fv = f(x)
    d = e = 0.0
    for _ in range(maxiter):
        xm = 0.5 * (a + b)
        tol1 = rel_tol * abs(x) + abs_tol
        tol2 = 2.0 * tol1
        if abs(x - xm) <= tol2 - 0.5 * (b - a):
            break
        use_para = False
        if abs(e) > tol1:
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0.0:
                p = -p
            q = abs(q)
            etemp = e
            e = d
            if abs(p) < abs(0.5 * q * etemp) and p > q * (a - x) and p < q * (b - x):
                use_para = True
                d = p / q
                u = x + d
                if (u - a) < tol2 or (b - u) < tol2:
                    d = tol1 if xm - x >= 0.0 else -tol1
        if not use_para:
            e = (a - x) if x >= xm else (b - x)
            d = _CGOLD * e
        u = x + d if abs(d) >= tol1 else x + (tol1 if d >= 0.0 else -tol1)
        fu = f(u)
        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, fv = w, fw
                w, fw = u, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return fx, x


def fit_lmm_host(
    y0,
    X0,
    lam,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
    optim_interval: int = 1,
    h20: float = 0.5,
    d: float = 1.0,
) -> HostFit:
    """The float64 null fit of one rotated trait, on the host.

    Arguments as :func:`bulklmm_tpu_torch.ops.lmm.fit_lmm`; ``y0`` (n,) or
    (n, 1), ``X0`` (n, c) and ``lam`` (n,) are numpy arrays (or anything
    numpy takes), cast to float64.
    """
    y0 = np.asarray(y0, dtype=np.float64)
    y0 = y0[:, None] if y0.ndim == 1 else y0
    X0 = np.asarray(X0, dtype=np.float64)
    lam = np.asarray(lam, dtype=np.float64)

    def neg_ll(h2):
        return -_wls(y0, X0, _make_weights(h2, lam), prior, reml)[2]

    lb = max(h20 - d, 0.0)
    ub = min(h20 + d, 1.0)
    pts = np.linspace(lb, ub, optim_interval + 1)
    best_f, best_x = math.inf, 0.5 * (lb + ub)
    for lo, hi in zip(pts[:-1], pts[1:]):
        fmin, xmin = _brent_bounded(neg_ll, float(lo), float(hi))
        if fmin < best_f:
            best_f, best_x = fmin, xmin
    # the lower endpoint is a candidate, the upper one never (h2 = 1 is an
    # open boundary of the model, COMPAT.md #19)
    x = float(pts[0])
    fx = neg_ll(x)
    if math.isfinite(fx) and fx < best_f:
        best_f, best_x = fx, x
    coef, sigma2, ell = _wls(y0, X0, _make_weights(best_x, lam), prior, reml)
    return HostFit(b=coef, sigma2=sigma2, h2=best_x, ell=ell)
