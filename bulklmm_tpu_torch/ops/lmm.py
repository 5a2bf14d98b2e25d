"""LMM fitting: the 1-D heritability optimization of the rotated model.

Counterpart of ``bulklmm_tpu/ops/lmm.py`` (reference ``fitlmm``,
src/lmm.jl:56-86): minimize the negative (RE)ML log-likelihood of the
weighted model over h2 in [max(h20 - d, 0), min(h20 + d, 1)] by
(grid-)Brent, then refit WLS at the optimum.

- :func:`fit_h2_traits`: the Brent fit of every column of Y at once; each
  trait has its own h2 and so its own weight vector (``wls_ell_columns``),
  the counterpart of ``vmap(fit_lmm)`` over traits. No (m x m) table is
  formed.
- :func:`fit_lmm_traits`: that fit plus the WLS refit, per trait.
- :func:`fit_lmm`: one trait, as in the JAX package.
- :func:`fit_h2_markers`: the marker-axis twin of :func:`fit_h2_traits`:
  one trait, each marker's design ``[C, x_j]`` at its own h2
  (``wls_ell_markers``), the counterpart of ``vmap(fit_lmm)`` over markers
  in the single-trait alt scan.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .brent import gridbrent
from .weights import make_weights
from .wls import wls, wls_ell_columns, wls_ell_markers


class LMMResult(NamedTuple):
    b: torch.Tensor  # (p, 1) coefficients; (p, m) from fit_lmm_traits
    sigma2: torch.Tensor  # scalar; (m,) from fit_lmm_traits
    h2: torch.Tensor  # scalar; (m,)
    ell: torch.Tensor  # scalar; (m,)


def fit_h2_traits(
    Y0,
    X0,
    lam,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
    optim_interval: int = 1,
    h20: float = 0.5,
    d: float = 1.0,
) -> torch.Tensor:
    """(m,) h2 maximizing each column's (RE)ML likelihood.

    Y0: (n, m) rotated traits; X0: (n, c) rotated design; lam: (n,). The
    Brent domain dtype is ``lam``'s; its lanes are (m, optim_interval + 1).
    """
    Y0 = Y0[:, None] if Y0.ndim == 1 else Y0

    def neg_ll(h2):  # (m, L) -> (m, L)
        w = make_weights(h2.T, lam)  # (L, m, n)
        return -wls_ell_columns(Y0, X0, w, prior, reml=reml)[0].T

    _, h2 = gridbrent(
        neg_ll, max(h20 - d, 0.0), min(h20 + d, 1.0), optim_interval,
        batch_shape=(Y0.shape[1],), dtype=lam.dtype, device=lam.device,
    )
    return h2


def fit_h2_markers(
    y0,
    C0,
    X0m,
    lam,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
    optim_interval: int = 1,
    h20: float = 0.5,
    d: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h2, ell), each (p,): marker j's h2 maximizing the (RE)ML likelihood
    of the design ``[C0, x_j]``, and that likelihood at it.

    y0: (n,) or (n, 1) rotated trait; C0: (n, c) rotated covariates; X0m:
    (n, p) rotated markers; lam: (n,). One batched Brent over (p,
    optim_interval + 1) lanes; ell is the objective's own value at the
    optimum (the unrolled Cholesky), not a QR refit.
    """

    def neg_ll(h2):  # (p, L) -> (p, L)
        return -wls_ell_markers(y0, C0, X0m, make_weights(h2, lam), prior, reml=reml)[0]

    fmin, h2 = gridbrent(
        neg_ll, max(h20 - d, 0.0), min(h20 + d, 1.0), optim_interval,
        batch_shape=(X0m.shape[1],), dtype=lam.dtype, device=lam.device,
    )
    return h2, -fmin


def fit_lmm_traits(
    Y0,
    X0,
    lam,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
    method: str = "qr",
    optim_interval: int = 1,
    h20: float = 0.5,
    d: float = 1.0,
) -> LMMResult:
    """:func:`fit_h2_traits` and the WLS refit of every trait at its h2:
    b (c, m), sigma2, h2 and ell (m,)."""
    Y0 = Y0[:, None] if Y0.ndim == 1 else Y0
    h2 = fit_h2_traits(
        Y0, X0, lam, prior, reml=reml, optim_interval=optim_interval, h20=h20, d=d
    )
    est = wls(Y0, X0, make_weights(h2, lam), prior, reml=reml, method=method)
    return LMMResult(b=est.b, sigma2=est.sigma2, h2=h2, ell=est.ell)


def fit_lmm(
    y0,
    X0,
    lam,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
    method: str = "qr",
    optim_interval: int = 1,
    h20: float = 0.5,
    d: float = 1.0,
) -> LMMResult:
    """Fit the rotated LMM of one trait, ``y0`` (n,) or (n, 1): b (c, 1)
    and scalar sigma2, h2 and ell."""
    y2 = y0[:, None] if y0.ndim == 1 else y0
    fit = fit_lmm_traits(
        y2, X0, lam, prior, reml=reml, method=method,
        optim_interval=optim_interval, h20=h20, d=d,
    )
    return LMMResult(b=fit.b, sigma2=fit.sigma2[0], h2=fit.h2[0], ell=fit.ell[0])
