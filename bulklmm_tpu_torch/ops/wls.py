"""Weighted least-squares log-likelihood with a Scaled-Inv-Chi^2 prior.

Counterpart of ``bulklmm_tpu/ops/wls.py::wls_ell`` (reference
src/wls.jl:69-93, formulas (2) and (3) of Kang 2008). ``wls``, ``resid``
and ``rss`` are not on the null-grid path and wait.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.config import with_highest_matmul
from .smallchol import fwd_subst, residual_sq, unrolled_cholesky


@with_highest_matmul()
def wls_ell(
    y: torch.Tensor,
    X: torch.Tensor,
    w: torch.Tensor,
    prior: Tuple[float, float] = (0.0, 0.0),
    *,
    reml: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ell, sigma2) per column of ``y``, with no linear-algebra primitive.

    ``y``: (n,) or (n, q); ``X``: (n, p) design; ``w``: (n,) weights, or
    (g, n) for g weight vectors at once (the batch dimension that replaces
    JAX's ``vmap`` over the h2 grid), giving (q,) or (g, q) outputs.

    Uses ``rss = ||W^1/2 y||^2 - ||L^{-1} X^T W y||^2`` with ``L`` the
    unrolled Cholesky factor of the weighted Gram ``X^T W X`` (p is tiny).
    """
    y = y[:, None] if y.ndim == 1 else y
    n, p = X.shape
    prior_a, prior_b = prior

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

    prior_df = prior_b + 2.0 if prior_b > 0.0 else prior_b
    denom = (n - p if reml else n) + prior_df
    sigma2 = torch.clamp(
        (rss0 + prior_a * prior_b) / denom, min=torch.finfo(rss0.dtype).tiny
    )
    ell = -0.5 * (
        (n + prior_b) * torch.log(sigma2)
        - torch.log(w).sum(-1, keepdim=True)
        + (rss0 + prior_a * prior_b) / sigma2
    )
    if reml:
        logdet = sum(2.0 * torch.log(Lc[(k, k)]) for k in range(p))
        ell = ell + 0.5 * (p * torch.log(sigma2) - logdet)
    return ell, sigma2
