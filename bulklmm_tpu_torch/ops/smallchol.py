"""Unrolled small-Cholesky helpers for covariate-sized (c x c) systems.

Counterpart of ``bulklmm_tpu/ops/smallchol.py``. c (intercept + covariates)
is tiny, so the factorization and substitutions unroll into c^2-ish
elementwise tensor ops over operands of any broadcastable shape: (m,)
scalars per trait, (p, m) marker blocks, or (g, m) grid blocks.

Entries are keyed dicts: ``G[(k, l)]`` for k <= l holds the (k, l) Gram
entry; ``L[(i, k)]`` for i >= k the lower factor entry.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..utils.config import with_highest_matmul
from ..utils.profiling import span


def pair_indices(c: int) -> List[Tuple[int, int]]:
    """Upper-triangular (k, l), k <= l, ordering for Gram entries."""
    return [(k, l) for k in range(c) for l in range(k, c)]


def unrolled_cholesky(G: Dict[Tuple[int, int], torch.Tensor], c: int):
    """Lower-triangular factor entries ``L[(i, k)]`` of G = L L^T."""
    L: Dict[Tuple[int, int], torch.Tensor] = {}
    for k in range(c):
        s = G[(k, k)]
        for q in range(k):
            s = s - L[(k, q)] * L[(k, q)]
        L[(k, k)] = torch.sqrt(s)
        for i in range(k + 1, c):
            s = G[(k, i)] if (k, i) in G else G[(i, k)]
            for q in range(k):
                s = s - L[(i, q)] * L[(k, q)]
            L[(i, k)] = s / L[(k, k)]
    return L


def fwd_subst(L, rows: Sequence[torch.Tensor], c: int) -> List[torch.Tensor]:
    """Solve ``L z = rows`` by forward substitution."""
    z: List[torch.Tensor] = []
    for k in range(c):
        s = rows[k]
        for q in range(k):
            s = s - L[(k, q)] * z[q]
        z.append(s / L[(k, k)])
    return z


def residual_sq(total_sq: torch.Tensor, zeta: Sequence[torch.Tensor]) -> torch.Tensor:
    """``||r||^2 = total_sq - sum zeta_k^2``, floored at ``4 eps total_sq``
    so a cancellation below zero cannot reach a sqrt or log as NaN."""
    out = total_sq
    for zk in zeta:
        out = out - zk * zk
    eps = torch.finfo(out.dtype).eps
    return torch.maximum(out, 4.0 * eps * total_sq)


def _eps(post: torch.Tensor, eps):
    return torch.finfo(post.dtype).eps if eps is None else eps


def residual_keep_mask(post, pre, rel: float = 1024.0, *, eps=None):
    """1.0 where an EXPLICITLY residualized column keeps genuine variance:
    ``post > (rel eps)^2 pre`` (COMPAT.md #15). ``eps`` is that of the dtype
    the residual was computed in; it defaults to ``post``'s."""
    return (post > (rel * _eps(post, eps)) ** 2 * pre).to(post.dtype)


def cancel_keep_mask(post, pre, rel: float = 1024.0, *, eps=None):
    """Keep mask for norms computed by cancellation (:func:`residual_sq`),
    whose noise is linear in eps: ``post > rel eps pre``."""
    return (post > rel * _eps(post, eps) * pre).to(post.dtype)


@with_highest_matmul()
def off_covariates(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """X (n, p) with its part in the span of C's (n, c) columns taken out,
    unweighted, in X's dtype; a column whose remainder is rounding noise of
    that subtraction (:func:`residual_keep_mask` in X's dtype) becomes zero.

    A marker's LOD, effect and standard error depend on it only through its
    residual on the covariates under each trait's weights, so taking out
    any combination of the covariates changes none of them. The CUDA
    kernels' routes take their markers this way, in the solve dtype, before
    rounding them to float32 (``kernels/liteqtl_fused.py::prepare_inputs``,
    ``models/bulkperm.py::_full_rank_block_lods``): with the intercept among
    the covariates the rotated markers' means sit in the samples of the
    kinship's largest eigenvalues, and the kernels' D1 - sum Z^2 then
    cancelled most of D1 in float32, which left the products' and the
    epilogue's rounding errors at several times their size. The plain
    engines keep the markers as they are."""
    Cx = C.to(X.dtype)
    with span("bulklmm.sync.pinv"):  # on a card its SVD waits for the device
        Cp = torch.linalg.pinv(Cx)
    Xr = X - Cx @ (Cp @ X)
    return Xr * residual_keep_mask((Xr * Xr).sum(0), (X * X).sum(0))
