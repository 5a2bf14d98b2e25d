"""Array utilities: centering, scaling, standardization, permutation
shuffles, and the covariate-design check.

Counterpart of ``bulklmm_tpu/ops/stats.py`` (reference src/util.jl:9-179):
the reference's in-place helpers (``colCenter!`` and the rest) become pure
functions on tensors. The zero-divide guard mirrors ``checkZeros``
(src/util.jl:47-56).

``shuffle_vector`` draws through :func:`~bulklmm_tpu_torch.ops.bulkperm.
permutation_indices`, so one seed gives the same shuffles to
``scan_perms_lite`` and ``bulkscan_perms``. Those indices come from a seeded
CPU ``torch.Generator``, not the JAX package's threefry or the reference's
MersenneTwister: parity with either under a seed is distributional only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.host import to_numpy
from .bulkperm import permutation_indices


def _check_nonzero(x) -> None:
    x = to_numpy(x)
    if np.any(np.isclose(x, 0.0, atol=float(np.finfo(x.dtype).eps), rtol=0.0)):
        raise ValueError("Dividing by zeros: the divisor contains zeros.")


def col_center(A: torch.Tensor) -> torch.Tensor:
    """Subtract each column's mean (reference colCenter!, src/util.jl:9)."""
    return A - A.mean(0, keepdim=True)


def row_center(A: torch.Tensor) -> torch.Tensor:
    """Subtract each row's mean (reference rowCenter!, src/util.jl:28)."""
    return A - A.mean(1, keepdim=True)


def col_divide(A: torch.Tensor, x) -> torch.Tensor:
    """Divide column j by x[j] (reference colDivide!, src/util.jl:58)."""
    _check_nonzero(x)
    return A / torch.as_tensor(x, device=A.device)[None, :]


def row_divide(A: torch.Tensor, x) -> torch.Tensor:
    """Divide row i by x[i] (reference rowDivide!, src/util.jl:98)."""
    _check_nonzero(x)
    return A / torch.as_tensor(x, device=A.device)[:, None]


def row_multiply(A: torch.Tensor, x) -> torch.Tensor:
    """Multiply row i by x[i] (reference rowMultiply, src/util.jl:121-158)."""
    return A * torch.as_tensor(x, device=A.device)[:, None]


def col_standardize(A: torch.Tensor) -> torch.Tensor:
    """Center and scale each column to unit sample std (ddof=1)
    (reference colStandardize, src/util.jl:80-96)."""
    c = col_center(A)
    s = c.std(0, correction=1)
    _check_nonzero(s)
    return c / s[None, :]


def shuffle_vector(seed, x: torch.Tensor, nshuffle: int, *, original: bool = True) -> torch.Tensor:
    """(n, nshuffle [+1]) matrix of independent random permutations of ``x``.

    ``seed`` is an int or a CPU ``torch.Generator`` (the JAX package's key).
    Column 0 is ``x`` itself when ``original=True`` (reference shuffleVector,
    src/util.jl:162-179); column k is ``x[idx[k]]`` for the rows of
    ``permutation_indices(n, nshuffle, seed, original=original)``.
    """
    idx = permutation_indices(x.shape[0], nshuffle, seed, original=original)
    return x[idx.to(x.device)].T


def check_covar_full_rank(covar, add_intercept: bool) -> None:
    """Refuse rank-deficient covariate designs at the public entry points.

    A dependent covariate column, or a constant column colliding with the
    auto-added intercept, makes the null model unidentifiable and the
    covariate Gram's Cholesky NaN. Host float64 rank test; c is tiny.
    """
    C = to_numpy(covar, np.float64)
    if C.ndim == 1:
        C = C[:, None]
    if add_intercept:
        C = np.concatenate([np.ones((C.shape[0], 1)), C], axis=1)
    if np.linalg.matrix_rank(C) < C.shape[1]:
        raise ValueError(
            "covariates are rank-deficient (linearly dependent columns, or "
            "a constant column together with the auto-added intercept): the "
            "null model is unidentifiable. Drop the dependent column(s), or "
            "pass add_intercept=False if the covariates already include an "
            "intercept."
        )
