"""Covariate-design check.

Counterpart of ``bulklmm_tpu/ops/stats.py::check_covar_full_rank``: the
column helpers and permutation shuffles there are not on the null-grid
path and are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..utils.host import to_numpy


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
