"""Single-trait scan helpers used by the bulk engine.

Only ``_apply_weights`` is ported (``bulklmm_tpu/models/scan.py:447``); the
single-trait ``scan`` itself waits (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import warnings

import numpy as np

from ..utils.host import to_numpy


def _apply_weights(y, g, covar, K, weights, add_intercept):
    """Pre-scale data for heteroskedastic residual variances.

    Mirrors the reference (src/scan.jl:201-227): y, G and the covariates
    are multiplied by diag(weights) and K -> W K W, with the intercept (if
    requested) materialized first so it is scaled too. Runs in float64 on
    the host, since the rescaled K feeds the host eigendecomposition, and
    returns host numpy arrays with ``add_intercept`` consumed.
    """
    wv = to_numpy(weights, np.float64)
    if np.any(wv <= 0.0):
        # parity: reference warns on non-positive weights (src/wls.jl:35-37)
        warnings.warn("Some of the weights are not positive.")
    y = to_numpy(y, np.float64)
    g = to_numpy(g, np.float64)
    covar = to_numpy(covar, np.float64)
    n = y.shape[0]
    if add_intercept:
        covar = np.concatenate([np.ones((n, 1)), covar], axis=1)
    y = y * wv[:, None]
    g = g * wv[:, None]
    covar = covar * wv[:, None]
    K = wv[:, None] * to_numpy(K, np.float64) * wv[None, :]
    return y, g, covar, K, False
