"""Missing-phenotype policy: the ``missing="error"`` guard and the
single-trait complete-case subset.

Counterpart of the guard and single-trait halves of
``bulklmm_tpu/models/missing.py``. For one trait ``"mask"`` and ``"drop"``
coincide: the scan runs on the individuals whose phenotype is finite
(:func:`subset_rows_single`), with the kinship subset to them. The
multi-trait pattern grouping (COMPAT.md #18) is not ported yet (ROADMAP.md
"Still to port" item 3): ``bulkscan`` and ``bulkscan_perms`` refuse
``"mask"`` and ``"drop"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rotation import KinshipDecomposition, host_factors
from ..utils.host import to_numpy

_MODES = ("error", "mask", "drop")

#: observations needed beyond the covariate columns: the tested marker and
#: one residual degree of freedom
MIN_EXTRA_OBS = 2


def finite_flag(Y: torch.Tensor) -> torch.Tensor:
    """Start the finiteness check of ``Y``; :func:`raise_if_missing` reads it.

    One ``torch.isfinite(Y).all()`` on Y's device, read back only at the end
    of the scan, so the device keeps working meanwhile.
    """
    return torch.isfinite(Y).all()


def raise_if_missing(flag, what: str) -> None:
    """Read the guard's flag; refuse with the remediation recipe."""
    if not bool(flag):
        raise ValueError(
            f"{what}: the phenotype matrix contains non-finite (missing) "
            "values. Pass missing='mask' for per-trait complete-case "
            "analysis (traits grouped by missingness pattern, one "
            "rotation per pattern) or missing='drop' to drop every "
            "individual with any missing trait (single rotation). "
            "See COMPAT.md #18."
        )


def validate_missing_kwarg(missing: str) -> None:
    if missing not in _MODES:
        raise ValueError(f"missing must be one of {_MODES}, got {missing!r}")


def _ncov_total(covar, add_intercept: bool) -> int:
    """Total covariate column count including the intercept."""
    if covar is None:
        return 1
    c = 1 if np.ndim(covar) == 1 else int(np.shape(covar)[1])
    return c + int(bool(add_intercept))


def _check_group_sizes(groups, ncov: int, *, what: str, drop: bool) -> None:
    """Refuse groups of ``(rows, traits)`` with too few observations to
    fit the covariates, the marker and one residual degree of freedom."""
    need = ncov + MIN_EXTRA_OBS
    bad = [(rows, traits) for rows, traits in groups if len(rows) < need]
    if not bad:
        return
    if drop:
        raise ValueError(
            f"{what}: missing='drop' leaves {len(bad[0][0])} fully-observed "
            f"individuals but the model needs at least {need} "
            f"({ncov} covariate columns + marker + residual df); use "
            "missing='mask' for per-trait complete-case analysis."
        )
    names = []
    for rows, traits in bad[:8]:
        t = ", ".join(map(str, traits[:6])) + ("..." if len(traits) > 6 else "")
        names.append(f"trait(s) [{t}] with {len(rows)} observations")
    raise ValueError(
        f"{what}: {sum(len(t) for _, t in bad)} trait(s) have fewer than "
        f"{need} observations ({ncov} covariate columns + marker + "
        f"residual df): " + "; ".join(names) + ". Drop or impute these "
        "traits before scanning."
    )


def _check_side_inputs(covar, weights, what: str) -> None:
    for name, a in (("covar", covar), ("weights", weights)):
        if a is not None and not np.all(np.isfinite(to_numpy(a))):
            raise ValueError(
                f"{what}: {name} contains non-finite values; missing "
                "covariates/weights are not maskable (they define the "
                "model for every trait) — impute or drop those "
                "individuals explicitly."
            )


def subset_kinship(K, rows: np.ndarray):
    """The kinship of the individuals ``rows``, as a host float64 (n', n')
    array: ``K[rows][:, rows]`` of a raw K, or of the matrix a
    :class:`KinshipDecomposition` factors (its host factors where it has
    them). The engine decomposes the subset anew: its eigenvectors differ."""
    if isinstance(K, KinshipDecomposition):
        Ut, lam = host_factors(K)
        return ((Ut.T * lam[None, :]) @ Ut)[np.ix_(rows, rows)]
    return to_numpy(K)[np.ix_(rows, rows)]


def subset_rows_single(y, g, K, covar, weights, *, missing: str, what: str,
                       add_intercept: bool = True):
    """Single-trait complete-case subset for ``scan`` / ``scan_perms_lite``:
    ``(y, g, K, covar, weights)`` restricted to the individuals whose
    phenotype is finite, or None when every one is. ``missing="error"``
    refuses a non-finite phenotype. A tensor ``g`` stays on its device; the
    LODs need no stitching, since p is unchanged."""
    validate_missing_kwarg(missing)
    yn = to_numpy(y, np.float64)
    y2 = yn[:, None] if yn.ndim == 1 else yn
    finite = np.isfinite(y2).all(axis=1)
    if missing == "error":
        raise_if_missing(finite.all(), what)
        return None
    if finite.all():
        return None
    _check_side_inputs(covar, weights, what)
    rows = np.flatnonzero(finite)
    _check_group_sizes([(rows, np.array([0]))], _ncov_total(covar, add_intercept),
                       what=what, drop=False)
    gs = g[torch.as_tensor(rows, device=g.device)] if torch.is_tensor(g) else to_numpy(g)[rows]
    cv = None if covar is None else to_numpy(covar)[rows]
    ws = None if weights is None else to_numpy(weights)[rows]
    return yn[rows], gs, subset_kinship(K, rows), cv, ws
