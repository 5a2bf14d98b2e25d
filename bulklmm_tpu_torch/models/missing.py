"""Missing-phenotype policy: the ``missing="error"`` guard.

Counterpart of the guard half of ``bulklmm_tpu/models/missing.py``.
``"mask"`` and ``"drop"`` (pattern-grouped complete-case scans, COMPAT.md
#18) are validated here but not ported yet (ROADMAP.md "Still to port"
item 3).
"""

from __future__ import annotations

import numpy as np
import torch

_MODES = ("error", "mask", "drop")


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
