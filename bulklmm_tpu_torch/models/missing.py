"""Missing-phenotype policy (COMPAT.md #18): ``missing="error"``, ``"mask"``
and ``"drop"``.

Counterpart of ``bulklmm_tpu/models/missing.py``.

- ``"error"`` (default): refuse non-finite phenotypes (:func:`finite_flag`
  starts the check on Y's device, :func:`raise_if_missing` reads it at the
  end of the scan).
- ``"mask"``: per-trait complete-case analysis. Traits are grouped by their
  missingness pattern (:func:`missing_groups`) and each group runs the
  whole engine on its own rows (its own kinship subset and
  eigendecomposition, its own effective n), then the results are stitched
  back trait-wise (:func:`stitch_results`). Exact, not a reweighting.
- ``"drop"``: one group, the individuals observed in every trait.

For one trait the two coincide (:func:`subset_rows_single`). A group with
fewer than c + 2 observations is refused by name; non-finite covariates or
weights are refused (they define the model of every trait). The streamed
engines subset their host marker panel lazily (:class:`RowSubsetView`) and
write each group through a column view of the caller's output
(:class:`ColSubsetOut`).
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from ..ops.lowrank import LowRankKinship, as_lowrank, is_lowrank
from ..ops.rotation import KinshipDecomposition, host_factors
from ..utils.host import to_numpy
from ..utils.profiling import span

_MODES = ("error", "mask", "drop")

#: observations needed beyond the covariate columns: the tested marker and
#: one residual degree of freedom
MIN_EXTRA_OBS = 2

#: above this many distinct missingness patterns, warn: each pattern is one
#: host eigendecomposition and one run of the engine
PATTERN_WARN_THRESHOLD = 64


def finite_flag(Y: torch.Tensor) -> torch.Tensor:
    """Start the finiteness check of ``Y``; :func:`raise_if_missing` reads it.

    One ``torch.isfinite(Y).all()`` on Y's device, read back only at the end
    of the scan, so the device keeps working meanwhile.
    """
    return torch.isfinite(Y).all()


def raise_if_missing(flag, what: str) -> None:
    """Read the guard's flag; refuse with the remediation recipe."""
    with span("bulklmm.sync.scalar"):
        finite = bool(flag)
    if not finite:
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


def missing_groups(finite: np.ndarray, *, drop: bool):
    """[(rows, traits)] index groups from the (n, m) finite mask.

    ``drop``: one group, the rows finite in every trait. Otherwise one group
    per distinct missingness pattern (column of the mask), in the patterns'
    lexicographic order (``np.unique``'s, as the JAX package groups them);
    rows and traits are strictly increasing. The patterns are sorted as
    bit-packed bytes: ``np.unique(..., axis=0)`` sorts rows of n booleans
    generically and took 1.4 s at 79 x 35,554.
    """
    if drop:
        return [(np.flatnonzero(finite.all(axis=1)), np.arange(finite.shape[1]))]
    keys = np.packbits(finite, axis=0).T  # (m, ceil(n / 8)), first individual in the top bit
    order = np.lexsort(keys.T[::-1])  # the first byte the primary key; stable
    ranked = keys[order]
    starts = np.flatnonzero(np.any(ranked[1:] != ranked[:-1], axis=1)) + 1
    groups = [(np.flatnonzero(finite[:, traits[0]]), traits) for traits in np.split(order, starts)]
    if len(groups) > PATTERN_WARN_THRESHOLD:
        warnings.warn(
            f"{len(groups)} distinct missingness patterns: each runs its own "
            "kinship decomposition and engine call. Consider missing='drop', "
            "or imputing rarely-observed traits.",
            stacklevel=3,
        )
    return groups


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
    """The kinship of the individuals ``rows``.

    - a raw K or a :class:`KinshipDecomposition`: ``K[rows][:, rows]`` of
      the matrix (from the decomposition's host factors where it has them)
      as a host float64 (n', n') array; the engine decomposes the subset
      anew, since its eigenvectors differ;
    - a ``LowRankKinship``: the exact, rank-preserving refactorization of
      ``U[rows] diag(lam) U[rows]^T``. With B = U[rows] sqrt(lam) and the
      (k, k) float64 eigendecomposition B^T B = V diag(mu) V^T, the subset
      is ``U' diag(mu) U'^T`` with orthonormal ``U' = B V mu^{-1/2}``
      (near-zero mu dropped: rows can lower the rank). U keeps its dtype
      and device.
    """
    if is_lowrank(K):
        lr = as_lowrank(K)
        U = to_numpy(lr.U, np.float64)[rows]
        lam = np.maximum(to_numpy(lr.lam, np.float64), 0.0)
        B = U * np.sqrt(lam)[None, :]
        mu, V = np.linalg.eigh(B.T @ B)
        keep = mu > 1e-12 * max(float(mu[-1]), 1.0)
        mu, V = mu[keep][::-1], V[:, keep][:, ::-1]  # descending
        Us = (B @ V) / np.sqrt(mu)[None, :]
        return LowRankKinship(
            U=torch.as_tensor(np.ascontiguousarray(Us), dtype=lr.U.dtype, device=lr.U.device),
            lam=torch.as_tensor(np.ascontiguousarray(mu), dtype=lr.lam.dtype, device=lr.lam.device),
        )
    if isinstance(K, KinshipDecomposition):
        Ut, lam = host_factors(K)
        return ((Ut.T * lam[None, :]) @ Ut)[np.ix_(rows, rows)]
    return to_numpy(K)[np.ix_(rows, rows)]


class RowSubsetView:
    """Lazy row subset of a host (n, p) array (numpy, ``np.memmap``, or any
    sliceable) for the streamed engines: a column block is sliced first (a
    view or a contiguous read), then the rows gathered, so the (n_obs, p)
    panel is never formed."""

    def __init__(self, G, rows: np.ndarray):
        self._g = G
        self._rows = np.asarray(rows)

    @property
    def shape(self):
        return (len(self._rows),) + tuple(self._g.shape[1:])

    @property
    def dtype(self):
        return self._g.dtype

    def __getitem__(self, idx):
        if isinstance(idx, tuple) and len(idx) == 2:
            r, c = idx
            return self._g[:, c][self._rows[r]]
        return self._g[self._rows[idx]]

    def __array__(self, dtype=None, copy=None):
        # the whole subset (the checkpoint fingerprint of a small panel);
        # without it np.asarray would wrap the view in a 0-d object array
        out = np.asarray(self._g[self._rows])
        return out.astype(dtype) if dtype is not None else out


class ColSubsetOut:
    """Write-through column subset of a host (p, m) output (numpy or
    ``np.memmap``): the streamed engine writes row slabs ``out[lo:hi] =
    blk``, which land on the group's trait columns of the caller's array."""

    def __init__(self, out, traits: np.ndarray):
        self._out = out
        self._traits = np.asarray(traits)

    @property
    def shape(self):
        return (self._out.shape[0], len(self._traits))

    @property
    def dtype(self):
        return self._out.dtype

    def __getitem__(self, idx):
        return self._out[idx, self._traits]

    def __setitem__(self, idx, value):
        self._out[idx, self._traits] = value


def maybe_masked(Y, missing: str, run_group, *, covar=None, weights=None,
                 add_intercept: bool = True, what: str):
    """The masked run, or None when ``missing="error"`` or Y is complete.

    ``run_group(Ys, rows, traits, gi)`` runs the engine on one pattern
    group's complete-case data (numpy float64 traits) and returns its result
    dataclass; :func:`stitch_results` puts the groups together.
    """
    validate_missing_kwarg(missing)
    if missing == "error":
        return None
    Y0 = to_numpy(Y)
    Y0 = Y0[:, None] if Y0.ndim == 1 else Y0
    if Y0.dtype.kind not in "fc":
        return None
    finite = np.isfinite(Y0)
    if finite.all():
        return None
    Yn = Y0.astype(np.float64, copy=False)
    _check_side_inputs(covar, weights, what)
    drop = missing == "drop"
    groups = missing_groups(finite, drop=drop)
    _check_group_sizes(groups, _ncov_total(covar, add_intercept), what=what, drop=drop)
    pairs = [
        (traits, run_group(Yn[np.ix_(rows, traits)], rows, traits, gi))
        for gi, (rows, traits) in enumerate(groups)
    ]
    return stitch_results(pairs, m=Yn.shape[1])


def group_checkpoint(checkpoint, gi: int):
    """The checkpoint subdirectory of pattern group ``gi`` (each group is a
    sweep of its own: its n, its shuffle indices, its fingerprint)."""
    if checkpoint is None:
        return None
    return os.path.join(str(checkpoint), f"pattern_{gi:03d}")


def _scatter(vals_by_traits, m: int, axis: int):
    """The stitched array: NaN where no group wrote, each group's values on
    its traits along ``axis``. Tensors stay tensors, on the first group's
    device and in its dtype."""
    first = vals_by_traits[0][1]
    shape = list(first.shape)
    shape[axis] = m
    if torch.is_tensor(first):
        dst = torch.full(shape, float("nan"), dtype=first.dtype, device=first.device)
    else:
        dst = np.full(shape, np.nan, dtype=np.asarray(first).dtype)
    for traits, v in vals_by_traits:
        idx = [slice(None)] * dst.ndim
        idx[axis] = torch.as_tensor(traits, device=dst.device) if torch.is_tensor(dst) else traits
        dst[tuple(idx)] = torch.as_tensor(v, device=dst.device) if torch.is_tensor(dst) else to_numpy(v)
    return dst


def stitch_results(pairs, m: int):
    """One result dataclass with m traits from the groups' [(traits, result)].

    Arrays scatter on their traits axis: axis 0 for ``maxlods`` (the
    permutation engines' (m, K) maxima), the last axis everywhere else
    ((p, m_g) matrices, (m_g,) vectors). Dict fields (LOCO's per-chromosome
    maps) scatter value by value; scalar fields must agree across groups
    and pass through.
    """
    first = pairs[0][1]
    if not dataclasses.is_dataclass(first):
        raise TypeError(f"cannot stitch {type(first)!r}")
    out = {}
    for f in dataclasses.fields(first):
        vals = [(traits, getattr(r, f.name)) for traits, r in pairs]
        v0 = vals[0][1]
        axis = 0 if f.name == "maxlods" else -1
        if v0 is None:
            out[f.name] = None
        elif isinstance(v0, dict):
            out[f.name] = {k: _scatter([(t, v[k]) for t, v in vals], m, axis) for k in v0}
        elif np.ndim(v0) == 0 and not torch.is_tensor(v0):
            if not all(v == v0 for _, v in vals):
                raise ValueError(
                    f"pattern groups disagree on scalar result field {f.name!r}: "
                    f"{[v for _, v in vals]!r}"
                )
            out[f.name] = v0
        else:
            out[f.name] = _scatter(vals, m, axis)
    return type(first)(**out)


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
