"""Single-trait genome scan: null and alt assumptions, permutation testing,
marker effects and the profile likelihood.

Counterpart of ``bulklmm_tpu/models/scan.py`` (reference ``scan`` and its
engines, src/scan.jl:94-557). A call runs, in order: argument checks, the
complete-case subset of a trait with missing values, optional
heteroskedastic weights (host float64), the intercept, the host float64
kinship eigendecomposition, then:

1. the rotation products of trait, markers and covariates, queued on the
   device (:func:`_rotate3`); they return without waiting;
2. meanwhile, the null model's fit on the host in float64
   (``ops/hostfit.py``), from the same eigenvectors, so that h2 is the same
   number on every device and in both packages; its c + 3 numbers go to the
   device in one copy;
3. the engine:

   - **null** (src/scan.jl:344-351): one shared-h2 correlation product,
     ``ops/liteqtl.py::lods_shared``, in place of the reference's per-marker
     RSS loop (the Frisch-Waugh identity);
   - **alt** (src/scan.jl:428-443): each marker's own h2 from one batched
     Brent over every marker (``ops/lmm.py::fit_h2_markers``), in place of
     the reference's per-marker loop. Its objective, the likelihood of
     ``[C, x_j]``, is ``ops/wls.py::wls_ell_markers`` (unrolled Cholesky),
     and the alternative likelihood is that objective's value at the
     optimum, where the JAX package refits each marker with QR;
   - **permutations** (src/scan.jl:485-557): the whitened null residual,
     shuffled, against the weighted, covariate-residualized markers: one
     (p x K) product.

A ``LowRankKinship`` (``ops/lowrank.py``) replaces steps 1-3 with the
rank-k engine (:func:`_scan_lowrank`): nothing is rotated, the host float64
null fit runs on the trait's (k,)-sized projections
(``ops/hostfit.py::fit_lmm_host_lowrank``), and each engine takes Woodbury
corrections in place of the rotation; permutations whiten explicitly.

None of these is a kernel of the JAX package (no ``pallas_call``): they are
plain products there and here.

Documented divergences from the reference (the JAX package's, kept):
``scan_alt`` in the reference passes sqrt-weights where weights are
expected; the default here evaluates the likelihood ratio with the
correctly-scaled weights and ``compat_sqrt_weights=True`` reproduces the
quirk (COMPAT.md #1). Alt LODs under ``reml=True`` are ratios of ML
likelihoods at the REML-fitted h2s, as in the reference.

Permutation indices come from ``ops/bulkperm.py::permutation_indices`` (a
seeded CPU ``torch.Generator``), not the JAX package's threefry: under a
seed alone the permutation columns match it in distribution only;
``perm_idx=`` takes the JAX package's indices for a column-by-column match.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..analysis.profile_ll import ProfileLL, _profile_rotated, check_marker_id
from ..ops import lowrank as lrmod
from ..ops.hostfit import HostFit, fit_lmm_host, fit_lmm_host_lowrank
from ..ops.liteqtl import _fast_log, lods_shared
from ..ops.lmm import fit_h2_markers
from ..ops.lod import lod2log10p, r2lod
from ..ops.rotation import KinshipDecomposition, resolve_kinship_with_host, transform_permute
from ..ops.smallchol import fwd_subst, pair_indices, residual_keep_mask, residual_sq, unrolled_cholesky
from ..ops.stats import check_covar_full_rank
from ..ops.weights import make_weights
from ..ops.wls import resid, wls_ell, wls_ell_markers
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import resolve_device
from ..utils.host import to_numpy
from .missing import subset_rows_single, validate_missing_kwarg
from .results import ScanResult

_LN10 = math.log(10.0)
_TODO = 'not ported to bulklmm_tpu_torch yet (ROADMAP.md "Still to port" item {})'


@with_highest_matmul()
def _rotate3(Ut, y, Xm, C):
    """Eigen-rotate trait, markers and covariates; queued on the device, it
    runs while the host fits the null model."""
    return Ut @ y, Ut @ Xm, Ut @ C


def _host_null_fit(y, covar, Ut_h, lam_h, prior, reml, optim_interval) -> HostFit:
    """Rotate the trait and covariates on the host in float64 and fit the
    null model there (``ops/hostfit.py``): the same h2 on every device, and
    bit for bit the JAX package's."""
    y_h = Ut_h @ np.asarray(y, dtype=np.float64)
    C_h = Ut_h @ np.asarray(covar, dtype=np.float64)
    return fit_lmm_host(y_h, C_h, lam_h, prior, reml=reml, optim_interval=optim_interval)


def _upload(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A host array on ``device`` in ``dtype``; to a card through pinned
    memory without waiting for the work queued there."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _null_fit_on_device(fit: HostFit, dtype, device):
    """(b (c, 1), sigma2, h2, ell) on ``device`` from one copy of the
    packed ``[b, sigma2, h2, ell]``."""
    b = np.asarray(fit.b, dtype=np.float64).ravel()
    v = _upload(np.concatenate([b, [fit.sigma2, fit.h2, fit.ell]]), dtype, device)
    c = b.size
    return v[:c, None], v[c], v[c + 1], v[c + 2]


def _collinear_keep(X0m, C0, method):
    """(p,) 1.0 where a marker keeps variance outside span(C0). Collinearity
    does not depend on h2 (x in span(C) iff W^1/2 x in span(W^1/2 C)), so one
    unweighted test covers every fitted h2 (COMPAT.md #15)."""
    Xr = resid(X0m, C0, method=method)
    return residual_keep_mask((Xr * Xr).sum(0), (X0m * X0m).sum(0))


@with_highest_matmul()
def _scan_null_impl(y0, X0m, C0, lam, h2, *, precision):
    """(p,) LODs at the null model's h2: one shared-h2 correlation step."""
    return lods_shared(y0, X0m, C0, lam, h2, precision=precision)[:, 0]


@with_highest_matmul()
def _scan_alt_impl(
    y0, X0m, C0, lam, h2_null, ell_null, *, prior, reml, method, optim_interval,
    compat_sqrt_weights=False,
):
    """(h2 per marker, LOD per marker): each marker's own Brent fit of
    ``[C0, x_j]``, the LOD its likelihood ratio against the null fit."""
    h2s, ells = fit_h2_markers(
        y0, C0, X0m, lam, prior, reml=reml, optim_interval=optim_interval
    )
    if compat_sqrt_weights:
        # the reference's quirk (src/scan.jl:432-440): both likelihoods
        # re-evaluated with sqrt(makeweights(h2)) passed as weights, and ML
        ell0 = wls_ell(y0, C0, torch.sqrt(make_weights(h2_null, lam)), prior)[0][0]
        ells = wls_ell_markers(y0, C0, X0m, torch.sqrt(make_weights(h2s, lam)), prior)[0]
    elif reml:
        # REML likelihoods are not comparable across designs with different
        # fixed effects; like the reference, the LOD is formed from ML
        # likelihoods at the REML-fitted h2s
        ell0 = wls_ell(y0, C0, make_weights(h2_null, lam), prior)[0][0]
        ells = wls_ell_markers(y0, C0, X0m, make_weights(h2s, lam), prior)[0]
    else:
        ell0 = ell_null.to(ells.dtype)
    lod = (ells - ell0) / _LN10
    # a marker collinear with the covariates adds nothing; its augmented
    # Gram is singular and the fitted likelihood noise: LOD 0 exactly, by
    # where (0 * NaN would leak a non-finite value through a multiply)
    lod = torch.where(_collinear_keep(X0m, C0, method) > 0, lod, torch.zeros_like(lod))
    return h2s, lod


@with_highest_matmul()
def _scan_perms_impl(
    y0, X0m, C0, lam, b, h2, *, method, nperms, rndseed, perm_idx, precision
):
    """(p, nperms + 1) LODs, column 0 the observed trait (reference
    transform_reweight + transform_permute, src/transform_helpers.jl:57-102,
    with the covariates and markers kept apart)."""
    r0 = y0 - C0 @ b
    # abs guard: the reference's sqrt.(abs.(makeweights(...)))
    # (src/bulkscan_helpers.jl:138) for slightly negative eigenvalues
    sqrtw = torch.sqrt(make_weights(h2, lam).abs())[:, None]
    w_r0 = r0 * sqrtw
    Xw = X0m * sqrtw
    X00 = resid(Xw, C0 * sqrtw, method=method)
    r0perm = transform_permute(w_r0, nperms=nperms, rndseed=rndseed, original=True, perm_idx=perm_idx)

    # a marker collinear with the covariates (or a trait they explain)
    # residualizes to rounding noise: 0/0 would NaN a row of L_perms, and
    # normalizing the noise would fabricate correlations; the relative rank
    # mask gives r = 0 exactly (COMPAT.md #15)
    tiny = torch.finfo(X00.dtype).tiny
    xx = (X00 * X00).sum(0)
    norm_y = torch.sqrt(torch.clamp((r0perm * r0perm).sum(0), min=tiny))
    norm_x = torch.sqrt(torch.clamp(xx, min=tiny))
    keep_x = residual_keep_mask(xx, (Xw * Xw).sum(0))
    keep_y = residual_keep_mask((w_r0 * w_r0).sum(), ((y0 * sqrtw) ** 2).sum())
    r0n = (r0perm * keep_y) / norm_y
    X00n = (X00 * keep_x[None, :]) / norm_x

    gdt = precision.resolve_gemm()
    L = X00n.T.to(gdt) @ r0n.to(gdt)
    return r2lod(L, y0.shape[0], fast_log=_fast_log(precision))


def _wald(cov, nx2, ny2, n, c):
    """(beta, se) from the residualized marker-trait covariance, the marker's
    and the trait's residual norms^2: SE from the marker's unbiased residual
    variance rss_j / (n - c - 1) (the GEMMA convention)."""
    nx2 = torch.clamp(nx2, min=torch.finfo(nx2.dtype).tiny)
    beta = cov / nx2
    rss_ = torch.clamp(ny2 - cov * cov / nx2, min=0.0)
    return beta, torch.sqrt(rss_ / max(n - c - 1, 1) / nx2)


def _effects_from_whitened(yt, Xt, Ct, *, method="qr"):
    """Per-marker GLS effects and Wald standard errors from
    Sigma^{-1/2}-scaled inputs: by Frisch-Waugh, b_j = <x_j^perp, y^perp> /
    ||x_j^perp||^2 with ^perp the residual against the whitened covariates.
    The reference outputs LODs only."""
    yperp = resid(yt, Ct, method=method)
    Xperp = resid(Xt, Ct, method=method)
    cov = (Xperp.T @ yperp)[:, 0]
    return _wald(cov, (Xperp * Xperp).sum(0), (yperp * yperp).sum(), *Ct.shape)


@with_highest_matmul()
def _effects_null_rotated(y0, X0m, C0, lam, h2, method):
    """Effects under one shared h2, from the scan's rotated operands."""
    sw = torch.sqrt(make_weights(h2, lam).abs())[:, None]
    return _effects_from_whitened(y0 * sw, X0m * sw, C0 * sw, method=method)


@with_highest_matmul()
def _effects_alt_rotated(y0, X0m, C0, lam, h2s):
    """Effects with each marker's own h2, from the scan's rotated operands.

    Per-marker weights make every Frisch-Waugh quantity a w-weighted Gram:
    thin products over n and the unrolled Cholesky (``ops/smallchol.py``),
    no per-marker QR.
    """
    n, c = C0.shape
    W = make_weights(h2s, lam).abs().T  # (n, p): marker j's weights
    y = y0[:, 0]

    pairs = pair_indices(c)
    CC = torch.stack([C0[:, a] * C0[:, b] for a, b in pairs], dim=1)  # (n, npair)
    Gv = CC.T @ W  # (npair, p)
    Lc = unrolled_cholesky({ab: Gv[i] for i, ab in enumerate(pairs)}, c)
    t = (C0 * y[:, None]).T @ W  # (c, p): C^T W y per marker
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    ny2 = residual_sq((y * y) @ W, zeta)

    XW = X0m * W  # (n, p): each marker column weighted
    xWx = (X0m * XW).sum(0)
    xWy = y @ XW
    Z = fwd_subst(Lc, [C0[:, a] @ XW for a in range(c)], c)
    cov = xWy
    for a in range(c):
        cov = cov - Z[a] * zeta[a]
    return _wald(cov, residual_sq(xWx, Z), ny2, n, c)


def _refuse_weights_on_factors(K, also: str = "") -> None:
    """Weights rescale K itself (K -> WKW): a cached decomposition or a
    rank-k factorization of K cannot follow them."""
    if isinstance(K, KinshipDecomposition) or lrmod.is_lowrank(K):
        raise ValueError(
            "weights rescale the kinship matrix (K -> WKW); pass the raw K, not a "
            f"cached decomposition{also}."
        )


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


def _one_trait(y, message: str) -> np.ndarray:
    """The trait as a host float64 (n, 1) array; the null fit reads it
    untruncated."""
    y = to_numpy(y, np.float64)
    y = y[:, None] if y.ndim == 1 else y
    if y.ndim != 2 or y.shape[1] != 1:
        raise ValueError(message)
    return y


def _rotated_with_null_fit(y, g, covar, K, *, decomp_scheme, prior, reml, optim_interval, dtype, device):
    """Queue the rotation on the device, then fit the null model on the
    host while it runs. Returns the rotated (y0, X0m, C0), lam and the null
    fit's (b, sigma2, h2, ell) on the device."""
    Ut, lam, Ut_h, lam_h = resolve_kinship_with_host(K, decomp_scheme, dtype, device)
    y0, X0m, C0 = _rotate3(Ut, _upload(y, dtype, device), g.to(dtype), _upload(covar, dtype, device))
    fit = _host_null_fit(y, covar, Ut_h, lam_h, prior, reml, optim_interval)
    return y0, X0m, C0, lam, _null_fit_on_device(fit, dtype, device)


def scan(
    y,
    g,
    K,
    covar=None,
    *,
    weights=None,
    prior_variance: float = 0.0,
    prior_sample_size: float = 0.0,
    add_intercept: bool = True,
    reml: bool = False,
    assumption: str = "null",
    method: str = "qr",
    optim_interval: int = 1,
    permutation_test: bool = False,
    nperms: int = 1024,
    rndseed: int = 0,
    profile_ll: bool = False,
    marker_id: int = 1,
    h2_grid=None,
    decomp_scheme: str = "eigen",
    output_pvals: bool = False,
    chisq_df: int = 1,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    compat_sqrt_weights: bool = False,
    output_effects: bool = False,
    missing: str = "error",
    perm_idx=None,
    device=None,
):
    """Genome scan for one quantitative trait: y (n,) or (n, 1), g (n, p),
    K (n, n), a :class:`KinshipDecomposition` or a ``LowRankKinship``
    (:func:`_scan_lowrank`).

    The keyword surface is the JAX package's ``scan`` (reference
    src/scan.jl:94-109): ``assumption`` "null" or "alt"; ``method`` "qr" or
    "cholesky"; covariates, heteroskedastic ``weights``, the
    Scaled-Inv-Chi^2 prior, REML/ML, permutation testing, the profile
    likelihood, eigen/svd decomposition, -log10 p-values, and
    ``missing="mask"/"drop"`` (they coincide for one trait: the scan runs on
    the individuals with a finite phenotype).

    ``compat_sqrt_weights`` (alt only) reproduces the reference's
    sqrt-weights quirk (COMPAT.md #1). ``output_effects`` attaches per-marker
    GLS effects and Wald standard errors (``beta``, ``beta_se``) under the
    null h2, or each marker's own h2 for "alt". ``perm_idx`` ((nperms + 1,
    n) integers, the identity first) gives the permutations in place of the
    seeded draw; under ``rndseed`` alone the columns match the JAX
    package's in distribution only. ``device`` defaults to the first
    tensor's among ``y``, ``g``, ``K`` and ``covar``, else the current CUDA
    device, and without one the call raises (``device="cpu"`` for the CPU;
    ``utils/device.py::resolve_device``).

    Returns a :class:`ScanResult` on the device; with ``profile_ll``, a
    ``(ScanResult, ProfileLL)`` tuple like the reference.
    """
    if assumption not in ("null", "alt"):
        raise ValueError("Assumption keyword is not supported. Please enter null or alt.")
    if assumption == "alt" and permutation_test:
        raise ValueError(
            "Permutation test option currently is not supported for the alternative assumption."
        )
    validate_missing_kwarg(missing)  # a typo'd policy must not pass silently
    device = resolve_device(device, y, g, K, covar)
    y = _one_trait(y, "scan handles one trait; use bulkscan for multiple traits.")
    if not np.isfinite(y).all():
        y, g, K, covar, weights = subset_rows_single(
            y, g, K, covar, weights, missing=missing, what="scan", add_intercept=add_intercept,
        )
        y = y.reshape(-1, 1)
    n = y.shape[0]
    lowrank = lrmod.is_lowrank(K)
    K_n = (
        K.Ut.shape[0] if isinstance(K, KinshipDecomposition)
        else np.shape(K.U)[0] if lowrank
        else np.shape(K)[0]
    )
    if np.shape(g)[0] != n or K_n != n:
        raise ValueError(
            f"Dimension mismatch: y has {n} samples, g has {np.shape(g)[0]}, K has {K_n}."
        )
    if covar is None:
        if not add_intercept:
            raise ValueError("Intercept has to be added when no other covariate is given.")
        covar = np.ones((n, 1))
        add_intercept = False
    else:
        covar = to_numpy(covar, np.float64)
        covar = covar[:, None] if covar.ndim == 1 else covar
        check_covar_full_rank(covar, add_intercept)
    if weights is not None:
        _refuse_weights_on_factors(K)
        y, g, covar, K, add_intercept = _apply_weights(y, g, covar, K, weights, add_intercept)
    g = torch.as_tensor(g, device=device)
    if add_intercept:
        covar = np.concatenate([np.ones((n, 1)), covar], axis=1)
    if profile_ll:
        check_marker_id(marker_id, g.shape[1])

    prior = (float(prior_variance), float(prior_sample_size))
    if lowrank:
        return _scan_lowrank(
            y, g, covar, K, prior=prior, reml=reml, assumption=assumption, method=method,
            optim_interval=optim_interval, permutation_test=permutation_test, nperms=nperms,
            rndseed=rndseed, profile_ll=profile_ll, marker_id=marker_id, h2_grid=h2_grid,
            output_pvals=output_pvals, chisq_df=chisq_df, precision=precision,
            compat_sqrt_weights=compat_sqrt_weights, output_effects=output_effects,
            perm_idx=perm_idx, device=device,
        )
    dtype = precision.resolve_solve()
    y0, X0m, C0, lam, (b, sigma2_e, h2, ell) = _rotated_with_null_fit(
        y, g, covar, K, decomp_scheme=decomp_scheme, prior=prior, reml=reml,
        optim_interval=optim_interval, dtype=dtype, device=device,
    )
    result = ScanResult(sigma2_e=sigma2_e, h2_null=h2, lod=None)
    if assumption == "alt":
        result.h2_each_marker, result.lod = _scan_alt_impl(
            y0, X0m, C0, lam, h2, ell, prior=prior, reml=reml, method=method,
            optim_interval=optim_interval, compat_sqrt_weights=compat_sqrt_weights,
        )
        if output_effects:
            result.beta, result.beta_se = _effects_alt_rotated(y0, X0m, C0, lam, result.h2_each_marker)
    else:
        if permutation_test:
            L = _scan_perms_impl(
                y0, X0m, C0, lam, b, h2, method=method, nperms=nperms, rndseed=rndseed,
                perm_idx=perm_idx, precision=precision,
            )
            result.lod, result.L_perms = L[:, 0], L[:, 1:]
        else:
            result.lod = _scan_null_impl(y0, X0m, C0, lam, h2, precision=precision)
        if output_effects:
            result.beta, result.beta_se = _effects_null_rotated(y0, X0m, C0, lam, h2, method)
    if output_pvals:
        result.log10pvals = lod2log10p(result.lod, chisq_df)
        if result.L_perms is not None:
            result.log10Pvals_perms = lod2log10p(result.L_perms, chisq_df)
    if not profile_ll:
        return result

    grid = _profile_grid(h2_grid, dtype, device)
    with with_highest_matmul():
        ll_null, ll_alt = _profile_rotated(
            y0, C0, X0m[:, marker_id - 1], lam, grid, prior, reml
        )
    result.ll_list_null, result.ll_list_alt = ll_null, ll_alt
    return result, ProfileLL(ll_list_null=ll_null, ll_list_alt=ll_alt)


def _profile_grid(h2_grid, dtype, device) -> torch.Tensor:
    """The profile likelihood's h2 grid on ``device``. The reference asks
    the caller for it (src/scan.jl:104); the default is the values of the
    JAX package's ``jnp.arange(0.0, 1.0, 0.05)``."""
    grid = np.arange(0.0, 1.0, 0.05) if h2_grid is None else h2_grid
    if not torch.is_tensor(grid):
        grid = np.asarray(to_numpy(grid), dtype=np.float64)
    return torch.as_tensor(grid, device=device).to(dtype)


@with_highest_matmul()
def _effects_lowrank_null(y, Xm, C, U, lam, h2, method):
    """Effects under the null h2 on a rank-k kinship: explicit
    ``Sigma^{-1/2}`` whitening (``ops/lowrank.py::whiten_lowrank``) feeds
    the rotated path's Frisch-Waugh effects."""
    return _effects_from_whitened(
        *(lrmod.whiten_lowrank(a, U, lam, h2) for a in (y, Xm, C)), method=method
    )


def _scan_lowrank(
    y, g, covar, K, *, prior, reml, assumption, method, optim_interval, permutation_test,
    nperms, rndseed, profile_ll, marker_id, h2_grid, output_pvals, chisq_df, precision,
    compat_sqrt_weights, output_effects, perm_idx, device,
):
    """The single-trait scan on a ``LowRankKinship``: the full-rank engines
    with rank-k Woodbury corrections in place of the rotation
    (``ops/lowrank.py``). The null h2 comes from the host float64 Brent run
    on the trait's (k,)-sized projections, the null LODs from the rank-k
    correlation step, the alt scan from a per-marker Brent on the (c+1)-dim
    augmented Gram, permutations from explicit ``Sigma^{-1/2}`` whitening.
    ``y`` and ``covar`` are host float64 (the intercept already in), ``g``
    a tensor on ``device``."""
    if compat_sqrt_weights:
        raise ValueError(
            "compat_sqrt_weights reproduces a quirk of the rotated full-rank "
            "path (COMPAT.md #1); it does not apply to LowRankKinship."
        )
    dtype = precision.resolve_solve()
    U, lam = lrmod.as_lowrank(K, dtype, device)
    yd, C, Xm = _upload(y, dtype, device), _upload(covar, dtype, device), g.to(dtype)
    n = yd.shape[0]
    proj = lrmod._trait_projections_lowrank(yd, C, U, precision=precision)
    fit = fit_lmm_host_lowrank(
        {k: to_numpy(v, np.float64) for k, v in proj.items()}, to_numpy(lam, np.float64), n,
        prior, reml=reml, optim_interval=optim_interval,
    )
    b, sigma2_e, h2, ell = _null_fit_on_device(fit, dtype, device)
    result = ScanResult(sigma2_e=sigma2_e, h2_null=h2, lod=None)
    if assumption == "alt":
        out = lrmod._scan_alt_lowrank_core(
            yd, Xm, C, U, lam, h2, n=n, prior=prior, reml=reml, optim_interval=optim_interval,
            precision=precision, effects=output_effects,
        )
        ells, result.h2_each_marker, ell0_ml = out[:3]
        # REML likelihoods are not comparable across designs: under REML
        # both sides are ML at the fitted h2s; under ML the host fit's ell
        # is the null reference
        result.lod = (ells - (ell0_ml if reml else ell.to(ells.dtype))) / _LN10
        if output_effects:
            result.beta, result.beta_se = out[3], out[4]
    elif permutation_test:
        L = lrmod.scan_perms_lowrank_kernel(
            yd, Xm, C, U, lam, b, h2, nperms=nperms, rndseed=rndseed, method=method,
            precision=precision, n=n, perm_idx=perm_idx,
        )
        result.lod, result.L_perms = L[:, 0], L[:, 1:]
        if output_effects:
            result.beta, result.beta_se = _effects_lowrank_null(yd, Xm, C, U, lam, h2, method)
    else:
        out = lrmod._scan_null_lowrank_core(
            yd, Xm, C, U, lam, h2, n=n, prior=prior, reml=reml, precision=precision,
            effects=output_effects,
        )
        result.lod = out[0]
        if output_effects:
            result.beta, result.beta_se = out[1], out[2]
    if output_pvals:
        result.log10pvals = lod2log10p(result.lod, chisq_df)
        if result.L_perms is not None:
            result.log10Pvals_perms = lod2log10p(result.L_perms, chisq_df)
    if not profile_ll:
        return result
    ll_null, ll_alt = lrmod._profile_ll_lowrank_core(
        yd, Xm, C, U, lam, _profile_grid(h2_grid, dtype, device), marker_id - 1, n=n,
        prior=prior, reml=reml, precision=precision,
    )
    result.ll_list_null, result.ll_list_alt = ll_null, ll_alt
    return result, ProfileLL(ll_list_null=ll_null, ll_list_alt=ll_alt)


def scan_perms_lite(
    y,
    g,
    covar,
    K,
    *,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    add_intercept: bool = True,
    method: str = "qr",
    optim_interval: int = 1,
    nperms: int = 1024,
    rndseed: int = 0,
    reml: bool = False,
    decomp_scheme: str = "eigen",
    output_pvals: bool = False,
    chisq_df: int = 1,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    missing: str = "error",
    perm_idx=None,
    device=None,
) -> ScanResult:
    """Standalone eigen-rotated permutation scan (reference
    src/scan.jl:485-557): ``lod`` is the observed trait's, ``L_perms`` the
    (p, nperms) permuted ones.

    The reference's default ``prior_variance = 1.0`` here differs from
    ``scan``'s 0.0 (src/scan.jl:487 vs :98); both defaults are mirrored.
    ``covar`` may have no column, (n, 0). ``K`` may be a ``LowRankKinship``
    (the rank-k permutation scan of :func:`scan`). ``perm_idx`` and
    ``device`` as for :func:`scan`.
    """
    validate_missing_kwarg(missing)
    device = resolve_device(device, y, g, K, covar)
    y = _one_trait(y, "Can only handle one trait.")
    if not np.isfinite(y).all():
        y, g, K, covar, _ = subset_rows_single(
            y, g, K, covar, None, missing=missing, what="scan_perms_lite",
            add_intercept=add_intercept,
        )
        y = y.reshape(-1, 1)
    covar = to_numpy(covar, np.float64)
    covar = covar[:, None] if covar.ndim == 1 else covar
    n = y.shape[0]
    if add_intercept:
        covar = np.concatenate([np.ones((n, 1)), covar], axis=1)
    dtype = precision.resolve_solve()
    prior = (float(prior_variance), float(prior_sample_size))
    if lrmod.is_lowrank(K):
        return _scan_lowrank(
            y, torch.as_tensor(g, device=device), covar, K, prior=prior, reml=reml,
            assumption="null", method=method, optim_interval=optim_interval,
            permutation_test=True, nperms=nperms, rndseed=rndseed, profile_ll=False,
            marker_id=0, h2_grid=None, output_pvals=output_pvals, chisq_df=chisq_df,
            precision=precision, compat_sqrt_weights=False, output_effects=False,
            perm_idx=perm_idx, device=device,
        )
    y0, X0m, C0, lam, (b, sigma2_e, h2, _) = _rotated_with_null_fit(
        y, torch.as_tensor(g, device=device), covar, K, decomp_scheme=decomp_scheme,
        prior=prior, reml=reml, optim_interval=optim_interval, dtype=dtype, device=device,
    )
    L = _scan_perms_impl(
        y0, X0m, C0, lam, b, h2, method=method, nperms=nperms, rndseed=rndseed,
        perm_idx=perm_idx, precision=precision,
    )
    result = ScanResult(sigma2_e=sigma2_e, h2_null=h2, lod=L[:, 0], L_perms=L[:, 1:])
    if output_pvals:
        result.log10pvals = lod2log10p(result.lod, chisq_df)
        result.log10Pvals_perms = lod2log10p(result.L_perms, chisq_df)
    return result
