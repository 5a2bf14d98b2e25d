"""Low-rank kinship engine: LMM scans without the n x n eigendecomposition.

Counterpart of ``bulklmm_tpu/ops/lowrank.py``. The full-rank engines
(``ops/rotation.py`` + ``ops/liteqtl.py``) decompose K on the host (float64
``eigh``, O(n^3)) and upload the (n, n) eigenvectors; at cohort scale
(n >= 20,000) that dominates the wall time. This module keeps the top-k
eigenpairs ``K ~= U diag(lam) U^T`` and evaluates the LMM exactly for that
rank-k kinship through the Woodbury-style identity (nothing is rotated):

    (delta K + I)^{-1} = I + U diag(w - 1) U^T,   w_i = 1/(delta lam_i + 1)
    log|delta K + I|   = -sum_i log w_i

so every quadratic form the likelihood and the correlation step need is a
base (unweighted) term plus a k-dimensional correction:

    a' (delta K + I)^{-1} b = a'b + (U'a)' diag(w - 1) (U'b)

The h2-independent base Grams (X'Y, X'C, ...) are formed once; the
per-trait weight corrections become (p, k)(k, m) products with each
trait's factors folded into the (k, m) projection. Every product is a plain
``torch.matmul``, as the JAX package's are plain XLA products: the low-rank
engine runs no kernel of its own in either package.

The top-k eigenpairs come from randomized subspace iteration (Halko,
Martinsson & Tropp 2011) on the tensors' device: CholeskyQR2 orthonormalizes
the panel (an (l, l) Gram fetched to the host for a float64 Cholesky), and
one (l, l) host ``eigh`` finishes. ``kinship_lowrank_from_geno`` never forms
K: its product applies the reference definition (2 X X'/p + 0.5, unit
diagonal; reference src/kinship.jl:4-13) from the genotypes.

Results are the exact LMM of the truncated kinship ``U diag(lam) U'``;
their distance from the full-K LMM is set by the discarded tail.

Where this module differs from the JAX package's:

- the random start panel of the subspace iteration is drawn by a seeded CPU
  ``torch.Generator`` and uploaded, not by threefry: the two packages'
  randomized factors agree in subspace and spectrum, not bit for bit;
- the range-finding products run at the preset's own precision (the JAX
  package asks for bf16x3 ``Precision.HIGH`` there; this package has no
  TF32 path, and under the float64 presets HIGH has no effect in either);
- ``jax.vmap`` over traits, markers and grid points is batched tensor code,
  and ``jax.lax.scan`` over the alt-grid is a Python loop over grid points;
- null-exact's per-trait Brent runs in the solve dtype (float64 under
  BALANCED), as both packages' rotated engines do; the JAX package runs its
  rank-k one in the kernel dtype, whose float32 window (3.4e-4 in h2) can
  move BALANCED's LODs past the preset's 1e-4 from EXACT64's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import resolve_device
from ..utils.host import to_numpy
from .brent import gridbrent
from .liteqtl import _effects_from_nd, _fast_log
from .lod import r2lod
from .smallchol import (
    cancel_keep_mask, fwd_subst, pair_indices, residual_keep_mask, residual_sq,
    unrolled_cholesky,
)
from .weights import make_weights

_LN10 = math.log(10.0)


class LowRankKinship(NamedTuple):
    """Top-k eigenpairs of a kinship matrix: ``K ~= U diag(lam) U^T``.

    U: (n, k) orthonormal columns; lam: (k,) nonnegative, descending.
    """

    U: torch.Tensor
    lam: torch.Tensor

    @property
    def n(self) -> int:
        return self.U.shape[0]

    @property
    def rank(self) -> int:
        return self.U.shape[1]


def is_lowrank(K) -> bool:
    """Whether ``K`` is a factorization with ``U`` and ``lam`` (this
    package's :class:`LowRankKinship`, the JAX package's, or any such
    pair)."""
    return hasattr(K, "U") and hasattr(K, "lam")


def refuse_pallas(engine: str, *, perms: bool = False) -> None:
    """``engine="pallas"`` on a rank-k kinship raises the JAX package's
    ``ValueError``: the rank-k engine runs no kernel in either package."""
    if engine != "pallas":
        return
    if perms:
        raise ValueError(
            "engine='pallas' is not available for LowRankKinship inputs (the fused kernel "
            "assumes the rotated basis's diagonal whitening); use engine='xla' or 'auto'."
        )
    raise ValueError(
        "engine='pallas' is not available for LowRankKinship inputs (the rank-k engine is "
        "XLA-only)"
    )


def as_lowrank(K, dtype=None, device=None) -> LowRankKinship:
    """Anything with ``U`` and ``lam`` (the JAX package's ``LowRankKinship``
    through ``np.asarray``, numpy pairs, tensors) as this package's type, in
    ``dtype`` (default: U's own) on ``device`` (default: U's when it is a
    tensor, else the CPU)."""

    def tensor(a):
        if torch.is_tensor(a):
            return a.to(device=device if device is not None else a.device,
                        dtype=dtype if dtype is not None else a.dtype)
        t = torch.from_numpy(np.array(a))
        return t.to(device=device if device is not None else "cpu",
                    dtype=dtype if dtype is not None else t.dtype)

    return LowRankKinship(U=tensor(K.U), lam=tensor(K.lam))


def _correction_weights(h2, lam):
    """(w - 1) correction factors, ``w_i = 1/(delta lam_i + 1)``, with the
    full-rank path's h2 -> 1 clamp: :func:`ops.weights.make_weights` minus
    one."""
    return make_weights(h2, lam) - 1.0


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def _cholqr2(Y):
    """Orthonormalize the columns of a tall-skinny panel by CholeskyQR2.

    Two rounds of: the (l, l) Gram on the device, its float64 Cholesky and
    inverse on the host, one product ``Y @ inv(L)^T`` on the device. A
    numerically semidefinite panel takes an ``eigh`` whitening instead.
    """
    l = Y.shape[1]
    eps = float(torch.finfo(Y.dtype).eps)  # the Gram's accuracy is the panel dtype's
    for _ in range(2):
        G = to_numpy(Y.T @ Y, np.float64)
        # jitter relative to the panel dtype: the Gram squares the panel's
        # condition number, and a spectrally concentrated operator
        # collapses the panel toward its dominant eigenspace
        jitter = 100.0 * eps * (np.trace(G) / l)
        try:
            L = np.linalg.cholesky(G + jitter * np.eye(l))
            apply = np.linalg.inv(L).T
        except np.linalg.LinAlgError:
            # Y V w^{-1/2} has orthonormal columns; floored eigenvalues
            # re-randomize the collapsed directions on the next product
            w, V = np.linalg.eigh(0.5 * (G + G.T))
            w = np.maximum(w, eps * max(w.max(), 1.0))
            apply = V * (1.0 / np.sqrt(w))[None, :]
        Y = Y @ torch.as_tensor(apply, dtype=Y.dtype, device=Y.device)
    return Y


@with_highest_matmul()
def _randomized_eigh(matvec, n, k, *, oversample, iters, seed, dtype, device):
    """Top-k eigenpairs of an implicit symmetric PSD operator by subspace
    iteration. ``matvec`` maps (n, l) -> (n, l) on the device; the host
    factors only (l, l) matrices. The start panel is drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` and uploaded."""
    l = min(n, k + oversample)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    start = torch.randn((n, l), generator=gen, dtype=torch.float64)
    Q = _cholqr2(start.to(device=device, dtype=dtype))
    for _ in range(iters):
        Q = _cholqr2(matvec(Q))
    B = to_numpy(Q.T @ matvec(Q), np.float64)
    B = 0.5 * (B + B.T)
    evals, evecs = np.linalg.eigh(B)  # (l, l) host eigh
    order = np.argsort(evals)[::-1][:k]
    lam = np.maximum(evals[order], 0.0)
    U = Q @ torch.as_tensor(np.ascontiguousarray(evecs[:, order]), dtype=dtype, device=device)
    return LowRankKinship(U=U, lam=torch.as_tensor(lam, dtype=dtype, device=device))


def kinship_lowrank(
    K,
    k: int,
    *,
    oversample: int = 10,
    iters: int = 4,
    seed: int = 0,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    device=None,
) -> LowRankKinship:
    """Top-k eigenpairs of an explicit (n, n) kinship by randomized subspace
    iteration on the device: O(n^2 k) products instead of the host's O(n^3)
    ``eigh``, and no (n, n) eigenvectors. The products run in the preset's
    solve dtype. ``device`` defaults as for the scans
    (``utils/device.py::resolve_device``)."""
    dtype = precision.resolve_solve()
    device = resolve_device(device, K)
    Kd = torch.as_tensor(K, device=device).to(dtype)
    return _randomized_eigh(
        lambda Q: Kd @ Q, Kd.shape[0], k, oversample=oversample, iters=iters, seed=seed,
        dtype=dtype, device=device,
    )


def _centered_sq_rows(G, shift: float, block: int = 4096):
    """(n,) row sums of ``(G - shift)^2``, over column blocks so that no
    shifted copy of the panel exists."""
    out = torch.zeros(G.shape[0], dtype=G.dtype, device=G.device)
    for s in range(0, G.shape[1], block):
        out += (G[:, s : s + block] - shift).square().sum(1)
    return out


def kinship_lowrank_from_geno(
    geno,
    k: int,
    *,
    oversample: int = 10,
    iters: int = 4,
    seed: int = 0,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    device=None,
) -> LowRankKinship:
    """Top-k eigenpairs of ``calc_kinship(geno)`` without forming the (n, n)
    kinship: the product applies the reference definition (2 X X'/p + 0.5,
    unit diagonal; reference src/kinship.jl:4-13) as genotype products plus
    a rank-1 and a diagonal term. For n where n^2 itself is the wall.

    The panel is held in the preset's solve dtype: float32 under FAST32 and
    THROUGHPUT, float64 under BALANCED, MIXED and EXACT64 (20,000 x 50,000
    markers is 8 GB then, as in the JAX package, whose bf16x3 products run
    in float64 under those presets too).
    """
    dtype = precision.resolve_solve()
    device = resolve_device(device, geno)
    Gd = torch.as_tensor(geno, device=device).to(dtype)
    n, p = Gd.shape
    # the -0.5 shift is folded in algebraically (X = G - 0.5 J is a rank-1
    # update): the shifted (n, p) panel is never formed
    dfix = 1.0 - (2.0 * _centered_sq_rows(Gd, 0.5) / p + 0.5)  # K_ii = 1

    def matvec(Q):
        csum = Q.sum(0, keepdim=True)  # (1, l)
        XtQ = Gd.T @ Q - 0.5 * csum  # (p, l)
        XXtQ = Gd @ XtQ - 0.5 * XtQ.sum(0, keepdim=True)
        return (2.0 / p) * XXtQ + 0.5 * csum + dfix[:, None] * Q

    return _randomized_eigh(
        matvec, n, k, oversample=oversample, iters=iters, seed=seed, dtype=dtype, device=device,
    )


def kinship_lowrank_exact(K, k: int, *, dtype=None, device=None) -> LowRankKinship:
    """Top-k eigenpairs by host float64 ``eigh`` (exact; for tests and
    modest n), in ``dtype`` (default: K's) on ``device`` (default as for the
    scans)."""
    device = resolve_device(device, K)
    lam_all, U_all = np.linalg.eigh(to_numpy(K, np.float64))
    order = np.argsort(lam_all)[::-1][:k]
    if dtype is None:
        dtype = K.dtype if torch.is_tensor(K) else torch.as_tensor(np.asarray(K)[:0]).dtype
    return LowRankKinship(
        U=torch.as_tensor(np.ascontiguousarray(U_all[:, order]), dtype=dtype, device=device),
        lam=torch.as_tensor(np.maximum(lam_all[order], 0.0), dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# null likelihoods
# ---------------------------------------------------------------------------


def _wquad(base, corr):
    """Clamp a Woodbury-form quadratic total ``base + corr`` at zero.

    Every such total (``yWy = yty + sum(dm1 Q^2)``, marker norms, Gram
    diagonals) is a w-weighted squared norm, nonnegative in exact
    arithmetic, but the difference form can round negative in float32 for
    vectors (nearly) in span(U) as h2 -> 1 (dm1 -> -1). A negative total
    defeats ``residual_sq``'s relative floor: sigma2 floors at the dtype's
    tiny, the log-likelihood explodes to ~+1e35 and the h2 fit locks onto
    it. The clamp restores the full-rank engine's nonnegativity."""
    return torch.clamp(base + corr, min=0.0)


def _ell_from_parts(rss0, logw_sum, Lc, n, c, prior, reml):
    """The (RE)ML formulas of ``ops/wls.py::wls_ell`` with sum(log w) given
    directly (= -log|delta K + I|; the complement of span(U) adds 0)."""
    prior_a, prior_b = prior
    prior_df = prior_b + 2.0 if prior_b > 0.0 else prior_b
    denom = (n - c if reml else n) + prior_df
    sigma2 = torch.clamp((rss0 + prior_a * prior_b) / denom, min=torch.finfo(rss0.dtype).tiny)
    ell = -0.5 * ((n + prior_b) * torch.log(sigma2) - logw_sum + (rss0 + prior_a * prior_b) / sigma2)
    if reml:
        logdet = 2.0 * sum(torch.log(torch.abs(Lc[(i, i)])) for i in range(c))
        ell = ell + 0.5 * (c * torch.log(sigma2) - logdet)
    return ell, sigma2


def _wsum(dm1, V, per_trait: bool):
    """``sum_i dm1[..., i] V[i, j]``: one product when the factors are
    shared by every column j of V, else a batched dot with the factors'
    second-last axis running over the columns."""
    if per_trait:
        return (dm1 * V.T).sum(-1)
    return dm1 @ V


def _null_ell_sigma2(parts, lam, h2, prior, *, n, reml, per_trait: bool):
    """Null (ell, sigma2) of every trait from the k-dim projections.

    Shared h2 (``per_trait=False``): ``h2`` of any batch shape B, results
    B + (m,). Per-trait h2: ``h2`` of shape L + (m,), one h2 per trait and
    lane, results of that shape (the batched form of the JAX package's
    ``vmap`` of ``_null_ell_sigma2_one`` over traits)."""
    dm1 = _correction_weights(h2, lam)  # B + (k,)
    # a float64 h2 against float32 parts computes in float64, as in JAX
    dt = torch.promote_types(dm1.dtype, parts["Q"].dtype)
    CtC, CtY, yty, R, Q = (parts[k].to(dt) for k in ("CtC", "CtY", "yty", "R", "Q"))
    dm1 = dm1.to(dt)
    c = CtC.shape[0]

    def scalar(v):  # a per-h2 scalar against the (m,) trait axis
        return v if per_trait else v[..., None]

    yWy = _wquad(yty, _wsum(dm1, Q * Q, per_trait))
    t = [CtY[a] + _wsum(dm1, R[:, a : a + 1] * Q, per_trait) for a in range(c)]
    G = {}
    for a in range(c):
        for b in range(a, c):
            G[(a, b)] = scalar(CtC[a, b] + dm1 @ (R[:, a] * R[:, b]))
        G[(a, a)] = _wquad(G[(a, a)], 0.0)
    Lc = unrolled_cholesky(G, c)
    zeta = fwd_subst(Lc, t, c)
    rss0 = residual_sq(yWy, zeta)
    logw_sum = scalar(torch.log1p(dm1).sum(-1))
    return _ell_from_parts(rss0, logw_sum, Lc, n, c, prior, reml)


def null_ell_lowrank(parts, lam, h2, prior, *, n, reml=False):
    """(m,) null log-likelihoods of every trait at ONE h2, from the base
    Grams and k-dim projections (see :func:`_base_parts`)."""
    return _null_ell_sigma2(parts, lam, h2, prior, n=n, reml=reml, per_trait=False)[0]


def grid_null_ell_lowrank(parts, lam, h2_grid, prior, *, n, reml=False):
    """(g, m) null log-likelihoods over the h2 grid, batched over it."""
    return _null_ell_sigma2(parts, lam, h2_grid, prior, n=n, reml=reml, per_trait=False)[0]


def null_sigma2_lowrank(parts, lam, h2_list, prior, *, n, reml=False):
    """(m,) null ``sigma2_e`` of every trait at its OWN h2."""
    return _null_ell_sigma2(parts, lam, h2_list, prior, n=n, reml=reml, per_trait=True)[1]


def fit_h2_lowrank(parts, lam, prior, *, n, reml=False, optim_interval=1):
    """(m,) per-trait Brent null h2 on the rank-k likelihood, in ``lam``'s
    dtype (the engines pass the solve dtype's).

    Each likelihood evaluation is O(k + c^2) work a trait from the shared
    projections, so one batched Brent (``ops/brent.py``) advances all m
    fits a step at a time, with no (n,)-sized traffic.
    """
    m = parts["Q"].shape[1]

    def neg_ell(h2):  # (m, L) -> (m, L)
        return -_null_ell_sigma2(parts, lam, h2.T, prior, n=n, reml=reml, per_trait=True)[0].T

    _, h2 = gridbrent(neg_ell, 0.0, 1.0, optim_interval, batch_shape=(m,),
                      dtype=lam.dtype, device=lam.device)
    return h2


# ---------------------------------------------------------------------------
# parts: the h2-independent Grams and k-dim projections
# ---------------------------------------------------------------------------


def _parts_kwargs(precision: PrecisionConfig) -> dict:
    return dict(gemm_dtype=precision.resolve_gemm(), kernel_dtype=precision.resolve_kernel())


def _marker_side_parts(Xm, C, lr, *, gemm_dtype, kernel_dtype):
    """Marker-dependent Grams and k-dim projections (per marker block)."""
    gd, sd = gemm_dtype, kernel_dtype
    X, Cg, U = Xm.to(gd), C.to(gd), lr.U.to(gd)
    return dict(
        XtC=(X.T @ Cg).to(sd),  # (p, c)
        dXX=(X * X).to(sd).sum(0),  # (p,)
        P=(U.T @ X).to(sd),  # (k, p)
    )


def _shared_parts(C, lr, *, gemm_dtype, kernel_dtype):
    """Covariate-only Grams and projections."""
    gd, sd = gemm_dtype, kernel_dtype
    Cg, U = C.to(gd), lr.U.to(gd)
    return dict(R=(U.T @ Cg).to(sd), CtC=(Cg.T @ Cg).to(sd))  # (k, c), (c, c)


def _marker_parts(Xm, C, lr, **kw):
    """Trait-independent Grams and projections: formed once a scan, shared
    by every trait chunk."""
    return {**_marker_side_parts(Xm, C, lr, **kw), **_shared_parts(C, lr, **kw)}


def _trait_side_parts(Y, C, lr, *, gemm_dtype, kernel_dtype):
    """Trait-dependent, marker-independent Grams and projections."""
    gd, sd = gemm_dtype, kernel_dtype
    Yg, Cg, U = Y.to(gd), C.to(gd), lr.U.to(gd)
    return dict(
        Q=(U.T @ Yg).to(sd),  # (k, m)
        CtY=(Cg.T @ Yg).to(sd),  # (c, m)
        yty=(Yg * Yg).to(sd).sum(0),  # (m,)
    )


def _trait_parts(Y, Xm, C, lr, *, gemm_dtype, kernel_dtype):
    """Per-trait(-chunk) Grams and projections."""
    X, Yg = Xm.to(gemm_dtype), Y.to(gemm_dtype)
    return dict(
        XtY=(X.T @ Yg).to(kernel_dtype),  # (p, m)
        **_trait_side_parts(Y, C, lr, gemm_dtype=gemm_dtype, kernel_dtype=kernel_dtype),
    )


def _base_parts(Y, Xm, C, lr, **kw):
    """All h2-independent Grams and projections, each formed once."""
    return {**_marker_parts(Xm, C, lr, **kw), **_trait_parts(Y, Xm, C, lr, **kw)}


# ---------------------------------------------------------------------------
# LOD steps
# ---------------------------------------------------------------------------


def _keep_eps(precision: PrecisionConfig) -> float:
    """The eps of the least precise dtype the operands passed through."""
    return max(torch.finfo(precision.resolve_gemm()).eps, torch.finfo(precision.resolve_kernel()).eps)


def _nd_parts_lowrank(parts, lam, h2_per_trait, *, precision: PrecisionConfig = DEFAULT_PRECISION):
    """(N, D, nrm2) in each trait's weighted metric: the quantities of
    ``ops/liteqtl.py::_nd_parts_per_trait`` with rank-k Woodbury corrections
    in place of the rotation."""
    P, Q, R = parts["P"], parts["Q"], parts["R"]
    c = parts["CtC"].shape[0]

    Dm1 = _correction_weights(h2_per_trait, lam).T  # (k, m)
    Qd = Dm1 * Q  # (k, m)

    # trait-side scalars (Woodbury totals clamped nonnegative, see _wquad)
    yWy = _wquad(parts["yty"], (Q * Qd).sum(0))  # (m,)
    t = parts["CtY"] + R.T @ Qd  # (c, m)
    pairs = pair_indices(c)
    RR = torch.stack([R[:, a] * R[:, b] for a, b in pairs], dim=1)  # (k, npair)
    Gv = RR.T @ Dm1  # (npair, m)
    Gd = {
        ab: (_wquad(parts["CtC"][ab], Gv[i]) if ab[0] == ab[1] else parts["CtC"][ab] + Gv[i])
        for i, ab in enumerate(pairs)
    }
    Lc = unrolled_cholesky(Gd, c)
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    nrm2 = residual_sq(yWy, zeta)

    # marker-side (p, m) terms: base + rank-k correction products
    PT = P.T
    B = parts["XtY"] + PT @ Qd  # (p, m)
    Uc = [parts["XtC"][:, a : a + 1] + PT @ (Dm1 * R[:, a : a + 1]) for a in range(c)]
    D1 = _wquad(parts["dXX"][:, None], (P * P).T @ Dm1)  # (p, m)

    Z = fwd_subst(Lc, Uc, c)
    N = B
    for a in range(c):
        N = N - Z[a] * zeta[a][None, :]
    D = residual_sq(D1, Z)
    # zero-information columns give r = 0 exactly (COMPAT.md #15); D and
    # nrm2 are differences of squares -> the linear-in-eps mask
    eps = _keep_eps(precision)
    keep = cancel_keep_mask(D, D1, eps=eps) * cancel_keep_mask(nrm2, yWy, eps=eps)[None, :]
    return N * keep, D, nrm2


def lods_per_trait_lowrank(parts, lam, h2_per_trait, n, *, precision: PrecisionConfig = DEFAULT_PRECISION):
    """(p, m) LOD with a distinct h2 per trait, rank-k weights: the epilogue
    of ``ops/liteqtl.py::weighted_correlation_per_trait``."""
    N, D, nrm2 = _nd_parts_lowrank(parts, lam, h2_per_trait, precision=precision)
    den = torch.clamp(D * nrm2[None, :], min=torch.finfo(D.dtype).tiny)
    return r2lod(N / torch.sqrt(den), n, fast_log=_fast_log(precision))


def lods_shared_lowrank(parts, lam, h2, n, *, precision: PrecisionConfig = DEFAULT_PRECISION):
    """(p, m) LOD at ONE h2 shared by every trait, rank-k weights.

    With one h2 the covariate projections of the markers, their norms and
    the covariate Gram do not depend on the trait: (p,) vectors and scalars
    in place of (p, m) panels, c + 1 matrix-vector products in place of
    (p, k)(k, m) products. The alt-grid loop's step.
    """
    P, Q, R = parts["P"], parts["Q"], parts["R"]
    c = parts["CtC"].shape[0]

    dm1 = _correction_weights(h2, lam)  # (k,)
    Qd = dm1[:, None] * Q  # (k, m)
    yWy = _wquad(parts["yty"], (Q * Qd).sum(0))  # (m,)
    t = parts["CtY"] + R.T @ Qd  # (c, m)
    G = {}
    for a in range(c):
        for b in range(a, c):
            G[(a, b)] = parts["CtC"][a, b] + (R[:, a] * R[:, b] * dm1).sum()
        G[(a, a)] = torch.clamp(G[(a, a)], min=0.0)
    Lc = unrolled_cholesky(G, c)
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    nrm2 = residual_sq(yWy, zeta)

    PT = P.T
    B = parts["XtY"] + PT @ Qd  # (p, m)
    Uc = [parts["XtC"][:, a] + PT @ (dm1 * R[:, a]) for a in range(c)]  # c x (p,)
    D1 = _wquad(parts["dXX"], (P * P).T @ dm1)  # (p,)

    Z = fwd_subst(Lc, Uc, c)
    N = B
    for a in range(c):
        N = N - Z[a][:, None] * zeta[a][None, :]
    D = residual_sq(D1, Z)
    eps = _keep_eps(precision)
    keep = cancel_keep_mask(D, D1, eps=eps)[:, None] * cancel_keep_mask(nrm2, yWy, eps=eps)[None, :]
    den = torch.clamp(D[:, None] * nrm2[None, :], min=torch.finfo(D.dtype).tiny)
    return r2lod((N * keep) / torch.sqrt(den), n, fast_log=_fast_log(precision))


def lods_and_effects_lowrank(parts, lam, h2_per_trait, n, *, precision: PrecisionConfig = DEFAULT_PRECISION):
    """(lod, beta, se), each (p, m), from ONE rank-k parts pass."""
    c = parts["CtC"].shape[0]
    N, D, nrm2 = _nd_parts_lowrank(parts, lam, h2_per_trait, precision=precision)
    den = torch.clamp(D * nrm2[None, :], min=torch.finfo(D.dtype).tiny)
    lod = r2lod(N / torch.sqrt(den), n, fast_log=_fast_log(precision))
    return (lod, *_effects_from_nd(N, D, nrm2, n, c))


# ---------------------------------------------------------------------------
# alternative model
# ---------------------------------------------------------------------------


def _alt_grid_lowrank(parts, lam, h2_grid, prior, *, n, precision, reml=False):
    """Grid-approximated exact LMM on the rank-k kinship: the running
    maximum of each (marker, trait)'s alternative log-likelihood over the h2
    grid (logL1 = LOD ln10 + ell0), its first argmax carried as the grid
    index. Returns (L, h2_panel)."""
    p, m = parts["P"].shape[1], parts["Q"].shape[1]
    dt, dev = parts["Q"].dtype, parts["Q"].device
    logL1_max = torch.full((p, m), -math.inf, dtype=dt, device=dev)
    kmax = torch.zeros((p, m), dtype=torch.int32, device=dev)
    logL0_max = torch.full((m,), -math.inf, dtype=dt, device=dev)
    for k in range(h2_grid.shape[0]):
        h2 = h2_grid[k]
        lod_k = lods_shared_lowrank(parts, lam, h2, n, precision=precision)
        ell0 = null_ell_lowrank(parts, lam, h2, prior, n=n, reml=reml)
        logL1 = lod_k * _LN10 + ell0[None, :]
        upd = logL1 > logL1_max  # strict: the first maximum wins
        logL1_max = torch.where(upd, logL1, logL1_max)
        kmax.masked_fill_(upd, k)
        logL0_max = torch.maximum(logL0_max, ell0)
        del lod_k, logL1, upd
    L = (logL1_max - logL0_max[None, :]) / _LN10
    return L, h2_grid[kmax]


def _aug_ell_lowrank(CtC, R, lam, Q1, CtY1, yty1, XtC, P, dXX, XtY, h2, prior, *, n, reml):
    """Alternative log-likelihood of one trait with each marker joining the
    design through the shared projections: the (c+1)-dim augmented Gram
    from base + rank-k corrections. ``XtC`` (p, c), ``P`` (k, p), ``dXX`` and
    ``XtY`` (p,); ``h2`` (p, L), one row of lanes a marker. Returns (p, L)."""
    c = CtC.shape[0]
    dm1 = _correction_weights(h2, lam)  # (p, L, k)
    PT = P.T  # (p, k)

    def per_marker(V):  # (p, k) -> (p, L): sum_i dm1[j, l, i] V[j, i]
        return torch.einsum("plk,pk->pl", dm1, V)

    yWy = _wquad(yty1, dm1 @ (Q1 * Q1))
    G = {}
    for a in range(c):
        for b in range(a, c):
            G[(a, b)] = CtC[a, b] + dm1 @ (R[:, a] * R[:, b])
        G[(a, a)] = torch.clamp(G[(a, a)], min=0.0)
    for a in range(c):
        G[(a, c)] = XtC[:, a : a + 1] + per_marker(PT * R[:, a])
    G[(c, c)] = _wquad(dXX[:, None], per_marker(PT * PT))
    t = [CtY1[a] + dm1 @ (R[:, a] * Q1) for a in range(c)]
    t.append(XtY[:, None] + per_marker(PT * Q1))
    Lc = unrolled_cholesky(G, c + 1)
    zeta = fwd_subst(Lc, t, c + 1)
    rss = residual_sq(yWy, zeta)
    logw_sum = torch.log1p(dm1).sum(-1)
    return _ell_from_parts(rss, logw_sum, Lc, n, c + 1, prior, reml)[0]


def scan_alt_h2_ells_lowrank(parts, lam, prior, *, n, reml=False, optim_interval=1, ml_ells=False):
    """Per-marker Brent alt fit on the rank-k likelihood (one trait):
    ``(ells, h2s)``, each (p,). Each likelihood evaluation builds the
    (c+1)-dim Gram in O(k c) work a marker, batched over markers and lanes.
    ``ml_ells`` re-evaluates the likelihood with ML at the fitted h2: REML
    likelihoods are not comparable across designs (reference src/wls.jl:29)."""
    args = (parts["CtC"], parts["R"], lam, parts["Q"][:, 0], parts["CtY"][:, 0], parts["yty"][0],
            parts["XtC"], parts["P"], parts["dXX"], parts["XtY"][:, 0])

    def neg_ell(h2):  # (p, L) -> (p, L)
        return -_aug_ell_lowrank(*args, h2, prior, n=n, reml=reml)

    fmin, h2 = gridbrent(neg_ell, 0.0, 1.0, optim_interval, batch_shape=(parts["P"].shape[1],),
                         dtype=lam.dtype, device=lam.device)
    if ml_ells:
        return _aug_ell_lowrank(*args, h2[:, None], prior, n=n, reml=False)[:, 0], h2
    return -fmin, h2


def effects_alt_per_marker_lowrank(parts, lam, h2s, n):
    """(beta, se) with each marker's own fitted h2, rank-k weights: every
    w-weighted inner product is its base Gram plus a rank-k correction with
    the factors varying per marker; no per-marker whitening."""
    CtC, R, P = parts["CtC"], parts["R"], parts["P"]
    Q1, CtY1, yty1 = parts["Q"][:, 0], parts["CtY"][:, 0], parts["yty"][0]
    c = CtC.shape[0]

    Dm1 = _correction_weights(h2s, lam).T  # (k, p): marker j's corrections
    pairs = pair_indices(c)
    RR = torch.stack([R[:, a] * R[:, b] for a, b in pairs], dim=1)  # (k, npair)
    Gv = RR.T @ Dm1  # (npair, p)
    Gd = {
        ab: (_wquad(CtC[ab], Gv[i]) if ab[0] == ab[1] else CtC[ab] + Gv[i])
        for i, ab in enumerate(pairs)
    }
    Lc = unrolled_cholesky(Gd, c)

    RQ = R * Q1[:, None]  # (k, c)
    t = CtY1[:, None] + RQ.T @ Dm1  # (c, p)
    zeta = fwd_subst(Lc, [t[a] for a in range(c)], c)
    yWy = _wquad(yty1, (Q1 * Q1) @ Dm1)  # (p,)
    ny2 = residual_sq(yWy, zeta)

    xWx = _wquad(parts["dXX"], (P * P * Dm1).sum(0))  # (p,)
    xWy = parts["XtY"][:, 0] + (P * Dm1 * Q1[:, None]).sum(0)
    xWC = [parts["XtC"][:, a] + (P * Dm1 * R[:, a][:, None]).sum(0) for a in range(c)]
    Z = fwd_subst(Lc, xWC, c)
    nx2 = torch.clamp(residual_sq(xWx, Z), min=torch.finfo(yWy.dtype).tiny)
    cov = xWy
    for a in range(c):
        cov = cov - Z[a] * zeta[a]
    beta = cov / nx2
    rss = torch.clamp(ny2 - cov * cov / nx2, min=0.0)
    se = torch.sqrt(rss / max(n - c - 1, 1) / nx2)
    return beta, se


# ---------------------------------------------------------------------------
# explicit whitening: permutations and effects
# ---------------------------------------------------------------------------


def whiten_lowrank(A, U, lam, h2):
    """``Sigma^{-1/2} A`` for ``Sigma = delta K_k + I`` (up to the global
    ``1/sqrt(1-h2)``, which cancels in correlations): with the rank-k
    spectral form ``Sigma^{-1/2} = I + U diag(sqrt(w)-1) U'``, two (n, k)
    products an operand."""
    s = torch.sqrt(1.0 + _correction_weights(h2, lam)) - 1.0  # (k,)
    return A + U @ (s[:, None] * (U.T @ A))


@with_highest_matmul()
def scan_perms_lowrank_kernel(y, Xm, C, U, lam, b, h2, *, nperms, rndseed, method, precision, n,
                              perm_idx=None):
    """(p, 1 + nperms) permutation LODs on the rank-k kinship.

    Whitens the null residual, the covariates and the markers with the
    rank-k ``Sigma^{-1/2}`` (the whitened residual's entries are
    exchangeable under the null: the unrotated analog of permuting the
    rotated, reweighted residual, reference src/transform_helpers.jl:57-102),
    then residualizes, normalizes and correlates as the full-rank
    permutation scan does. Plain products, as in the JAX package, whose
    name for it says "kernel". ``perm_idx`` as for ``transform_permute``.
    """
    from .rotation import transform_permute
    from .wls import resid

    r0 = y - C @ b  # (n, 1)
    w_r0 = whiten_lowrank(r0, U, lam, h2)
    Cw = whiten_lowrank(C, U, lam, h2)
    Xw = whiten_lowrank(Xm, U, lam, h2)
    X00 = resid(Xw, Cw, method=method)

    r0perm = transform_permute(w_r0, nperms=nperms, rndseed=rndseed, original=True, perm_idx=perm_idx)
    # collinear-with-covariates columns (and fully explained traits)
    # residualize to rounding noise: the relative rank mask gives r = 0
    # (COMPAT.md #15); the tiny floor still guards 0/0
    yw = whiten_lowrank(y, U, lam, h2)
    tiny = torch.finfo(X00.dtype).tiny
    xx = (X00 * X00).sum(0)
    norm_y = torch.sqrt(torch.clamp((r0perm * r0perm).sum(0), min=tiny))
    norm_x = torch.sqrt(torch.clamp(xx, min=tiny))
    keps = torch.finfo(precision.resolve_kernel()).eps
    keep_x = residual_keep_mask(xx, (Xw * Xw).sum(0), eps=keps)
    keep_y = residual_keep_mask((w_r0 * w_r0).sum(), (yw * yw).sum(), eps=keps)
    r0n = (r0perm * keep_y) / norm_y
    X00n = (X00 * keep_x[None, :]) / norm_x
    gdt = precision.resolve_gemm()
    L = X00n.T.to(gdt) @ r0n.to(gdt)
    return r2lod(L, n, fast_log=_fast_log(precision))


# ---------------------------------------------------------------------------
# cores: what the entry points call
# ---------------------------------------------------------------------------


@with_highest_matmul()
def _bulkscan_lowrank_core(Y, Xm, C, U, lam, h2_grid, *, n, prior, reml, precision,
                           trait_chunk=None, method="null-grid", optim_interval=1, effects=False):
    """``bulkscan`` on a rank-k kinship: (L, h2_list[, beta, se]) from the
    null methods, (L, h2_panel) from alt-grid. The marker-side parts are
    formed once and shared by the trait chunks."""
    from ..models.bulkscan import _chunked

    lr = LowRankKinship(U=U, lam=lam)
    kdt = precision.resolve_kernel()
    kw = _parts_kwargs(precision)
    mparts = _marker_parts(Xm, C, lr, **kw)
    lam_k = lam.to(kdt)

    def impl(Yc):
        parts = {**mparts, **_trait_parts(Yc, Xm, C, lr, **kw)}
        if method == "alt-grid":
            return _alt_grid_lowrank(parts, lam_k, h2_grid.to(kdt), prior, n=n,
                                     precision=precision, reml=reml)
        if method == "null-exact":  # Brent in the solve dtype (module docstring)
            h2_list = fit_h2_lowrank(parts, lam, prior, n=n, reml=reml,
                                     optim_interval=optim_interval)
        else:
            ells = grid_null_ell_lowrank(parts, lam_k, h2_grid.to(kdt), prior, n=n, reml=reml)
            h2_list = h2_grid[torch.argmax(ells, dim=0)]  # first max wins
        if effects:
            L, beta, se = lods_and_effects_lowrank(parts, lam_k, h2_list.to(kdt), n, precision=precision)
            return L, h2_list, beta, se
        return lods_per_trait_lowrank(parts, lam_k, h2_list.to(kdt), n, precision=precision), h2_list

    return _chunked(impl, Y, trait_chunk)


@with_highest_matmul()
def _trait_projections_lowrank(y, C, U, *, precision):
    """The (k,)- and (c,)-sized projections of one trait for the host null
    fit, in the kernel dtype."""
    gd, sd = precision.resolve_gemm(), precision.resolve_kernel()
    Yg, Cg, Ug = y.to(gd), C.to(gd), U.to(gd)
    return dict(
        CtC=(Cg.T @ Cg).to(sd),
        CtY=(Cg.T @ Yg)[:, 0].to(sd),
        yty=(Yg * Yg).to(sd).sum(),
        R=(Ug.T @ Cg).to(sd),
        Q=(Ug.T @ Yg)[:, 0].to(sd),
    )


@with_highest_matmul()
def _scan_null_lowrank_core(y, Xm, C, U, lam, h2, *, n, prior, reml, precision, effects=False):
    """(lod,) or (lod, beta, se), each (p,), at the null h2."""
    lr = LowRankKinship(U=U, lam=lam)
    kdt = precision.resolve_kernel()
    parts = _base_parts(y, Xm, C, lr, **_parts_kwargs(precision))
    h2v = h2.reshape(1).to(kdt)
    if effects:
        L, beta, se = lods_and_effects_lowrank(parts, lam.to(kdt), h2v, n, precision=precision)
        return L[:, 0], beta[:, 0], se[:, 0]
    return (lods_per_trait_lowrank(parts, lam.to(kdt), h2v, n, precision=precision)[:, 0],)


@with_highest_matmul()
def _scan_alt_lowrank_core(y, Xm, C, U, lam, h2_null, *, n, prior, reml, optim_interval,
                           precision, effects=False):
    """(ells, h2s, ell0[, beta, se]): per-marker alt fits, and the GLS
    effects from the same parts pass. Under REML the LOD-forming likelihoods
    (alt and null) are re-evaluated with ML at the fitted h2s; under ML the
    caller takes the host fit's null ell, so ell0 is 0 then."""
    lr = LowRankKinship(U=U, lam=lam)
    kdt = precision.resolve_kernel()
    parts = _base_parts(y, Xm, C, lr, **_parts_kwargs(precision))
    lam_k = lam.to(kdt)
    ells, h2s = scan_alt_h2_ells_lowrank(parts, lam_k, prior, n=n, reml=reml,
                                         optim_interval=optim_interval, ml_ells=reml)
    ell0 = (null_ell_lowrank(parts, lam_k, h2_null, prior, n=n, reml=False)[0]
            if reml else torch.zeros((), dtype=ells.dtype, device=ells.device))
    if effects:
        return (ells, h2s, ell0) + effects_alt_per_marker_lowrank(parts, lam_k, h2s, n)
    return ells, h2s, ell0


@with_highest_matmul()
def _profile_ll_lowrank_core(y, Xm, C, U, lam, h2_grid, marker_id, *, n, prior, reml, precision):
    """(ll_list_null, ll_list_alt) over the h2 grid for one marker (0-based
    ``marker_id``): the rank-k counterpart of ``analysis/profile_ll.py``.
    Only that marker's column enters the projections."""
    lr = LowRankKinship(U=U, lam=lam)
    kdt = precision.resolve_kernel()
    parts = _base_parts(y, Xm[:, marker_id : marker_id + 1], C, lr, **_parts_kwargs(precision))
    lam_k = lam.to(kdt)
    hk = h2_grid.to(kdt)
    ll_null = grid_null_ell_lowrank(parts, lam_k, hk, prior, n=n, reml=reml)[:, 0]
    ll_alt = _aug_ell_lowrank(
        parts["CtC"], parts["R"], lam_k, parts["Q"][:, 0], parts["CtY"][:, 0], parts["yty"][0],
        parts["XtC"], parts["P"], parts["dXX"], parts["XtY"][:, 0], hk[None, :], prior,
        n=n, reml=reml,
    )[0]
    return ll_null, ll_alt
