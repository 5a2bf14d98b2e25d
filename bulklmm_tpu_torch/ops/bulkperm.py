"""Bulk (multi-trait) permutation-scan math: per-trait whitened-residual
permutation null maxima for every trait at once.

Counterpart of ``bulklmm_tpu/ops/bulkperm.py`` (its full-rank half). The
reference permutation-tests one trait per call (``scan_perms_lite``,
src/scan.jl:485-557): whiten the null residual with the trait's
sqrt-weights, shuffle it, correlate with the weighted, covariate-
residualized markers, keep each permutation's genome-wide maximum. Two
identities batch that over traits:

1. **Self-adjoint residualization.** ``I - Q_j Q_j^T`` is symmetric, so
   ``<(I-P_j) W_j^{1/2} x_i, s> = <W_j^{1/2} x_i, (I-P_j) s>``: the numerator
   is a product of the raw markers against per-trait quantities, and no
   per-trait (n, p) marker matrix is formed.
2. **Monotone max.** LOD is monotone in r^2, so the genome-wide max LOD per
   (trait, permutation) is a max of ``num^2 / (xn * nrm2)`` over markers,
   folded into the correlation product; the (p, m, nperms) LOD tensor never
   exists. ``kernels/bulkperm_fused.py`` is that fused form;
   :func:`max_r2_perms_plain` here is the chunked formulation in the
   preset's own dtypes (MIXED, EXACT64, the CPU, and the oracle).

Permutation indices are shared across traits. The JAX package draws them
with its threefry generator, which torch cannot reproduce:
:func:`permutation_indices` draws with a seeded ``torch.Generator`` on the
CPU, so the same seed gives the same indices on the CPU and on a card, but
not the JAX package's. Against that package, parity of the permutation
columns is distributional only, unless its indices are passed in
(``bulkscan_perms(perm_idx=...)``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import memory
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.host import to_numpy
from .liteqtl import _fast_log
from .smallchol import (
    cancel_keep_mask, fwd_subst, pair_indices, residual_keep_mask, residual_sq,
    unrolled_cholesky,
)
from .weights import make_weights


def _n_columns(nperms: int, original: bool) -> int:
    if nperms < 0 or (nperms == 0 and not original):
        raise ValueError(
            "The required number of permutations must be a positive integer "
            "(nperms=0 is allowed only with original=True, which keeps just "
            "the observed column)."
        )
    return nperms + int(bool(original))


def permutation_indices(n: int, nperms: int, rndseed, *, original: bool = True):
    """(K, n) int64 shuffle indices on the CPU, K = nperms (+1 identity row
    first when ``original=True``); row k is applied as ``x[idx[k]]``.

    One ``torch.randperm`` per row from a CPU ``torch.Generator`` seeded
    with ``rndseed`` (or ``rndseed`` itself when it is such a generator,
    which the draws then advance): deterministic in the seed and
    independent of the device the scan runs on.
    """
    _n_columns(nperms, original)
    if isinstance(rndseed, torch.Generator):
        gen = rndseed
    else:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(rndseed))
    rows = [torch.arange(n)] if original else []
    rows += [torch.randperm(n, generator=gen) for _ in range(nperms)]
    return torch.stack(rows)


def check_permutation_indices(perm_idx, n: int, nperms: int, *, original: bool = True):
    """``perm_idx`` as (K, n) int64 CPU indices, refused unless it has
    K = nperms (+1 when ``original``) rows that are each a permutation of
    0..n-1, the first the identity when ``original``."""
    K = _n_columns(nperms, original)
    idx = to_numpy(perm_idx)
    if idx.dtype.kind not in "iu":
        raise TypeError(f"perm_idx must hold integers, got dtype {idx.dtype}")
    if idx.shape != (K, n):
        raise ValueError(
            f"perm_idx has shape {idx.shape}; nperms={nperms} with "
            f"original={original} over n={n} samples needs {(K, n)}"
        )
    if not np.array_equal(np.sort(idx, axis=1), np.broadcast_to(np.arange(n), (K, n))):
        raise ValueError("every row of perm_idx must be a permutation of 0..n-1")
    if original and not np.array_equal(idx[0], np.arange(n)):
        raise ValueError(
            "with original=True row 0 of perm_idx must be the identity "
            "(the observed column)"
        )
    return torch.from_numpy(idx.astype(np.int64))


@with_highest_matmul()
def perm_trait_parts(
    Y0, C0, lam, h2_list, *, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """Per-trait whitening quantities from rotated operands, in the kernel
    dtype. Returns ``(sqrtw, Q, wrn)``:

    - ``sqrtw`` (n, m): per-trait sqrt-weights ``sqrt(|make_weights(h2_j)|)``
      (abs guard as the reference, src/bulkscan_helpers.jl:138);
    - ``Q``: list of c tensors (n, m), each trait's orthonormal basis of the
      weighted covariates (unrolled Gram Cholesky, no batched QR);
    - ``wrn`` (n, m): the whitened null residual ``W^{1/2}(y0 - C0 bhat)``,
      normalized to unit length (a shuffle keeps the norm, so normalizing
      once folds the trait-side denominator away). A trait that its
      covariates explain residualizes to rounding noise; the relative rank
      mask zeroes it (r = 0 for every marker and permutation, COMPAT.md #15).
    """
    sdt = precision.resolve_kernel()
    c = C0.shape[1]

    W = make_weights(h2_list, lam).abs().T.to(sdt)  # (n, m)
    S = torch.sqrt(W)
    Y = Y0.to(sdt)
    C = C0.to(sdt)

    pairs = pair_indices(c)
    CC = torch.stack([C[:, k] * C[:, l] for k, l in pairs], dim=1)  # (n, npair)
    Gv = CC.T @ W  # (npair, m)
    Lc = unrolled_cholesky({kl: Gv[i] for i, kl in enumerate(pairs)}, c)

    # Q^T = L^{-1} (W^{1/2} C)^T, as c tensors of (n, m)
    Q = fwd_subst(Lc, [C[:, k : k + 1] * S for k in range(c)], c)

    Sy = S * Y
    wr = Sy
    for k in range(c):
        wr = wr - Q[k] * (Q[k] * Sy).sum(0)[None, :]
    nrm2 = (wr * wr).sum(0)
    keep = residual_keep_mask(nrm2, (Sy * Sy).sum(0), eps=torch.finfo(sdt).eps)
    wrn = (wr * keep[None, :]) / torch.sqrt(torch.clamp(nrm2, min=torch.finfo(sdt).tiny))[None, :]
    return S, Q, wrn


@with_highest_matmul()
def perm_trait_marker_parts(
    X0m, sqrtw, Qstack, *, precision: PrecisionConfig = DEFAULT_PRECISION
):
    """Permutation-independent per-trait whitened-marker quantities of one
    trait block: the covariate-basis projections ``pX`` (mb, c, p) and the
    residual norms ``xn`` (mb, p), ``+inf`` where a marker is collinear with
    the weighted covariates (so ``num^2 / xn`` is exactly 0, COMPAT.md #15).

    ``X0m`` (n, p); ``sqrtw`` (mb, n); ``Qstack`` (mb, c, n). Row scaling
    commutes into the small operand (``Q_j (X * sw_j) = (Q_j * sw_j) X``,
    ``|X * sw_j|^2 = (sw_j^2)^T X^2``), so both are batched products against
    the shared marker panel and no per-trait (n, p) panel is formed.
    """
    sdt = precision.resolve_kernel()
    X = X0m.to(sdt)
    pX = (Qstack * sqrtw[:, None, :]) @ X  # (mb, c, p)
    d1 = (sqrtw * sqrtw) @ (X * X)  # (mb, p)
    xn = residual_sq(d1, [pX[:, a] for a in range(pX.shape[1])])
    keep = cancel_keep_mask(xn, d1, eps=torch.finfo(sdt).eps)
    return pX, torch.where(keep > 0, xn, torch.full_like(xn, torch.inf))


@with_highest_matmul()
def max_r2_perms_plain(
    X0m, sqrtw, Qstack, pXs, xns, wrn, perm_idx, *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
):
    """(mb, Kc) max-over-markers squared correlation of one (trait block,
    permutation chunk) step: the plain engine (``engine="xla"`` at the API,
    the JAX package's ``max_r2_perms_xla``).

    ``X0m`` (n, p) rotated markers; ``sqrtw`` (mb, n); ``Qstack`` (mb, c, n);
    ``pXs`` / ``xns`` from :func:`perm_trait_marker_parts`; ``wrn`` (n, mb)
    unit-normalized whitened residuals; ``perm_idx`` (Kc, n).

    The numerator uses the self-adjoint split ``<(I-QQ^T)(X * sw_j), s> =
    (sw_j * s)^T X - (s^T Q_j^T) pX_j``: two batched products per step, the
    big one in the gemm dtype. The (mb, Kc, p) numerator is squared and
    divided in place.
    """
    sdt = precision.resolve_kernel()
    gdt = precision.resolve_gemm()
    X = X0m.to(sdt)
    sp = wrn.T[:, perm_idx]  # (mb, Kc, n): sp[j, k] = wrn[perm_idx[k], j]
    num = ((sp * sqrtw[:, None, :]).to(gdt) @ X.to(gdt)).to(sdt)  # (mb, Kc, p)
    num -= (sp @ Qstack.mT) @ pXs
    r2 = num.square_().div_(torch.clamp(xns, min=torch.finfo(sdt).tiny)[:, None, :])
    return r2.max(2).values


def plain_perm_chunk_cap(
    n: int, p: int, trait_chunk: int = 16, gemm_itemsize: int = 4,
    kernel_itemsize: int = 4, budget_bytes: int = 2 * 1024**3,
) -> int:
    """Permutation-chunk width bound for the plain engine.

    One step of :func:`max_r2_perms_plain` holds the (mb, Kc, p) numerator
    and the (mb, Kc, n) shuffled residuals; about three copies in the wider
    of the gemm and kernel dtypes are alive at once. Kc is bounded so that
    they stay inside ``budget_bytes``, and never below 64.
    """
    mult = 3 * max(gemm_itemsize, kernel_itemsize)
    per_kc = mult * max(trait_chunk, 1) * (max(p, 1) + max(n, 1))
    return max(64, int(budget_bytes // per_kc))


def kernel_perm_chunk_cap(n: int, trait_chunk: int = 1024, budget_bytes=None, *, device=None) -> int:
    """Permutation-chunk width bound for the fused kernel's engine.

    The kernel's dominant operand is the float32 (mb, n, Kc) block of
    shuffled, residualized, weight-folded residuals (S2), and the gather
    that forms it is as large again. Kc is bounded so that S2 stays inside
    ``budget_bytes``, by default a quarter of the device's memory budget
    (``utils/memory.py::device_memory_budget``: S2 and its gather then take
    half, the rest of the scan the other half), and never below 64. At 79
    samples and 1,024 traits the bound is far above any real number of
    permutations; at 20,000 samples it is what keeps a step from taking
    164 GB.
    """
    if budget_bytes is None:
        budget_bytes = memory.device_memory_budget(device) // 4
    return max(64, int(budget_bytes // (4 * max(trait_chunk, 1) * max(n, 1))))


def maxr2_to_lod(maxr2, n: int, *, precision: PrecisionConfig = DEFAULT_PRECISION):
    """Genome-wide max LOD from max r^2 (a monotone transform). ``1 - r^2``
    is floored at the smallest normal number of ``maxr2``'s dtype: r^2 can
    round to 1 or above for a marker perfectly correlated with the
    residual. The log is taken in float32 wherever the products ran in
    float32, as ``ops/lod.py::r2lod`` does."""
    one_minus = torch.clamp(1.0 - maxr2, min=torch.finfo(maxr2.dtype).tiny)
    if _fast_log(precision):
        one_minus = one_minus.to(torch.float32)
    return -(n / 2.0) * torch.log10(one_minus)


def perm_state_from_numpy(sqrtw, Qstack, wrn, perm_idx, *, device, dtype):
    """The per-trait permutation state of the JAX package, given as numpy
    arrays, as this package's tensors: ``sqrtw`` (m, n), ``Qstack``
    (m, c, n) and ``wrn`` (n, m) in ``dtype`` on ``device`` and ``perm_idx``
    (K, n) as int64 there, so that both packages' chunk cores can be fed
    the same state."""
    sw, Q, w = (
        torch.tensor(np.asarray(a), dtype=dtype, device=device)  # a copy
        for a in (sqrtw, Qstack, wrn)
    )
    idx = torch.tensor(np.asarray(perm_idx), dtype=torch.int64, device=device)
    return sw, Q, w, idx


# ---------------------------------------------------------------------------
# rank-k kinship: whitening in standard coordinates
# ---------------------------------------------------------------------------


def _mm(a, b):
    """``a @ b`` in the promoted dtype of the two, as a JAX product of
    mixed operands computes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def lowrank_perm_chunk_cap(n: int, p: int, trait_chunk: int = 16, itemsize: int = 4,
                           budget_bytes=None, *, device=None) -> int:
    """Permutation-chunk width bound for the rank-k engine.

    The (mb, Kc, n) shuffled residuals and the (mb, Kc, p) numerator both
    grow linearly in Kc; each is bounded by half of ``budget_bytes``, by
    default a quarter of the device's memory budget
    (``utils/memory.py::device_memory_budget``, as for
    :func:`kernel_perm_chunk_cap`; the JAX package takes a fixed 2 GiB),
    and Kc never below 64.
    """
    if budget_bytes is None:
        budget_bytes = memory.device_memory_budget(device) // 4
    half = budget_bytes // 2
    per_kc = itemsize * max(trait_chunk, 1)
    return max(64, int(min(half // (per_kc * max(n, 1)), half // (per_kc * max(p, 1)))))


@with_highest_matmul()
def perm_trait_parts_lowrank(Y, C, U, lam, h2_list, *, precision: PrecisionConfig = DEFAULT_PRECISION):
    """Per-trait whitening quantities on a rank-k kinship, in standard
    coordinates (nothing rotated, no (n, n) kinship).

    The whitening operator is ``A_j = I + U diag(sqrt(w_j) - 1) U^T`` with
    ``w_i = 1/(delta_j lam_i + 1)`` (``ops/lowrank.py::whiten_lowrank``; the
    complement of U has eigenvalue 0, weight 1). Under the null ``A_j y`` has
    iid coordinates in the standard basis, so shuffling them is the rank-k
    analog of the full-rank path's shuffle of the rotated, reweighted
    residual (:func:`perm_trait_parts`).

    Returns ``(sm1, Qstack, wrn)``: ``sm1`` (m, k) per-trait ``sqrt(w) - 1``;
    ``Qstack`` (m, c, n) each trait's orthonormal basis of the whitened
    covariates (unrolled Gram Cholesky); ``wrn`` (n, m) the unit-normalized
    whitened null residuals ``(I - Q_j Q_j^T) A_j y_j``. Mixed dtypes
    promote as in the JAX package (``sm1`` keeps ``lam``'s).
    """
    from .lowrank import _correction_weights

    sdt = precision.resolve_kernel()
    c = C.shape[1]
    Ck, Yk, Uk = C.to(sdt), Y.to(sdt), U.to(sdt)

    dm1 = _correction_weights(h2_list, lam)  # (m, k): w - 1
    sm1 = torch.sqrt(1.0 + dm1) - 1.0  # (m, k): sqrt(w) - 1
    UtC = Uk.T @ Ck  # (k, c)
    UtY = Uk.T @ Yk  # (k, m)

    # A_j C[:, a] = C[:, a] + U (sm1_j * UtC[:, a]), one (n, m) panel a column
    Cw = [Ck[:, a : a + 1] + _mm(Uk, sm1.T * UtC[:, a : a + 1]) for a in range(c)]
    Gv = {ab: (Cw[ab[0]] * Cw[ab[1]]).sum(0) for ab in pair_indices(c)}
    Lc = unrolled_cholesky(Gv, c)
    Q = fwd_subst(Lc, Cw, c)  # c x (n, m)

    Yw = Yk + _mm(Uk, sm1.T * UtY)  # (n, m)
    wr = Yw
    for a in range(c):
        wr = wr - Q[a] * (Q[a] * Yw).sum(0)[None, :]
    nrm2 = (wr * wr).sum(0)
    # fully covariate-explained traits -> r = 0, not normalized noise
    keep = residual_keep_mask(nrm2, (Yw * Yw).sum(0), eps=torch.finfo(sdt).eps)
    wrn = (wr * keep[None, :]) / torch.sqrt(torch.clamp(nrm2, min=torch.finfo(sdt).tiny))[None, :]
    Qstack = torch.stack(Q, dim=0).permute(2, 0, 1).contiguous()  # (m, c, n)
    return sm1, Qstack, wrn


@with_highest_matmul()
def lowrank_perm_marker_parts(X, U, *, precision: PrecisionConfig = DEFAULT_PRECISION):
    """Trait- and permutation-independent marker projections of the rank-k
    permutation engine, formed once a scan: ``U^T X`` (k, p), its square and
    the raw marker norms (p,)."""
    sdt = precision.resolve_kernel()
    Xk = X.to(sdt)
    UtX = U.to(sdt).T @ Xk  # (k, p)
    return UtX, UtX * UtX, (Xk * Xk).sum(0)


@with_highest_matmul()
def lowrank_perm_trait_marker_parts(X, U, UtX, UtX2, xsq, sm1, Qstack, *,
                                    precision: PrecisionConfig = DEFAULT_PRECISION):
    """Permutation-independent whitened-marker quantities of one trait
    block, reused by every permutation chunk: the covariate-basis
    projections ``qX`` (mb, c, p) and the residual norms ``xn`` (mb, p) of
    the whitened, covariate-residualized markers, ``+inf`` where a marker is
    collinear with the covariates (``num^2 / xn`` exactly 0, COMPAT.md #15).
    ``sm1`` (mb, k), ``Qstack`` (mb, c, n): one block's rows."""
    sdt = precision.resolve_kernel()
    Xk, Uk = X.to(sdt), U.to(sdt)
    dm1 = sm1 * sm1 + 2.0 * sm1  # (mb, k): w - 1
    qU = _mm(Qstack, Uk)  # (mb, c, k)
    qX = _mm(Qstack, Xk) + _mm(qU * sm1[:, None, :], UtX)  # (mb, c, p)
    # ||(I - QQ^T) A_j x||^2 with the rank-k scan's cancellation floor;
    # its noise is linear in eps (cancel_keep_mask)
    d1 = xsq[None, :] + _mm(dm1, UtX2)  # (mb, p): ||A_j x||^2
    xn = residual_sq(d1, [qX[:, a] for a in range(qX.shape[1])])
    keep = cancel_keep_mask(xn, d1, eps=torch.finfo(sdt).eps)
    return qX, torch.where(keep > 0, xn, torch.full_like(xn, torch.inf))


@with_highest_matmul()
def max_r2_perms_lowrank(X, U, UtX, sm1, Qstack, qXs, xns, wrn, perm_idx, *,
                         precision: PrecisionConfig = DEFAULT_PRECISION):
    """(mb, Kc) max-over-markers squared correlation under rank-k whitening,
    one (trait block, permutation chunk) step (the JAX package's
    ``max_r2_perms_lowrank_xla``).

    ``X`` (n, p) unrotated markers; ``U`` (n, k); ``UtX`` (k, p); ``sm1``
    (mb, k); ``Qstack`` (mb, c, n); ``qXs`` / ``xns`` from
    :func:`lowrank_perm_trait_marker_parts`; ``wrn`` (n, mb); ``perm_idx``
    (Kc, n). No per-trait whitened marker panel is formed: each whitened
    inner product is the raw product plus a rank-k correction through the
    shared ``U^T X``, less the covariate-basis term.
    """
    sdt = precision.resolve_kernel()
    gdt = precision.resolve_gemm()
    Xk, Uk = X.to(sdt), U.to(sdt)
    sp = wrn.T[:, perm_idx]  # (mb, Kc, n): sp[j, k] = wrn[perm_idx[k], j]
    spU = _mm(sp, Uk)  # (mb, Kc, k)
    num = (
        (sp.to(gdt) @ Xk.to(gdt)).to(sdt)
        + ((spU * sm1[:, None, :]).to(gdt) @ UtX.to(gdt)).to(sdt)
    )
    num = num - _mm(_mm(sp, Qstack.mT), qXs)  # (mb, Kc, p)
    r2 = (num * num) / torch.clamp(xns, min=torch.finfo(sdt).tiny)[:, None, :]
    return r2.max(2).values
