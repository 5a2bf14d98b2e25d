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
    if torch.is_tensor(perm_idx):
        perm_idx = perm_idx.detach().cpu().numpy()
    idx = np.asarray(perm_idx)
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
