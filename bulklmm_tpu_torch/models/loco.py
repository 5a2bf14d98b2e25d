"""Leave-one-chromosome-out (LOCO) scans.

Counterpart of ``bulklmm_tpu/models/loco.py``. The reference (BulkLMM.jl)
always scans against the whole-genome kinship (src/kinship.jl:4-13 feeds
every scan), so markers are tested against a relatedness matrix that
*contains themselves*, causing proximal contamination (deflated signals
near true QTL). The standard GWAS remedy (GEMMA ``-loco``, BOLT-LMM,
regenie) is to scan each chromosome's markers against a kinship built from
all OTHER chromosomes.

Kinship algebra: ``calc_kinship`` is an affine function of the marker
cross-product, so the per-leave-out kinships are assembled from ONE pass of
per-chromosome Gram matrices, ``K_{-c} = 2 (A - A_c) / (p - p_c) + 0.5``
with ``A_c = X_c X_c^T`` (one product per chromosome, in the preset's
solve dtype with TF32 off, each marker touched once), rather than re-reading
the panel per chromosome.

The genotype panel is uploaded once per call and each chromosome's columns
are gathered on the device. The Grams stay on the device: C Grams plus one
leave-out kinship at a time (each Gram is freed once its kinship is made).
That is small at BXD n; at cohort n the Grams are C x n^2 x 8 bytes (20
chromosomes at n = 20,000 take 64 GB), which is what ``lowrank_k`` is for:
the per-chromosome kinship is then never formed, the rank-k factors come
straight from the leave-out genotype block
(``ops/lowrank.py::kinship_lowrank_from_geno``) and the Woodbury engine runs
unrotated.

Each chromosome then runs the ordinary engines (``bulkscan``,
``bulkscan_perms``, ``scan``) against its own kinship, so on CUDA tensors
every launch goes through the same kernels as a whole-genome call (the LOD
kernel, the alt-grid kernel, the permutation kernel; one launch or trait
block per chromosome). Results are reassembled in the original marker
order: the LOD matrix in float64 on the scan's device (on the host where an
inner call returned host arrays), every other field in the engine's dtype.
``mesh=`` runs each chromosome on the device mesh, one sharded call a
chromosome (``bulkscan_sharded``, ``bulkscan_perms_sharded``).
"""

from __future__ import annotations

import functools
import hashlib
from pathlib import Path

import numpy as np
import torch

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import mesh_device, resolve_device
from ..utils.host import to_numpy
from .bulkperm import BulkPermResult, _attach_adj_pvals, bulkscan_perms, bulkscan_perms_sharded
from .bulkscan import _take_rows, bulkscan, bulkscan_sharded
from .missing import (
    _check_group_sizes, _check_side_inputs, _ncov_total, group_checkpoint, maybe_masked,
    raise_if_missing, validate_missing_kwarg,
)
from .results import BulkScanResult, ScanResult
from .scan import scan

__all__ = ["loco_kinship", "bulkscan_loco", "bulkscan_perms_loco", "scan_loco"]


def _chrom_masks(chromosome, p):
    chromosome = to_numpy(chromosome)
    if chromosome.shape[0] != p:
        raise ValueError(
            f"chromosome labels must have one entry per marker: got "
            f"{chromosome.shape[0]} labels for {p} markers"
        )
    order = list(dict.fromkeys(chromosome.tolist()))  # encounter order
    if len(order) < 2:
        raise ValueError(
            "LOCO needs markers on at least 2 chromosomes (the leave-out "
            "kinship would otherwise be empty)"
        )
    return order, {c: chromosome == c for c in order}


def _columns(Gd: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """The columns ``mask`` of the device panel, gathered on its device."""
    return Gd.index_select(1, torch.as_tensor(np.flatnonzero(mask), device=Gd.device))


@with_highest_matmul()
def _chrom_grams(Gd, order, masks, dtype):
    """Per-chromosome marker cross-products and their sum (one product each)."""
    grams, counts = {}, {}
    total = None
    for c in order:
        Xc = _columns(Gd, masks[c]).to(dtype) - 0.5
        grams[c] = Xc @ Xc.T
        counts[c] = Xc.shape[1]
        total = grams[c].clone() if total is None else total.add_(grams[c])
    return grams, counts, total


def _leaveout_kinship(total, gram_c, p_rest):
    K = 2.0 * (total - gram_c) / p_rest + 0.5
    K.fill_diagonal_(1.0)
    return K


def loco_kinship(
    geno, chromosome, precision: PrecisionConfig = DEFAULT_PRECISION, *, device=None
):
    """Dict ``chrom -> K_{-chrom}`` (kinship from all other chromosomes), as
    (n, n) tensors in the preset's solve dtype.

    Exactly ``calc_kinship(geno[:, chromosome != c])`` for every c, computed
    from one pass of per-chromosome cross-products. Holds all C kinships at
    once; the scan wrappers below make them one at a time instead. ``device``
    follows ``utils/device.py::resolve_device`` (``device="cpu"`` for the
    CPU).
    """
    Gd = torch.as_tensor(geno, device=resolve_device(device, geno))
    p = Gd.shape[1]
    order, masks = _chrom_masks(chromosome, p)
    grams, counts, total = _chrom_grams(Gd, order, masks, precision.resolve_solve())
    return {c: _leaveout_kinship(total, grams[c], p - counts[c]) for c in order}


def _iter_loco(Gd, chromosome, *, lowrank_k, precision):
    """Yield ``(chrom, mask, G_chrom, K_{-chrom})`` one chromosome at a time.

    Dense path: Grams once, each leave-out kinship made only for its own
    iteration (the Gram is freed after use). Rank-k path: factors from the
    leave-out genotype block, one chromosome at a time.
    """
    p = Gd.shape[1]
    order, masks = _chrom_masks(chromosome, p)
    if lowrank_k:
        from ..ops.lowrank import kinship_lowrank_from_geno

        for c in order:
            K = kinship_lowrank_from_geno(
                _columns(Gd, ~masks[c]), lowrank_k, precision=precision, device=Gd.device
            )
            yield c, masks[c], _columns(Gd, masks[c]), K
        return
    grams, counts, total = _chrom_grams(Gd, order, masks, precision.resolve_solve())
    for c in order:
        K = _leaveout_kinship(total, grams.pop(c), p - counts[c])
        yield c, masks[c], _columns(Gd, masks[c]), K


class _Stitch:
    """Per-chromosome rows of one result field in a (p, ...) array, built at
    the first value: a tensor on the value's device, or a host array where
    the value is one (host trait blocks). ``dtype`` fixes the array's dtype;
    None keeps the engine's (upcasting permutation-scale panels to float64
    would double the footprint for no accuracy gain)."""

    def __init__(self, p: int, dtype=None):
        self.p, self.dtype, self.buf = p, dtype, None

    def put(self, mask: np.ndarray, val) -> None:
        if val is None:
            return
        if self.buf is None:
            shape = (self.p,) + tuple(val.shape[1:])
            if torch.is_tensor(val):
                self.buf = torch.empty(shape, dtype=self.dtype or val.dtype, device=val.device)
            else:
                dt = np.float64 if self.dtype is torch.float64 else np.asarray(val).dtype
                self.buf = np.empty(shape, dtype=dt)
        if torch.is_tensor(self.buf):
            idx = torch.as_tensor(np.flatnonzero(mask), device=self.buf.device)
            self.buf[idx] = torch.as_tensor(val, device=self.buf.device).to(self.buf.dtype)
        else:
            self.buf[mask] = to_numpy(val)


def _masked_kwargs(kwargs, weights, rows):
    if weights is None:
        return kwargs
    return {**kwargs, "weights": _take_rows(weights, rows)}


def bulkscan_loco(
    Y,
    G,
    chromosome,
    covar=None,
    *,
    lowrank_k: int = 0,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    mesh=None,
    missing: str = "error",
    device=None,
    **kwargs,
) -> BulkScanResult:
    """Multi-trait LOCO scan: each chromosome's markers against the kinship
    of all other chromosomes, reassembled in the original marker order.

    ``chromosome``: (p,) labels (e.g. ``read_gmap(...).chromosome``).
    ``lowrank_k`` > 0 uses the rank-k engine per chromosome (no n x n
    kinship, no host eigh). ``mesh`` (``parallel.make_mesh``) runs each
    chromosome's scan on the device mesh
    (:func:`bulklmm_tpu_torch.parallel.bulkscan_sharded`, one sharded call
    a chromosome), from the mesh's first device. Remaining keywords go to
    :func:`bulkscan` (method, reml, output_pvals, output_effects,
    trait_chunk, ...), or to ``bulkscan_sharded`` with a mesh. ``device``
    follows ``utils/device.py::resolve_device``.

    L is float64 (p, m) on the scan's device; the other fields keep the
    engine's dtype. Per-trait null h2 is chromosome-specific:
    ``h2_null_by_chrom`` maps ``chrom -> (m,)`` (or ``(p_c, m)`` panels for
    alt-grid).
    """
    validate_missing_kwarg(missing)
    device = resolve_device(mesh_device(mesh, device), Y, G, covar)
    Gd = torch.as_tensor(G, device=device)
    weights = kwargs.get("weights")
    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan_loco(
            Ys, _take_rows(Gd, rows), chromosome, _take_rows(covar, rows),
            lowrank_k=lowrank_k, precision=precision, mesh=mesh, device=device,
            **_masked_kwargs(kwargs, weights, rows),
        ),
        covar=covar, weights=weights, add_intercept=kwargs.get("add_intercept", True),
        what="bulkscan_loco",
    )
    if masked is not None:
        return masked
    Y = torch.as_tensor(Y, device=device)
    Y = Y[:, None] if Y.ndim == 1 else Y
    raise_if_missing(torch.isfinite(Y).all(), "bulkscan_loco")
    p = Gd.shape[1]

    fields = {f: _Stitch(p, torch.float64 if f == "L" else None)
              for f in ("L", "log10Pvals_mat", "beta_mat", "beta_se_mat")}
    h2_by_chrom = {}
    for c, mask, Gc, K in _iter_loco(Gd, chromosome, lowrank_k=lowrank_k, precision=precision):
        if mesh is None:
            res = bulkscan(Y, Gc, K, covar, precision=precision, device=device, **kwargs)
        else:
            res = bulkscan_sharded(Y, Gc, K, covar, mesh=mesh, precision=precision, **kwargs)
        for f, st in fields.items():
            st.put(mask, getattr(res, f))
        h2_by_chrom[c] = res.h2_null_list if res.h2_null_list is not None else res.h2_panel
        del K, res

    result = BulkScanResult(L=fields["L"].buf, h2_null_by_chrom=h2_by_chrom)
    if fields["log10Pvals_mat"].buf is not None:
        result.log10Pvals_mat = fields["log10Pvals_mat"].buf
        result.chisq_df = kwargs.get("chisq_df", 1)
    if fields["beta_mat"].buf is not None:
        result.beta_mat, result.beta_se_mat = fields["beta_mat"].buf, fields["beta_se_mat"].buf
    return result


def scan_loco(
    y,
    G,
    chromosome,
    covar=None,
    *,
    lowrank_k: int = 0,
    share_shuffles: bool = False,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    missing: str = "error",
    device=None,
    **kwargs,
) -> ScanResult:
    """Single-trait LOCO scan (see :func:`bulkscan_loco`).

    Remaining keywords go to :func:`scan` (assumption, reml,
    permutation_test/nperms/rndseed, output_pvals, output_effects, ...).
    The null model is chromosome-specific: ``h2_null_by_chrom`` /
    ``sigma2_by_chrom`` map ``chrom -> float``; ``h2_null`` / ``sigma2_e``
    hold the across-chromosome means (0-d float64 tensors) for a quick
    summary. ``lod`` is float64 on the scan's device.

    Permutation semantics: each chromosome permutes its own rotated null
    residuals (the reference's scheme, per-chromosome eigenbasis). By
    default chromosome i uses seed ``rndseed + i``, so column j of the
    stitched ``L_perms`` combines INDEPENDENT per-chromosome null
    replicates; genome-wide thresholds from
    :func:`~bulklmm_tpu_torch.get_thresholds` then treat per-chromosome
    maxima as independent — a Šidák-like approximation that is exact when
    chromosomes are independent under the null and conservative (higher
    thresholds, FWER still controlled) under cross-chromosome positive
    dependence. ``share_shuffles=True`` reuses the SAME shuffle indices on
    every chromosome instead — the closest analog of shuffling the
    phenotype once and scanning the whole genome (per-chromosome maxima
    keep their positive dependence, giving smaller genome-wide maxima and
    tighter thresholds), at the cost of replicate-level dependence given
    y. Per-chromosome thresholds
    (``get_thresholds(res.L_perms[chrom == c])``) are exact either way.
    The seeds draw the port's shuffle indices (``ops/bulkperm.py::
    permutation_indices``), not the JAX package's threefry stream.
    """
    if kwargs.get("profile_ll"):
        raise ValueError(
            "profile_ll is a single-(marker, kinship) diagnostic; run "
            "scan(profile_ll=True) against the wanted LOCO kinship directly"
        )
    validate_missing_kwarg(missing)
    device = resolve_device(device, y, G, covar)
    Gd = torch.as_tensor(G, device=device)
    y = to_numpy(y, np.float64)
    finite = np.isfinite(y).ravel() if y.ndim > 1 else np.isfinite(y)
    if not finite.all():
        # single trait: complete-case row subset; LOCO kinships are built
        # from the subset genotypes below (exact: K_ij depends only on rows
        # i, j of G)
        raise_if_missing(missing != "error", "scan_loco")
        weights = kwargs.get("weights")
        _check_side_inputs(covar, weights, "scan_loco")
        rows = np.flatnonzero(finite)
        _check_group_sizes(
            [(rows, np.array([0]))], _ncov_total(covar, kwargs.get("add_intercept", True)),
            what="scan_loco", drop=False,
        )
        y, Gd, covar = y[finite], _take_rows(Gd, rows), _take_rows(covar, rows)
        kwargs = _masked_kwargs(kwargs, weights, rows)
    p = Gd.shape[1]
    base_seed = int(kwargs.pop("rndseed", 0))

    fields = {f: _Stitch(p, torch.float64 if f == "lod" else None)
              for f in ("lod", "h2_each_marker", "L_perms", "log10pvals", "log10Pvals_perms",
                        "beta", "beta_se")}
    h2_by_chrom, s2_by_chrom = {}, {}
    chroms = _iter_loco(Gd, chromosome, lowrank_k=lowrank_k, precision=precision)
    for i, (c, mask, Gc, K) in enumerate(chroms):
        res = scan(y, Gc, K, covar, precision=precision, device=device,
                   rndseed=base_seed if share_shuffles else base_seed + i, **kwargs)
        for f, st in fields.items():
            st.put(mask, getattr(res, f))
        h2_by_chrom[c] = float(res.h2_null)
        s2_by_chrom[c] = float(res.sigma2_e)
        del K, res

    def mean(d):
        return torch.tensor(float(np.mean(list(d.values()))), dtype=torch.float64, device=device)

    return ScanResult(
        sigma2_e=mean(s2_by_chrom),
        h2_null=mean(h2_by_chrom),
        **{f: st.buf for f, st in fields.items()},
        h2_null_by_chrom=h2_by_chrom,
        sigma2_by_chrom=s2_by_chrom,
    )


def _chrom_checkpoint(checkpoint, c):
    """The checkpoint subdirectory of chromosome ``c``: every chromosome is
    its own sweep (its marker count, its seed), so one shared directory
    would trip the config-mismatch guard on the second chromosome."""
    if checkpoint is None:
        return None
    safe = "".join(ch if ch.isalnum() or ch in "._-" else "_" for ch in str(c))
    # sanitization alone can collide distinct labels ('1:A' vs '1 A'); a
    # short hash of the RAW label keeps subdirectories unique so one
    # chromosome can never silently resume another's maxima
    tag = hashlib.sha1(str(c).encode()).hexdigest()[:8]
    return str(Path(checkpoint) / f"chr_{safe}_{tag}")


def bulkscan_perms_loco(
    Y,
    G,
    chromosome,
    covar=None,
    *,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    rndseed: int = 0,
    lowrank_k: int = 0,
    share_shuffles: bool = False,
    mesh=None,
    missing: str = "error",
    device=None,
    **kwargs,
) -> BulkPermResult:
    """All-trait LOCO permutation maxima: per chromosome, markers scan
    against the leave-that-chromosome-out kinship with its own null fits
    and whitened-residual shuffles; the genome-wide max per (trait,
    permutation) is the elementwise max of the per-chromosome maxima
    (LOD is monotone in r^2, so maxima stitch exactly).

    Permutation semantics match :func:`scan_loco`: by default chromosome i
    uses seed ``rndseed + i``, making each stitched replicate a max of
    INDEPENDENT per-chromosome draws — exact under cross-chromosome
    independence, conservative (higher thresholds, FWER still controlled)
    under positive dependence. ``share_shuffles=True`` reuses the same
    shuffle indices on every chromosome — the closest analog of one
    genome-wide phenotype shuffle (tighter thresholds, replicate-level
    dependence given Y). Remaining keywords go to
    :func:`bulklmm_tpu_torch.bulkscan_perms` (nperms, method, h2_grid,
    engine, ...). ``checkpoint`` fans out to one subdirectory a chromosome
    (``chr_<label>_<sha1[:8]>``). ``h2_null_by_chrom`` / ``sigma2_by_chrom``
    map ``chrom -> (m,)``; the result's ``h2_null_list`` / ``sigma2_e_list``
    are the across-chromosome means, and ``log10_adj_pvals`` is computed
    once, on the stitched maxima. ``lowrank_k`` > 0 builds each leave-out
    kinship as a rank-k factorization (no n x n kinship, no host eigh) and
    tests on the Woodbury whitening engine. ``mesh`` runs each chromosome's
    sweep on the device mesh
    (:func:`bulklmm_tpu_torch.parallel.bulkscan_perms_sharded`, where
    ``perm_chunk`` is the per-device width), from the mesh's first device.
    """
    validate_missing_kwarg(missing)
    device = resolve_device(mesh_device(mesh, device), Y, G, covar)
    Gd = torch.as_tensor(G, device=device)
    weights = kwargs.get("weights")
    ckpt_top = kwargs.get("checkpoint")

    def run_group(Ys, rows, traits, gi):
        kw = _masked_kwargs(kwargs, weights, rows)
        if ckpt_top is not None:
            kw = {**kw, "checkpoint": group_checkpoint(ckpt_top, gi)}
        return bulkscan_perms_loco(
            Ys, _take_rows(Gd, rows), chromosome, _take_rows(covar, rows),
            precision=precision, rndseed=rndseed, lowrank_k=lowrank_k,
            share_shuffles=share_shuffles, mesh=mesh, device=device, **kw,
        )

    masked = maybe_masked(
        Y, missing, run_group, covar=covar, weights=weights,
        add_intercept=kwargs.get("add_intercept", True), what="bulkscan_perms_loco",
    )
    if masked is not None:
        return masked
    Y = torch.as_tensor(Y, device=device)
    raise_if_missing(torch.isfinite(Y).all(), "bulkscan_perms_loco")
    base_seed = int(rndseed)
    checkpoint = kwargs.pop("checkpoint", None)

    maxlods = None
    h2_by_chrom, s2_by_chrom = {}, {}
    nperms = original = None
    chroms = _iter_loco(Gd, chromosome, lowrank_k=lowrank_k, precision=precision)
    if mesh is None:
        sweep = functools.partial(bulkscan_perms, device=device)
    else:
        sweep = functools.partial(bulkscan_perms_sharded, mesh=mesh)
    for i, (c, mask, Gc, K) in enumerate(chroms):
        res = sweep(
            Y, Gc, K, covar, precision=precision,
            rndseed=base_seed if share_shuffles else base_seed + i,
            checkpoint=_chrom_checkpoint(checkpoint, c),
            _adj_pvals=False,  # computed once, on the stitched maxima
            **kwargs,
        )
        h2_by_chrom[c] = res.h2_null_list
        s2_by_chrom[c] = res.sigma2_e_list
        nperms, original = res.nperms, res.original
        maxlods = res.maxlods if maxlods is None else torch.maximum(maxlods, res.maxlods)
        del K, res

    result = BulkPermResult(
        maxlods=maxlods,
        h2_null_list=torch.stack(list(h2_by_chrom.values())).mean(0),
        sigma2_e_list=torch.stack(list(s2_by_chrom.values())).mean(0),
        nperms=nperms,
        original=original,
        h2_null_by_chrom=h2_by_chrom,
        sigma2_by_chrom=s2_by_chrom,
    )
    return _attach_adj_pvals(result)
