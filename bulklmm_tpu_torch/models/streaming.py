"""Marker-streamed bulk scans: genotype panels larger than the device.

Counterpart of ``bulklmm_tpu/models/streaming.py`` (its dense-kinship,
one-device half). The in-memory engines hold the (n, p) panel and the
(p, m) results on the device; at biobank p either can exceed it. Here the
panel stays on the host (numpy, ``np.memmap``, or any sliceable (n, p)
array) and passes through the device in marker blocks:

- the per-trait null h2 does not depend on the markers, so the grid or
  Brent fit runs once, on the rotated traits (:func:`_fit_h2_rotated`);
- each block is uploaded, rotated and put through the same LOD step as the
  in-memory engine (:func:`_block_lods`: the CUDA LOD kernel, or its effects
  variant, under the float32 presets) or the alt-grid kernel
  (:func:`_block_alt_grid`), and its rows of the result land in a host
  array (``out=``, which may be an ``np.memmap``);
- the permutation form keeps only the (m, K) running maxima on the device
  and folds each block into them (LOD is monotone in r^2).

The pipeline (:func:`_stream_loop`): the host reads block k + 1 into a
pinned staging buffer and a side stream uploads it while block k computes;
the block's results go back to pinned buffers by non-blocking copies and are
written into the host arrays while the next block computes. Two staging
buffers alternate, and one is refilled only after its copy has finished.
The last block is zero-padded to the block width; its padded rows are
dropped.

A ``LowRankKinship`` takes the rank-k engine (``ops/lowrank.py``): the
trait-side projections and null fits once (:func:`_lr_trait_fit`), each
block's marker projections and its X'Y then the rank-k LOD step or alt-grid
scan (:func:`_lr_block`), and for permutations the standard-coordinate
whitening of ``models/bulkperm.py`` a block at a time. ``mesh=`` is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.altgrid_fused import fused_alt_grid
from ..ops.bulkperm import lowrank_perm_chunk_cap, lowrank_perm_marker_parts
from ..ops.lmm import fit_h2_traits
from ..ops.lod import lod2log10p
from ..ops.lowrank import (
    LowRankKinship, _alt_grid_lowrank, _marker_side_parts, _parts_kwargs, _shared_parts,
    _trait_side_parts, as_lowrank, fit_h2_lowrank, grid_null_ell_lowrank, is_lowrank,
    lods_and_effects_lowrank, lods_per_trait_lowrank, refuse_pallas,
)
from ..ops.rotation import resolve_kinship
from ..utils import memory
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import resolve_device
from ..utils.host import PinnedCopies, to_numpy
from .bulkperm import (
    BulkPermResult, _attach_adj_pvals, _bulkperm_prep_traits, _bulkperm_prep_traits_lowrank,
    _data_fingerprint, _lowrank_block_lods, _perm_checkpoint, _resolve_perm_engine,
    _trait_block_lods, shuffle_indices,
)
from .bulkscan import (
    _alt_grid_impl, _altgrid_uses_kernel, _check_method_engine, _check_output_effects,
    _grid_h2, _lod_effects_step, _lod_step, _scan_common_inputs, _traits_covar_grid,
)
from .missing import (
    ColSubsetOut, RowSubsetView, _check_group_sizes, _check_side_inputs, _ncov_total,
    finite_flag, group_checkpoint, maybe_masked, missing_groups, raise_if_missing,
    subset_kinship, validate_missing_kwarg,
)
from .results import BulkScanResult


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the device mesh) is not ported to bulklmm_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 14, multi-GPU)"
        )


def _blocks(p: int, block: int):
    for lo in range(0, p, block):
        yield lo, min(lo + block, p)


def _pad_block(G, lo: int, hi: int, dst: np.ndarray) -> np.ndarray:
    """Host markers lo..hi of ``G`` into the (n, block) array ``dst``, the
    columns past hi - lo zero."""
    w = hi - lo
    dst[:, :w] = np.asarray(G[:, lo:hi])
    dst[:, w:] = 0
    return dst


class _BlockUploads:
    """The host-to-device half of the pipeline: block i is read into pinned
    staging buffer i % 2 and copied on a side stream; :meth:`take` makes the
    compute stream wait for that copy. A staging buffer is refilled only
    after the copy out of it has finished (its event), and the device block
    is recorded on the compute stream, so neither is reused under a copy or
    a kernel still reading it. On the CPU a block is a plain array."""

    def __init__(self, G, spans, block: int, device):
        self.G, self.spans, self.device = G, spans, torch.device(device)
        self.cuda = self.device.type == "cuda"
        shape = (G.shape[0], block)
        dt = np.dtype(G.dtype) if np.dtype(G.dtype).kind == "f" else np.dtype(np.float64)
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self.staging = [torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                                        pin_memory=True) for _ in range(2)]
            self.copied = [None, None]
        else:
            self.shape, self.dtype = shape, dt

    def start(self, i: int):
        lo, hi = self.spans[i]
        if not self.cuda:
            return torch.from_numpy(_pad_block(self.G, lo, hi, np.empty(self.shape, self.dtype)))
        slot = i % 2
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()  # the copy out of this buffer has finished
        buf = self.staging[slot]
        _pad_block(self.G, lo, hi, buf.numpy())
        with torch.cuda.stream(self.stream):
            dev = buf.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.copied[slot] = done
        return dev, done

    def take(self, handle) -> torch.Tensor:
        if not self.cuda:
            return handle.to(self.device)
        dev, done = handle
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        dev.record_stream(compute)  # allocated on the side stream, read on this one
        return dev


def _stream_loop(G, p: int, block: int, dtype, device, compute, write) -> None:
    """For each marker block: upload (the next block's upload overlapping
    this block's work), ``compute(Xb) -> dict of device tensors``, copy the
    results back by non-blocking copies, and ``write(lo, hi, host_dict)``
    while the next block computes."""
    spans = list(_blocks(p, block))
    uploads = _BlockUploads(G, spans, block, device)
    copies = PinnedCopies(device)
    handle = uploads.start(0)
    pending = None
    for i, (lo, hi) in enumerate(spans):
        Xb = uploads.take(handle).to(dtype)
        res = compute(Xb)
        if i + 1 < len(spans):
            handle = uploads.start(i + 1)
        out = copies.start(res)
        if pending is not None:
            write(pending[0], pending[1], copies.wait(pending[2]))
        pending = (lo, hi, out)
    write(pending[0], pending[1], copies.wait(pending[2]))


@with_highest_matmul()
def _rotate_block(Ut, Xb):
    return Ut @ Xb


@with_highest_matmul()
def _fit_h2_rotated(Y, C, Ut, lam, h2_grid, *, prior, reml, method, optim_interval, precision):
    """Rotate the traits and covariates and fit each trait's null h2, once."""
    Y0, C0 = Ut @ Y, Ut @ C
    if method == "null-exact":
        h2_list = fit_h2_traits(Y0, C0, lam, prior, reml=reml, optim_interval=optim_interval)
    else:
        h2_list = _grid_h2(Y0, C0, lam, h2_grid, prior=prior, reml=reml, precision=precision)
    return Y0, C0, h2_list


def _block_lods(Y0, Xb, C0, Ut, lam, h2_list, *, precision, effects=False):
    """One marker block's (block, m) LOD (and effect and SE) slabs."""
    X0b = _rotate_block(Ut, Xb)
    if effects:
        L, beta, se = _lod_effects_step(Y0, X0b, C0, lam, h2_list, precision)
        return {"L": L, "beta_mat": beta, "beta_se_mat": se}
    return {"L": _lod_step(Y0, X0b, C0, lam, h2_list, precision)}


def _block_alt_grid(Y0, Xb, C0, Ut, lam, h2_grid, *, prior, reml, precision, use_kernel):
    """One marker block's alt-grid LOD and h2 panel slabs: the alt-grid
    CUDA kernel, or the plain formulation."""
    X0b = _rotate_block(Ut, Xb)
    if use_kernel:
        L, panel = fused_alt_grid(Y0, X0b, C0, lam, h2_grid, prior=prior, reml=reml)
    else:
        L, panel = _alt_grid_impl(Y0, X0b, C0, lam, h2_grid, prior=prior, reml=reml,
                                  precision=precision)
    return {"L": L, "h2_panel": panel}


@with_highest_matmul()
def _lr_trait_fit(Y, C, U, lam, h2_grid, *, n, prior, reml, method, optim_interval, precision):
    """The rank-k engine's trait-side and covariate-only parts and each
    trait's null h2, once a streamed scan (zeros for alt-grid, which scans
    the whole grid a marker)."""
    kdt = precision.resolve_kernel()
    kw = _parts_kwargs(precision)
    lr = LowRankKinship(U=U, lam=lam)
    base = {**_shared_parts(C, lr, **kw), **_trait_side_parts(Y, C, lr, **kw)}
    lam_k = lam.to(kdt)
    if method == "alt-grid":
        h2_list = torch.zeros(Y.shape[1], dtype=kdt, device=Y.device)
    elif method == "null-exact":
        # Brent in the solve dtype (ops/lowrank.py's module docstring)
        h2_list = fit_h2_lowrank(base, lam, prior, n=n, reml=reml, optim_interval=optim_interval)
    else:
        ells = grid_null_ell_lowrank(base, lam_k, h2_grid.to(kdt), prior, n=n, reml=reml)
        h2_list = h2_grid[torch.argmax(ells, dim=0)]  # first max wins
    return base, h2_list


@with_highest_matmul()
def _lr_block(Xb, Y, C, U, lam, tbase, h2_or_grid, *, n, prior, reml, precision, alt, effects):
    """One marker block's slabs on the rank-k engine: its marker-side
    projections and X'Y joined to the trait-side parts, then the LOD step
    (with effects) or the alt-grid scan."""
    kw = _parts_kwargs(precision)
    kdt = precision.resolve_kernel()
    Xg = Xb.to(kw["gemm_dtype"])
    parts = {**_marker_side_parts(Xg, C, LowRankKinship(U=U, lam=lam), **kw), **tbase,
             "XtY": (Xg.T @ Y.to(kw["gemm_dtype"])).to(kdt)}
    lam_k, h2k = lam.to(kdt), h2_or_grid.to(kdt)
    if alt:
        L, panel = _alt_grid_lowrank(parts, lam_k, h2k, prior, n=n, precision=precision, reml=reml)
        return {"L": L, "h2_panel": panel}
    if effects:
        L, beta, se = lods_and_effects_lowrank(parts, lam_k, h2k, n, precision=precision)
        return {"L": L, "beta_mat": beta, "beta_se_mat": se}
    return {"L": lods_per_trait_lowrank(parts, lam_k, h2k, n, precision=precision)}


def _default_out(p: int, m: int, precision: PrecisionConfig) -> np.ndarray:
    """The host LOD array when the caller gives none: the kernel dtype, so
    that EXACT64 runs keep float64."""
    return np.empty((p, m), dtype=to_numpy(torch.empty(0, dtype=precision.resolve_kernel())).dtype)


def bulkscan_streamed(
    Y,
    G,
    K,
    covar=None,
    *,
    method: str = "null-grid",
    marker_block=None,
    h2_grid=None,
    add_intercept: bool = True,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    solve_method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    output_pvals: bool = False,
    chisq_df: int = 1,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    out=None,
    out_pvals=None,
    engine: str = "auto",
    output_effects: bool = False,
    mesh=None,
    missing: str = "error",
    device=None,
) -> BulkScanResult:
    """Bulk scan over a host-resident genotype panel, streamed in marker
    blocks, for p too large to hold the (n, p) panel or the (p, m) results
    on the device.

    ``G`` is any sliceable host (n, p) array (numpy, ``np.memmap``). ``out``
    (optional) receives the (p, m) LODs; pass an ``np.memmap`` when the
    result exceeds host RAM; likewise ``out_pvals`` with
    ``output_pvals=True`` (the p-values are computed on the host, block by
    block). ``output_effects`` (null methods) streams the effects and their
    standard errors from the same block pass. ``marker_block=None`` sizes
    the block from the device's free memory
    (``utils/memory.py::auto_marker_block``). ``missing`` as for
    :func:`bulkscan`; a masked run writes each pattern group through a
    column view of ``out``. With a caller's ``out`` or ``out_pvals`` a
    non-finite phenotype is refused before the first block is written.
    The keyword surface is otherwise :func:`bulkscan`'s, with the same
    engines and numerics, minus ``weights`` (pre-scale with the in-memory
    API) and ``trait_chunk`` (size ``marker_block`` instead), plus
    ``device`` (defaults as in :func:`bulkscan`). ``K`` may be a
    ``LowRankKinship`` (the rank-k engine; ``engine="pallas"`` raises as in
    the JAX package). Returns a :class:`BulkScanResult` of host arrays,
    ``L`` being ``out``.
    """
    _refuse_mesh(mesh)
    validate_missing_kwarg(missing)
    _check_method_engine(method, engine)
    _check_output_effects(output_effects, method)
    lowrank = is_lowrank(K)
    if lowrank:
        refuse_pallas(engine)
    device = resolve_device(device, Y, K, covar)
    kwargs = dict(
        method=method, marker_block=marker_block, h2_grid=h2_grid,
        prior_variance=prior_variance, prior_sample_size=prior_sample_size, reml=reml,
        solve_method=solve_method, optim_interval=optim_interval,
        decomp_scheme=decomp_scheme, output_pvals=output_pvals, chisq_df=chisq_df,
        precision=precision, engine=engine, output_effects=output_effects, device=device,
    )
    masked = _masked_streamed(
        Y, G, K, covar, missing=missing, out=out, out_pvals=out_pvals,
        add_intercept=add_intercept, kwargs=kwargs,
    )
    if masked is not None:
        return masked

    n, p = G.shape[0], G.shape[1]
    Y, covar, h2_grid, add_intercept = _scan_common_inputs(
        Y, covar, h2_grid, add_intercept, method=method, engine=engine, device=device
    )
    m = Y.shape[1]
    finite = finite_flag(Y)
    if out is not None and out.shape != (p, m):
        raise ValueError(f"out must have shape {(p, m)}, got {out.shape}")
    if out_pvals is not None and not output_pvals:
        raise ValueError("out_pvals requires output_pvals=True")
    if out_pvals is not None and out_pvals.shape != (p, m):
        raise ValueError(f"out_pvals must have shape {(p, m)}, got {out_pvals.shape}")
    if out is not None or out_pvals is not None:
        # the caller's arrays are written block by block: refuse before the first
        raise_if_missing(finite, "bulkscan_streamed")
    if add_intercept:
        covar = torch.cat([torch.ones((n, 1), dtype=covar.dtype, device=device), covar], 1)
    prior = (float(prior_variance), float(prior_sample_size))
    if method == "null-exact" and solve_method not in ("qr", "cholesky"):
        raise ValueError(f"unknown method {solve_method!r}; use 'qr' or 'cholesky'")

    dtype = precision.resolve_solve()
    if marker_block is None:
        marker_block = memory.auto_marker_block(
            n, m, itemsize=dtype.itemsize,
            n_outputs=1 + 2 * int(output_effects) + int(output_pvals), device=device,
            rank=np.shape(K.U)[1] if lowrank else None,
        )
    block = min(int(marker_block), p)
    L = _default_out(p, m, precision) if out is None else out
    pv = None
    if output_pvals:
        pv = np.empty((p, m), dtype=L.dtype) if out_pvals is None else out_pvals
    host = {}  # the other (p, m) results, allocated in the first block's dtypes

    def write(lo, hi, res):
        L[lo:hi] = res["L"][: hi - lo]
        if pv is not None:
            pv[lo:hi] = lod2log10p(np.asarray(L[lo:hi]), chisq_df)
        for k, a in res.items():
            if k != "L":
                if k not in host:
                    host[k] = np.empty((p, m), dtype=a.dtype)
                host[k][lo:hi] = a[: hi - lo]

    Yd, Cd, grid_d = Y.to(dtype), covar.to(dtype), h2_grid.to(dtype)
    alt = method == "alt-grid"
    if lowrank:
        U, lam = as_lowrank(K, dtype, device)
        tbase, h2_list = _lr_trait_fit(
            Yd, Cd, U, lam, grid_d, n=n, prior=prior, reml=reml, method=method,
            optim_interval=optim_interval, precision=precision,
        )

        def compute(Xb):
            return _lr_block(Xb, Yd, Cd, U, lam, tbase, grid_d if alt else h2_list, n=n,
                             prior=prior, reml=reml, precision=precision, alt=alt,
                             effects=output_effects)
    elif alt:
        Ut, lam = resolve_kinship(K, decomp_scheme, dtype, device)
        use_kernel = _altgrid_uses_kernel(engine, precision, device)
        with with_highest_matmul():
            Y0, C0 = Ut @ Yd, Ut @ Cd

        def compute(Xb):
            return _block_alt_grid(Y0, Xb, C0, Ut, lam, grid_d, prior=prior, reml=reml,
                                   precision=precision, use_kernel=use_kernel)
    else:
        Ut, lam = resolve_kinship(K, decomp_scheme, dtype, device)
        Y0, C0, h2_list = _fit_h2_rotated(
            Yd, Cd, Ut, lam, grid_d, prior=prior, reml=reml, method=method,
            optim_interval=optim_interval, precision=precision,
        )

        def compute(Xb):
            return _block_lods(Y0, Xb, C0, Ut, lam, h2_list, precision=precision,
                               effects=output_effects)
    _stream_loop(G, p, block, dtype, device, compute, write)
    if alt:
        result = BulkScanResult(L=L, h2_panel=host["h2_panel"])
    else:
        result = BulkScanResult(L=L, h2_null_list=to_numpy(h2_list))
        if output_effects:
            result.beta_mat, result.beta_se_mat = host["beta_mat"], host["beta_se_mat"]
    if pv is not None:
        result.log10Pvals_mat = pv
        result.chisq_df = chisq_df
    raise_if_missing(finite, "bulkscan_streamed")
    return result


def _masked_streamed(Y, G, K, covar, *, missing, out, out_pvals, add_intercept, kwargs):
    """Pattern-grouped complete-case runs of :func:`bulkscan_streamed`, or
    None when ``missing="error"`` or Y is complete. Each group reads its
    rows of the panel lazily (:class:`RowSubsetView`) and writes through a
    column view of the host outputs (:class:`ColSubsetOut`), so a memmap
    ``out`` works unchanged. The stitched h2, panel and effects arrays take
    their dtypes from the first group's results."""
    validate_missing_kwarg(missing)
    if missing == "error":
        return None
    Yn = to_numpy(Y, np.float64)
    Yn = Yn[:, None] if Yn.ndim == 1 else Yn
    finite = np.isfinite(Yn)
    if finite.all():
        return None
    _check_side_inputs(covar, None, "bulkscan_streamed")
    groups = missing_groups(finite, drop=missing == "drop")
    _check_group_sizes(groups, _ncov_total(covar, add_intercept), what="bulkscan_streamed",
                       drop=missing == "drop")
    p, m = G.shape[1], Yn.shape[1]
    L = _default_out(p, m, kwargs["precision"]) if out is None else out
    if L.shape != (p, m):
        raise ValueError(f"out must have shape {(p, m)}, got {L.shape}")
    pv = out_pvals
    if kwargs["output_pvals"] and pv is None:
        pv = np.empty((p, m), dtype=L.dtype)
    covar_n = None if covar is None else to_numpy(covar)
    stitched = {}
    for rows, traits in groups:
        res = bulkscan_streamed(
            Yn[np.ix_(rows, traits)], RowSubsetView(G, rows), subset_kinship(K, rows),
            None if covar_n is None else covar_n[rows], add_intercept=add_intercept,
            out=ColSubsetOut(L, traits),
            out_pvals=None if pv is None else ColSubsetOut(pv, traits), **kwargs,
        )
        for f in ("h2_null_list", "h2_panel", "beta_mat", "beta_se_mat"):
            a = getattr(res, f)
            if a is None:
                continue
            if f not in stitched:
                shape = (m,) if a.ndim == 1 else (p, m)
                stitched[f] = np.full(shape, np.nan, dtype=a.dtype)
            stitched[f][..., traits] = a
    result = BulkScanResult(L=L, **stitched)
    if pv is not None:
        result.log10Pvals_mat = pv
        result.chisq_df = kwargs["chisq_df"]
    return result


def _assemble_perm_acc(acc: dict, m: int, trait_chunk: int) -> torch.Tensor:
    """The (m, K) maxima from the per-trait-block running maxima."""
    rows = [acc[ms] for ms in range(0, m, trait_chunk)]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)


def _stream_perm_ckpt(checkpoint, acc, *, m, trait_chunk, block, perm_chunk, device,
                      rank="full", **meta):
    """The checkpoint handle of a streamed sweep and the marker blocks it has
    folded in: the persisted (m, K) running maxima are loaded into ``acc``.
    The kinship's kind (``rank``), the block width and the permutation chunk
    are part of the fingerprint."""
    if checkpoint is None:
        return None, 0
    ck = _perm_checkpoint(checkpoint, m=m, trait_chunk=trait_chunk,
                          rank=f"{rank}-streamed-b{block}-pc{perm_chunk}", **meta)
    state = ck.load_state()
    if state is None:
        return ck, 0
    maxima, blocks_done = state
    for ms in range(0, m, trait_chunk):
        acc[ms] = torch.as_tensor(maxima[ms : ms + trait_chunk], device=device)
    return ck, blocks_done


def bulkscan_perms_streamed(
    Y,
    G,
    K,
    covar=None,
    *,
    nperms: int = 1000,
    rndseed: int = 0,
    method: str = "null-grid",
    h2_grid=None,
    marker_block=None,
    add_intercept: bool = True,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    solve_method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    engine: str = "auto",
    trait_chunk=None,
    perm_chunk: int = 2048,
    original: bool = True,
    tile_p: int = 256,
    interpret: bool = False,
    checkpoint=None,
    checkpoint_every: int = 1,
    mesh=None,
    missing: str = "error",
    perm_idx=None,
    device=None,
) -> BulkPermResult:
    """Every trait's genome-wide permutation maxima over a host-resident
    marker panel, streamed in marker blocks.

    The numerics of :func:`bulkscan_perms` (the same trait preparation, the
    same engines, the bulk-permutation CUDA kernel under the float32
    presets): LOD is monotone in r^2, so the genome-wide maxima are a
    running maximum over marker blocks, and the (m, K) maxima are the only
    marker-extensive state on the device. ``G`` is any sliceable host
    (n, p) array. ``perm_idx`` as for :func:`bulkscan_perms`.

    ``checkpoint`` (a directory) makes the sweep resumable: the running
    maxima and a marker-block cursor are saved atomically every
    ``checkpoint_every`` blocks and after the last; the same call again
    resumes after the last saved block (a changed configuration or input is
    refused). Each save reads the maxima back to the host.
    ``missing="mask"/"drop"`` runs each pattern group as its own sweep, with
    its own checkpoint subdirectory. ``K`` may be a ``LowRankKinship``: each
    block then takes the rank-k engine of :func:`bulkscan_perms`.
    """
    _refuse_mesh(mesh)
    validate_missing_kwarg(missing)
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    if method not in ("null-grid", "null-exact"):
        raise ValueError("method must be one of 'null-grid', 'null-exact'")
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError("engine must be one of 'auto', 'xla', 'pallas'")
    device = resolve_device(device, Y, K, covar)
    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan_perms_streamed(
            Ys, RowSubsetView(G, rows), subset_kinship(K, rows),
            None if covar is None else to_numpy(covar)[rows],
            nperms=nperms, rndseed=rndseed, method=method, h2_grid=h2_grid,
            marker_block=marker_block, add_intercept=add_intercept,
            prior_variance=prior_variance, prior_sample_size=prior_sample_size, reml=reml,
            solve_method=solve_method, optim_interval=optim_interval,
            decomp_scheme=decomp_scheme, precision=precision, engine=engine,
            trait_chunk=trait_chunk, perm_chunk=perm_chunk, original=original,
            tile_p=tile_p, interpret=interpret, checkpoint=group_checkpoint(checkpoint, gi),
            checkpoint_every=checkpoint_every, perm_idx=perm_idx, device=device,
        ),
        covar=covar, add_intercept=add_intercept, what="bulkscan_perms_streamed",
    )
    if masked is not None:
        return masked
    data_digest = _data_fingerprint(Y, G, covar, K) if checkpoint is not None else None
    Y, covar, h2_grid, add_intercept = _traits_covar_grid(Y, covar, h2_grid, add_intercept, device)
    finite = finite_flag(Y)
    n, m = Y.shape
    p = G.shape[1]
    if add_intercept:
        covar = torch.cat([torch.ones((n, 1), dtype=covar.dtype, device=device), covar], 1)
    prior = (float(prior_variance), float(prior_sample_size))
    dtype = precision.resolve_solve()
    if marker_block is None:
        marker_block = memory.auto_marker_block(n, m, itemsize=dtype.itemsize, device=device,
                                                rank=np.shape(K.U)[1] if is_lowrank(K) else None)
    block = min(int(marker_block), p)
    lowrank = is_lowrank(K)
    if lowrank:
        refuse_pallas(engine, perms=True)
        eng, trait_chunk = "xla", 16 if trait_chunk is None else trait_chunk
        cap = lowrank_perm_chunk_cap(n, block, trait_chunk, max(
            precision.resolve_gemm().itemsize, precision.resolve_kernel().itemsize), device=device)
    else:
        eng, cap, trait_chunk = _resolve_perm_engine(
            engine, n, device=device, precision=precision, interpret=interpret, p=block,
            trait_chunk=trait_chunk,
        )
    perm_chunk = min(perm_chunk, cap)
    idx = shuffle_indices(perm_idx, n, nperms, rndseed, original).to(device)

    if lowrank:
        U, lam = as_lowrank(K, dtype, device)
        h2_list, sigma2_list, sqrtw, Qstack, wrn = _bulkperm_prep_traits_lowrank(
            Y.to(dtype), covar.to(dtype), U, lam, h2_grid.to(dtype), n=n, prior=prior, reml=reml,
            method=method, optim_interval=optim_interval, precision=precision,
        )
    else:
        Ut, lam = resolve_kinship(K, decomp_scheme, dtype, device)
        with with_highest_matmul():
            h2_list, sigma2_list, sqrtw, Qstack, wrn = _bulkperm_prep_traits(
                Y.to(dtype), covar.to(dtype), Ut, lam, h2_grid.to(dtype), prior=prior,
                reml=reml, method=method, optim_interval=optim_interval, precision=precision,
            )
    acc = {}
    spans = list(_blocks(p, block))
    ck, blocks_done = _stream_perm_ckpt(
        checkpoint, acc, m=m, trait_chunk=trait_chunk, block=block, perm_chunk=perm_chunk,
        device=device, n=n, p=p, nperms=nperms, rndseed=rndseed, method=method, reml=reml,
        original=original, h2_grid=h2_grid, prior=prior, precision=precision, engine=eng,
        data_digest=data_digest, rank=f"lowrank{U.shape[1]}" if lowrank else "full",
    )
    uploads = _BlockUploads(G, spans, block, device)
    handle = uploads.start(blocks_done) if blocks_done < len(spans) else None
    for bi in range(blocks_done, len(spans)):
        Xb = uploads.take(handle).to(dtype)
        if bi + 1 < len(spans):
            handle = uploads.start(bi + 1)
        if lowrank:
            # every product reads the block in the kernel dtype: cast once;
            # zero-padded columns have zero norms and numerators: r^2 = 0
            Xb = Xb.to(precision.resolve_kernel())
            mparts = lowrank_perm_marker_parts(Xb, U, precision=precision)
        else:
            X0b = _rotate_block(Ut, Xb)
            X32 = X0b.to(torch.float32).contiguous() if eng == "pallas" else None
        with with_highest_matmul():
            for ms in range(0, m, trait_chunk):
                me = min(ms + trait_chunk, m)
                if lowrank:
                    blk = _lowrank_block_lods(
                        Xb, U, mparts, sqrtw[ms:me], Qstack[ms:me], wrn[:, ms:me], idx, n=n,
                        perm_chunk=perm_chunk, precision=precision,
                    )
                else:
                    blk = _trait_block_lods(
                        X0b, X32, sqrtw[ms:me], Qstack[ms:me], wrn[:, ms:me], idx, engine=eng,
                        n=n, perm_chunk=perm_chunk, precision=precision, interpret=interpret,
                    )
                acc[ms] = blk if ms not in acc else torch.maximum(acc[ms], blk)
        if ck is not None and ((bi + 1) % checkpoint_every == 0 or bi == len(spans) - 1):
            ck.save_state(_assemble_perm_acc(acc, m, trait_chunk), bi + 1)
    raise_if_missing(finite, "bulkscan_perms_streamed")
    return _attach_adj_pvals(BulkPermResult(
        maxlods=_assemble_perm_acc(acc, m, trait_chunk), h2_null_list=h2_list,
        sigma2_e_list=sigma2_list, nperms=nperms, original=original,
    ))
