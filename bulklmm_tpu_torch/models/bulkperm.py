"""Bulk permutation testing: genome-wide permutation null maxima and
family-wise-error thresholds for every trait in one pass.

Counterpart of ``bulklmm_tpu/models/bulkperm.py`` (its full-rank, in-memory
entry point). The reference's permutation test is single-trait
(``scan_perms_lite``, src/scan.jl:485-557, and ``get_thresholds``);
thresholding 35,554 traits that way is 35,554 sequential scans.
:func:`bulkscan_perms` gives every trait's genome-wide null maxima at once:
per-trait null h2 fits (grid or exact, as ``bulkscan``), shuffle indices
shared by all traits, and a max-over-markers correlation pass that never
forms the (p, m, nperms) LOD tensor (``ops/bulkperm.py`` has the
derivation, ``kernels/bulkperm_fused.py`` the fused kernel).

Column 0 of ``maxlods`` is the observed (unpermuted) genome-wide max LOD of
each trait; columns 1.. are the permutation null replicates.

``missing="mask"/"drop"`` runs each missingness pattern as its own sweep
(``models/missing.py``), with its own checkpoint subdirectory. The marker-
streamed form is ``models/streaming.py::bulkscan_perms_streamed``. A
``LowRankKinship`` takes the rank-k engine (:func:`_lowrank_block_lods`:
per-trait Woodbury whitening in standard coordinates, plain products, as in
the JAX package, whose fused kernel assumes the rotated basis). The LOCO
form is ``models/loco.py::bulkscan_perms_loco``. :func:`bulkscan_perms_sharded`
runs the same sweep (:func:`_bulkscan_perms_on_mesh`) on a device mesh
(``tiles.py``), and ``bulkscan_perms`` is that sweep on a mesh of one
position.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..kernels.bulkperm_fused import (
    fused_perm_maxlods, fused_perm_maxlods_reference, prepare_chunk_inputs,
    prepare_trait_block,
)
from ..ops.bulkperm import (
    check_permutation_indices, kernel_perm_chunk_cap, lowrank_perm_chunk_cap,
    lowrank_perm_marker_parts, lowrank_perm_trait_marker_parts, max_r2_perms_lowrank,
    max_r2_perms_plain, maxr2_to_lod, perm_trait_marker_parts, perm_trait_parts,
    perm_trait_parts_lowrank, permutation_indices, plain_perm_chunk_cap,
)
from ..ops.lmm import fit_h2_traits
from ..ops.lowrank import (
    LowRankKinship, _parts_kwargs, _shared_parts, _trait_side_parts, as_lowrank,
    fit_h2_lowrank, grid_null_ell_lowrank, is_lowrank, null_sigma2_lowrank,
)
from ..ops.rotation import KinshipDecomposition, resolve_kinship
from ..ops.smallchol import off_covariates
from ..ops.weights import make_weights
from ..ops.wls import wls_ell_columns
from ..utils import memory
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import resolve_device
from ..utils.host import to_device, to_numpy
from ..utils.profiling import span, spanned
from .bulkscan import PERM_TEXTS, _take_rows, _traits_covar_grid, grid_null_ell
from .missing import (
    finite_flag, group_checkpoint, maybe_masked, raise_if_missing, subset_kinship,
    validate_missing_kwarg,
)
from .scan import _apply_weights, _refuse_weights_on_factors
from .tiles import MARKERS_AXIS, TRAITS_AXIS, Mesh, _PermTiles, _per_device, make_mesh

#: ``models/bulkscan.py`` (the package's attribute of that name is the entry
#: point): its engine rule, ``takes_cuda_kernel``, is looked up there at
#: each call, so that one patch reaches every entry point
_bulkscan = importlib.import_module(".bulkscan", __package__)


@dataclasses.dataclass
class BulkPermResult:
    """Output of :func:`bulkscan_perms`; tensors on the scan's device.

    ``maxlods`` is (m, 1 + nperms) when ``original=True`` (column 0
    observed), else (m, nperms). Feed ``perm_maxima`` to
    :func:`bulklmm_tpu_torch.get_thresholds_bulk` for per-trait FWER
    thresholds. ``maxlods`` stays on the device (~140 MB at 35,554 traits x
    1,001 columns): thresholds and adjusted p-values are small reductions
    there, and fetching the matrix is the caller's choice.
    """

    maxlods: torch.Tensor
    h2_null_list: torch.Tensor  # (m,)
    sigma2_e_list: torch.Tensor  # (m,)
    nperms: int = 0
    original: bool = True
    log10_adj_pvals: Optional[torch.Tensor] = None  # (m,) genome-wide adjusted
    h2_null_by_chrom: Optional[dict] = None  # LOCO: chrom -> (m,) h2s
    sigma2_by_chrom: Optional[dict] = None  # LOCO: chrom -> (m,) sigma2_e

    @property
    def perm_maxima(self) -> torch.Tensor:
        """(m, nperms) null maxima (observed column stripped)."""
        return self.maxlods[:, 1:] if self.original else self.maxlods

    @property
    def lod_max(self) -> Optional[torch.Tensor]:
        """(m,) observed genome-wide max LOD (``original=True`` only)."""
        return self.maxlods[:, 0] if self.original else None


def _attach_adj_pvals(result: BulkPermResult) -> BulkPermResult:
    """Permutation-adjusted genome-wide -log10 p per trait:
    (1 + #{null max >= observed}) / (nperms + 1), on the device."""
    if result.original and result.nperms > 0:
        exceed = (result.perm_maxima >= result.lod_max[:, None]).sum(1)
        result.log10_adj_pvals = -torch.log10(
            (1.0 + exceed.double()) / (result.nperms + 1.0)
        )
    return result


class _PermCheckpoint:
    """Per-trait-chunk checkpointing of the permutation sweep.

    With a checkpoint directory, each completed trait chunk's rows of
    genome-wide maxima are written to ``maxlods_<lo>_<hi>.npy`` and a
    ``meta.json`` fingerprints the run; calling again with the same
    arguments resumes, computing only the missing chunks (the shuffle
    indices depend only on (n, nperms, rndseed), so recomputed chunks are
    identical). A mismatch against an existing ``meta.json`` raises instead
    of mixing sweeps. Checkpointing reads each chunk's rows back, one
    synchronization per trait chunk.
    """

    def __init__(self, path, meta: dict):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.meta_path = self.dir / "meta.json"
        meta = {k: meta[k] for k in sorted(meta)}
        if self.meta_path.is_file():
            existing = json.loads(self.meta_path.read_text())
            if existing != meta:
                diff = {
                    k for k in set(existing) | set(meta) if existing.get(k) != meta.get(k)
                }
                raise ValueError(
                    f"checkpoint directory {self.dir} holds a different "
                    f"sweep (mismatched keys: {sorted(diff)}); point at a "
                    "fresh directory or delete it."
                )
        else:
            blob = json.dumps(meta, indent=1).encode()
            self._atomic_write("meta.json", lambda fh: fh.write(blob))

    def load(self, lo: int, hi: int):
        f = self.dir / f"maxlods_{lo}_{hi}.npy"
        return np.load(f) if f.is_file() else None

    def save(self, lo: int, hi: int, row) -> None:
        arr = to_numpy(row)  # waits for this chunk's device work
        self._atomic_write(f"maxlods_{lo}_{hi}.npy", lambda fh: np.save(fh, arr))

    # the marker-streamed sweep's state: the (m, K) running maxima and how
    # many marker blocks they hold

    def save_state(self, maxima, blocks_done: int) -> None:
        arr = to_numpy(maxima)  # waits for the blocks' device work
        self._atomic_write(
            "acc_state.npz", lambda fh: np.savez(fh, maxima=arr, blocks_done=blocks_done)
        )

    def load_state(self):
        f = self.dir / "acc_state.npz"
        if not f.is_file():
            return None
        z = np.load(f)
        return z["maxima"], int(z["blocks_done"])

    def _atomic_write(self, name: str, write) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                write(fh)
            # atomic publish: a kill mid-write never leaves a torn file
            os.replace(tmp, self.dir / name)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


def _data_fingerprint(*arrays, max_bytes: int = 1 << 28):
    """Order-sensitive content digest of a sweep's input arrays.

    Shapes and settings alone cannot tell "the same sweep" from "the same
    sweep on a corrected phenotype file"; resuming across such an edit
    would mix stale and fresh rows in one threshold matrix. This folds the
    bytes themselves into the checkpoint fingerprint.

    Arrays up to ``max_bytes`` (256 MB) are hashed whole. Larger ones are
    hashed by a sample of ~1,024 evenly spaced rows (column-subsampled if
    still too large) and a full-pass per-row integer checksum over the raw
    row bytes, ``sum_k byte[i, k] * w_k (mod 2^64)`` with fixed distinct
    uint64 weights, in row chunks: one edited byte anywhere moves its row's
    checksum. Integer arithmetic wraps identically everywhere, so the digest
    is stable across machines. Lazy containers (``np.memmap``) are sized
    from ``shape`` / ``dtype`` and read by slice only. A tensor is hashed by
    its host copy; a ``KinshipDecomposition`` or a ``LowRankKinship`` by its
    factors.
    """
    h = hashlib.blake2b(digest_size=16)

    def feed(a):
        if a is None:
            h.update(b"<none>")
            return
        if isinstance(a, KinshipDecomposition):
            feed(a.Ut_host if a.Ut_host is not None else a.Ut)
            feed(a.lam_host if a.lam_host is not None else a.lam)
            return
        if is_lowrank(a):
            feed(a.U)
            feed(a.lam)
            return
        if torch.is_tensor(a):
            a = to_numpy(a)
        # size without materializing: a memmap exposes shape and dtype
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            shape = tuple(int(s) for s in a.shape)
            dt = np.dtype(a.dtype)
        else:
            a = np.asarray(a)
            shape, dt = a.shape, a.dtype
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        h.update(str(dt).encode())
        h.update(str(shape).encode())
        if nbytes <= max_bytes:
            h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
            return
        rows = np.linspace(0, shape[0] - 1, num=min(shape[0], 1024)).astype(np.int64)
        sample = np.ascontiguousarray(np.asarray(a[rows]))
        if sample.nbytes > max_bytes:
            flat = sample.reshape(sample.shape[0], -1)
            ncols = max(1, max_bytes // max(1, flat[:, :1].nbytes))
            cols = np.linspace(
                0, flat.shape[1] - 1, num=min(flat.shape[1], ncols)
            ).astype(np.int64)
            sample = np.ascontiguousarray(flat[:, cols])
        h.update(sample.tobytes())
        row_nbytes = int(np.prod(shape[1:], dtype=np.int64)) * dt.itemsize
        # k * GOLD + 1 is a bijection of uint64 (GOLD odd): distinct, nonzero
        mult = np.arange(row_nbytes, dtype=np.uint64) * np.uint64(
            0x9E3779B97F4A7C15
        ) + np.uint64(1)
        # the uint64-widened byte block is 8x the raw bytes
        chunk = max(1, max_bytes // max(1, row_nbytes * 8))
        sums = np.empty(shape[0], dtype=np.uint64)
        for lo in range(0, shape[0], chunk):
            hi = min(lo + chunk, shape[0])
            blk = np.ascontiguousarray(np.asarray(a[lo:hi]))
            bb = blk.view(np.uint8).reshape(hi - lo, row_nbytes)
            sums[lo:hi] = (bb.astype(np.uint64) * mult[None, :]).sum(axis=1, dtype=np.uint64)
        h.update(sums.tobytes())

    for a in arrays:
        feed(a)
    return h.hexdigest()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _perm_checkpoint(checkpoint, *, n, m, p, nperms, rndseed, method, reml,
                     original, trait_chunk, h2_grid, prior, precision, engine,
                     data_digest, rank="full"):
    """The checkpoint handle (or None) with the run's fingerprint. The
    precision (its three dtypes) and the resolved engine are part of it:
    resuming an EXACT64 sweep under FAST32, or a kernel sweep with the plain
    engine, would mix numerics across trait chunks of one threshold matrix.
    ``data_digest`` guards against edited inputs of the same shape."""
    if checkpoint is None:
        return None
    meta = dict(
        n=int(n), m=int(m), p=int(p), nperms=int(nperms),
        rndseed=int(rndseed), method=str(method), reml=bool(reml),
        original=bool(original), trait_chunk=int(trait_chunk),
        h2_grid=[float(v) for v in to_numpy(h2_grid).ravel()],
        prior=[float(prior[0]), float(prior[1])], rank=str(rank),
        precision="/".join(_dtype_name(d) for d in (
            precision.resolve_solve(), precision.resolve_gemm(), precision.resolve_kernel()
        )),
        engine=str(engine), data=str(data_digest),
    )
    return _PermCheckpoint(checkpoint, meta)


def _resolve_perm_engine(engine, n, *, device, precision, interpret=False, p, trait_chunk=None,
                         traits=None, budget_bytes=None):
    """``(eng, cap, trait_chunk)``: the engine ("pallas", the fused CUDA
    kernel, or "xla", the plain engine), its permutation-chunk bound and the
    trait-block width (1,024 for the kernel and 16 for the plain engine
    when ``trait_chunk`` is None). The bound is the engine's memory rule for
    the traits a block actually holds: ``min(trait_chunk, traits)``, the
    block itself when ``traits`` is None. ``budget_bytes`` bounds the
    kernel's permutation chunk in place of a quarter of ``device``'s budget
    (``ops/bulkperm.py::kernel_perm_chunk_cap``). The engine is
    ``bulkscan.py::takes_cuda_kernel``'s, ``interpret=True`` running the
    kernel's plain version on any device under any preset.
    """
    eng = "pallas" if _bulkscan.takes_cuda_kernel(engine, precision, device, interpret=interpret,
                                                  texts=PERM_TEXTS) else "xla"
    if trait_chunk is None:
        trait_chunk = 1024 if eng == "pallas" else 16
    held = trait_chunk if traits is None else min(trait_chunk, traits)
    if eng == "pallas":
        return eng, kernel_perm_chunk_cap(n, held, budget_bytes, device=device), trait_chunk
    cap = plain_perm_chunk_cap(
        n, p, trait_chunk=held,
        gemm_itemsize=precision.resolve_gemm().itemsize,
        kernel_itemsize=precision.resolve_kernel().itemsize,
    )
    return "xla", cap, trait_chunk


@spanned("bulklmm.prep.shuffles")
def shuffle_indices(perm_idx, n: int, nperms: int, rndseed, original: bool):
    """The (K, n) shuffle indices of a sweep over n samples: drawn from
    ``rndseed``, or the caller's ``perm_idx`` (an array, or a function of n
    that returns one), checked."""
    if perm_idx is None:
        return permutation_indices(n, nperms, rndseed, original=original)
    if callable(perm_idx):
        perm_idx = perm_idx(n)
    return check_permutation_indices(perm_idx, n, nperms, original=original)


def _bulkperm_prep_traits(
    Y, C, Ut, lam, h2_grid, *, prior, reml, method, optim_interval, precision
):
    """Trait-side preparation (no markers): rotation, per-trait null fits
    and whitening parts. Returns ``(h2_list, sigma2_list, sqrtw, Qstack,
    wrn)`` with sqrtw (m, n), Qstack (m, c, n) and wrn (n, m) in the kernel
    dtype."""
    with span("bulklmm.prep.rotate"):
        Y0, C0 = Ut @ Y, Ut @ C
    with span("bulklmm.prep.null_fit"):
        if method == "null-grid":
            kdt = precision.resolve_kernel()
            ells = grid_null_ell(
                Y0.to(kdt), C0.to(kdt), lam.to(kdt), h2_grid.to(kdt), prior, reml=reml
            )
            h2_list = h2_grid[torch.argmax(ells, dim=0)]  # first max wins
        else:
            h2_list = fit_h2_traits(Y0, C0, lam, prior, reml=reml, optim_interval=optim_interval)
        # every trait's sigma2 at its own h2, one batched call over (m, n) weights
        sigma2_list = wls_ell_columns(Y0, C0, make_weights(h2_list, lam), prior, reml=reml)[1]
    sqrtw, Q, wrn = perm_trait_parts(Y0, C0, lam, h2_list, precision=precision)
    Qstack = torch.stack(Q, dim=0).permute(2, 0, 1).contiguous()  # (m, c, n)
    return h2_list, sigma2_list, sqrtw.T.contiguous(), Qstack, wrn


@spanned("bulklmm.prep.inputs")
def _bulkperm_prep(Y, Xm, C, Ut, lam, h2_grid, **kw):
    """The rotated markers and covariates and the trait-side preparation."""
    with span("bulklmm.prep.rotate"):
        X0m, C0 = Ut @ Xm, Ut @ C
    return (X0m, C0) + _bulkperm_prep_traits(Y, C, Ut, lam, h2_grid, **kw)


def _trait_block_lods(
    X0m, X32, sw_b, Q_b, wrn_b, idx, *, engine, n, perm_chunk, precision, interpret
):
    """(mb, K) genome-wide max LODs of one trait block, its permutation
    chunks in turn; no host synchronization. The permutation-independent
    marker parts are formed once per block."""
    cols = []
    if engine == "pallas":
        maxlods = fused_perm_maxlods_reference if interpret else fused_perm_maxlods
        inv_xn = prepare_trait_block(X0m, sw_b, Q_b, precision=precision)
        for ks in range(0, idx.shape[0], perm_chunk):
            S2 = prepare_chunk_inputs(sw_b, Q_b, wrn_b, idx[ks : ks + perm_chunk])
            cols.append(maxlods(X32, S2, inv_xn, n=n, dot_precision=precision.gemm_precision))
    else:
        pXs, xns = perm_trait_marker_parts(X0m, sw_b, Q_b, precision=precision)
        for ks in range(0, idx.shape[0], perm_chunk):
            maxr2 = max_r2_perms_plain(
                X0m, sw_b, Q_b, pXs, xns, wrn_b, idx[ks : ks + perm_chunk], precision=precision
            )
            cols.append(maxr2_to_lod(maxr2, n, precision=precision))
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


@with_highest_matmul()
def _bulkperm_prep_traits_lowrank(Y, C, U, lam, h2_grid, *, n, prior, reml, method,
                                  optim_interval, precision):
    """Trait-side preparation on a rank-k kinship (nothing rotated): the
    per-trait null fits on the Woodbury likelihood and the
    standard-coordinate whitening parts. Returns ``(h2_list, sigma2_list,
    sm1, Qstack, wrn)``."""
    lr = LowRankKinship(U=U, lam=lam)
    kw = _parts_kwargs(precision)
    kdt = precision.resolve_kernel()
    parts = {**_shared_parts(C, lr, **kw), **_trait_side_parts(Y, C, lr, **kw)}
    lam_k = lam.to(kdt)
    if method == "null-grid":
        ells = grid_null_ell_lowrank(parts, lam_k, h2_grid.to(kdt), prior, n=n, reml=reml)
        h2_list = h2_grid[torch.argmax(ells, dim=0)]  # first max wins
    else:
        # Brent in the solve dtype (ops/lowrank.py's module docstring)
        h2_list = fit_h2_lowrank(parts, lam, prior, n=n, reml=reml, optim_interval=optim_interval)
    sigma2_list = null_sigma2_lowrank(parts, lam_k, h2_list.to(kdt), prior, n=n, reml=reml)
    sm1, Qstack, wrn = perm_trait_parts_lowrank(Y, C, U, lam, h2_list, precision=precision)
    return h2_list, sigma2_list, sm1, Qstack, wrn


def _lowrank_block_lods(X, U, mparts, sm1_b, Q_b, wrn_b, idx, *, n, perm_chunk, precision):
    """(mb, K) genome-wide max LODs of one trait block on a rank-k kinship,
    its permutation chunks in turn. ``mparts`` is
    ``ops/bulkperm.py::lowrank_perm_marker_parts``'s; the whitened marker
    norms are formed once a block."""
    UtX, UtX2, xsq = mparts
    qXs, xns = lowrank_perm_trait_marker_parts(X, U, UtX, UtX2, xsq, sm1_b, Q_b,
                                               precision=precision)
    cols = [
        maxr2_to_lod(max_r2_perms_lowrank(X, U, UtX, sm1_b, Q_b, qXs, xns, wrn_b,
                                          idx[ks : ks + perm_chunk], precision=precision),
                     n, precision=precision)
        for ks in range(0, idx.shape[0], perm_chunk)
    ]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


@spanned("bulklmm.entry.budget")
def _mesh_perm_tiling(mesh: Mesh, *, engine, n, m, p, precision, interpret, trait_chunk,
                      perm_chunk):
    """Engine choice and tiling of a dense-kinship permutation sweep on a
    mesh (one position for ``bulkscan_perms``): the one place that computes
    them, shared by :func:`_bulkscan_perms_on_mesh` and the streamed sweep
    (``streaming.py``) so that their tilings agree.

    The engine follows the mesh's first device. ``trait_chunk`` is the
    global trait block (default: the single-device engine's block, 1,024
    for the kernel and 16 for the plain engine, on every trait shard),
    rounded up to the trait quantum, the traits axis; the permutation-row
    quantum is the markers axis. The per-device permutation width is
    ``perm_chunk`` capped by the engine's memory rule for the traits one
    device holds of a block of the sweep's ``m`` traits,
    ``min(trait_chunk / shards, ceil(m / shards))``, the kernel's against
    one mesh position's budget (``utils/memory.py::mesh_position_budget``):
    a sweep of fewer traits than a block takes wider, fewer permutation
    chunks under the same budget. The JAX package's TPU
    quanta (8 traits a shard for the Pallas output tiles, 128 permutation
    rows a shard) have no counterpart here.

    Returns ``(eng, trait_chunk, pc_dev, quantum, row_quant)``.
    """
    tshards, mshards = mesh.shape[TRAITS_AXIS], mesh.shape[MARKERS_AXIS]
    block = None if trait_chunk is None else -(-max(int(trait_chunk), 1) // tshards)
    eng, cap, block = _resolve_perm_engine(
        engine, n, device=mesh.first, precision=precision, interpret=interpret, p=p,
        trait_chunk=block, traits=-(-max(int(m), 1) // tshards),
        budget_bytes=memory.mesh_position_budget(mesh.flat) // 4,
    )
    return eng, block * tshards, min(perm_chunk, cap), tshards, mshards


def _lowrank_perm_tiling(mesh: Mesh, n, p, precision, trait_chunk, perm_chunk):
    """``(trait_chunk, pc_dev)`` of the rank-k sweep on a mesh: 16 traits a
    shard by default, the per-device permutation width capped by the rank-k
    memory rule for one device's trait block and one position's budget."""
    tshards = mesh.shape[TRAITS_AXIS]
    trait_chunk = 16 * tshards if trait_chunk is None else trait_chunk
    trait_chunk += (-trait_chunk) % tshards
    itemsize = max(precision.resolve_gemm().itemsize, precision.resolve_kernel().itemsize)
    cap = lowrank_perm_chunk_cap(n, p, trait_chunk // tshards, itemsize,
                                 budget_bytes=memory.mesh_position_budget(mesh.flat) // 4)
    return trait_chunk, min(perm_chunk, cap)


@spanned("bulklmm.prep.inputs")
def _full_rank_block_lods(mesh: Mesh, X0m, C0, *, eng, n, pc_dev, precision, interpret):
    """``block_lods`` of ``tiles.py::_PermTiles.row`` on a rotated marker
    panel X0m (a block of one, in the streamed sweep) and the rotated
    covariates C0: the panel placed once a device, the permutation kernel's
    chunks (or the plain engine's) on each tile. The kernel's route takes
    the markers off the covariates' span first
    (``ops/smallchol.py::off_covariates``)."""
    if eng == "pallas":
        X0m = off_covariates(X0m, C0)
    X = _per_device(mesh, lambda d: X0m.to(d))
    # the kernel reads a contiguous float32 panel; the plain engine none
    X32 = {d: x.to(torch.float32).contiguous() if eng == "pallas" else None for d, x in X.items()}

    def block_lods(dev, sw_b, Q_b, wrn_b, idx):
        return _trait_block_lods(X[dev], X32[dev], sw_b, Q_b, wrn_b, idx, engine=eng, n=n,
                                 perm_chunk=pc_dev, precision=precision, interpret=interpret)

    return block_lods


def _lowrank_block_lods_on(mesh: Mesh, X, U, *, n, pc_dev, precision):
    """``block_lods`` of ``tiles.py::_PermTiles.row`` on a rank-k kinship:
    the markers (in the kernel dtype) and the factor placed once a device,
    the marker projections formed once a device."""
    Xd = _per_device(mesh, lambda d: X.to(d))
    Ud = _per_device(mesh, lambda d: U.to(d))
    mparts = {d: lowrank_perm_marker_parts(Xd[d], Ud[d], precision=precision) for d in Xd}

    def block_lods(dev, sm1_b, Q_b, wrn_b, idx):
        return _lowrank_block_lods(Xd[dev], Ud[dev], mparts[dev], sm1_b, Q_b, wrn_b, idx, n=n,
                                   perm_chunk=pc_dev, precision=precision)

    return block_lods


def _check_perm_args(method, engine, solve_method) -> None:
    if method not in ("null-grid", "null-exact"):
        raise ValueError("method must be one of 'null-grid', 'null-exact'")
    _bulkscan.takes_cuda_kernel(engine)
    if method == "null-exact" and solve_method not in ("qr", "cholesky"):
        raise ValueError(f"unknown method {solve_method!r}; use 'qr' or 'cholesky'")


def _bulkscan_perms_on_mesh(
    Y, G, K, covar, *, mesh: Mesh, sharded: bool, nperms, rndseed, method, h2_grid,
    add_intercept, weights, prior_variance, prior_sample_size, reml, solve_method,
    optim_interval, decomp_scheme, precision, engine, trait_chunk, perm_chunk, original, tile_p,
    interpret, checkpoint, _adj_pvals, missing, perm_idx,
) -> BulkPermResult:
    """The sweep of :func:`bulkscan_perms` (a mesh of one position) and
    :func:`bulkscan_perms_sharded` (``sharded``: its name in errors, and the
    checkpoint rank keys "full-sharded" / "lowrank<k>-sharded" in place of
    "full" / "lowrank<k>").

    The trait-side preparation (rotation, null fits, whitening parts) runs
    once, on the mesh's first device; then device (i, j) computes trait
    shard i x permutation shard j of every global trait block against the
    replicated marker panel (``tiles.py::_PermTiles``; the permutation
    kernel's chunks on CUDA tiles under the float32 presets). The rows stay
    on the device and every step is enqueued without a host read (unless
    checkpointing); one concatenation at the end.
    """
    what = "bulkscan_perms_sharded" if sharded else "bulkscan_perms"
    validate_missing_kwarg(missing)
    _check_perm_args(method, engine, solve_method)
    lowrank = is_lowrank(K)
    _bulkscan.takes_cuda_kernel(engine, lowrank=lowrank, texts=PERM_TEXTS)  # "pallas" raises
    kw = dict(
        mesh=mesh, sharded=sharded, nperms=nperms, rndseed=rndseed, method=method,
        h2_grid=h2_grid, add_intercept=add_intercept, prior_variance=prior_variance,
        prior_sample_size=prior_sample_size, reml=reml, solve_method=solve_method,
        optim_interval=optim_interval, decomp_scheme=decomp_scheme, precision=precision,
        engine=engine, trait_chunk=trait_chunk, perm_chunk=perm_chunk, original=original,
        tile_p=tile_p, interpret=interpret, _adj_pvals=_adj_pvals, perm_idx=perm_idx,
    )
    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: _bulkscan_perms_on_mesh(
            Ys, _take_rows(G, rows), subset_kinship(K, rows), _take_rows(covar, rows),
            weights=_take_rows(weights, rows), checkpoint=group_checkpoint(checkpoint, gi),
            missing="error", **kw,
        ),
        covar=covar, weights=weights, add_intercept=add_intercept, what=what,
    )
    if masked is not None:
        return masked
    dev0 = mesh.first
    # digest of the raw inputs, before any conversion
    data_digest = (
        _data_fingerprint(Y, G, covar, weights, K) if checkpoint is not None else None
    )
    Y, covar, h2_grid, add_intercept = _traits_covar_grid(Y, covar, h2_grid, add_intercept, dev0)
    finite = finite_flag(Y)
    G = to_device(G, dev0)
    n, m = Y.shape
    if weights is not None:
        _refuse_weights_on_factors(K, " or rank-k factorization")
        Y, G, covar, K, add_intercept = _apply_weights(Y, G, covar, K, weights, add_intercept)
        Y, G, covar = (torch.as_tensor(a, device=dev0) for a in (Y, G, covar))
    if add_intercept:
        covar = torch.cat([torch.ones((n, 1), dtype=covar.dtype, device=dev0), covar], 1)
    prior = (float(prior_variance), float(prior_sample_size))
    p = G.shape[1]
    dtype = precision.resolve_solve()
    idx = shuffle_indices(perm_idx, n, nperms, rndseed, original)
    prep_kw = dict(prior=prior, reml=reml, method=method, optim_interval=optim_interval,
                   precision=precision)
    suffix = "-sharded" if sharded else ""
    if lowrank:
        U, lam = as_lowrank(K, dtype, dev0)
        h2_list, sigma2_list, *trait_ops = _bulkperm_prep_traits_lowrank(
            Y.to(dtype), covar.to(dtype), U, lam, h2_grid.to(dtype), n=n, **prep_kw,
        )
        trait_chunk, pc_dev = _lowrank_perm_tiling(mesh, n, p, precision, trait_chunk, perm_chunk)
        eng, rank, row_quant = "xla", f"lowrank{U.shape[1]}{suffix}", mesh.shape[MARKERS_AXIS]
        # every product reads the markers in the kernel dtype: cast once
        block_lods = _lowrank_block_lods_on(mesh, G.to(precision.resolve_kernel()), U, n=n,
                                            pc_dev=pc_dev, precision=precision)
    else:
        with span("bulklmm.prep.rotate"):
            Ut, lam = resolve_kinship(K, decomp_scheme, dtype, dev0)
        with with_highest_matmul():
            X0m, C0, h2_list, sigma2_list, *trait_ops = _bulkperm_prep(
                Y.to(dtype), G.to(dtype), covar.to(dtype), Ut, lam, h2_grid.to(dtype),
                **prep_kw,
            )
        eng, trait_chunk, pc_dev, _, row_quant = _mesh_perm_tiling(
            mesh, engine=engine, n=n, m=m, p=p, precision=precision, interpret=interpret,
            trait_chunk=trait_chunk, perm_chunk=perm_chunk,
        )
        rank = f"full{suffix}"
        block_lods = _full_rank_block_lods(mesh, X0m, C0, eng=eng, n=n, pc_dev=pc_dev,
                                           precision=precision, interpret=interpret)
    ckpt = _perm_checkpoint(
        checkpoint, n=n, m=m, p=p, nperms=nperms, rndseed=rndseed, method=method, reml=reml,
        original=original, trait_chunk=trait_chunk, h2_grid=h2_grid, prior=prior, rank=rank,
        precision=precision, engine=eng, data_digest=data_digest,
    )
    with span("bulklmm.prep.shuffles"):
        tiles = _PermTiles(mesh, idx, trait_ops, row_quant=row_quant)
    rows = []
    for ms in range(0, m, trait_chunk):
        me = min(ms + trait_chunk, m)
        with span("bulklmm.entry.chunk", {"traits": me - ms}):
            done = ckpt.load(ms, me) if ckpt is not None else None
            if done is not None:
                rows.append(torch.as_tensor(done, device=dev0))
                continue
            row = tiles.row(ms, me, block_lods)
            if ckpt is not None:
                ckpt.save(ms, me, row)
            rows.append(row)
    res = BulkPermResult(
        maxlods=rows[0] if len(rows) == 1 else torch.cat(rows, dim=0),
        h2_null_list=h2_list, sigma2_e_list=sigma2_list, nperms=nperms, original=original,
    )
    raise_if_missing(finite, what)
    return _attach_adj_pvals(res) if _adj_pvals else res


@spanned("bulklmm.entry.bulkscan_perms", numbered=True)
def bulkscan_perms(
    Y,
    G,
    K,
    covar=None,
    *,
    nperms: int = 1000,
    rndseed: int = 0,
    method: str = "null-grid",
    h2_grid=None,
    add_intercept: bool = True,
    weights=None,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    solve_method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    engine: str = "auto",
    trait_chunk: Optional[int] = None,
    perm_chunk: int = 2048,
    original: bool = True,
    tile_p: int = 256,
    interpret: bool = False,
    checkpoint=None,
    _adj_pvals: bool = True,
    missing: str = "error",
    perm_idx=None,
    device=None,
) -> BulkPermResult:
    """Permutation-null genome-wide max LODs for every trait at once.

    Per trait this is the single-trait permutation scan followed by a max
    over markers (the same whitened-residual shuffles, one set of shuffle
    indices for all traits), with the null h2 fitted per trait the
    ``bulkscan`` way (``method``: "null-grid", the grid argmax and the
    default, or "null-exact", a per-trait Brent fit). The keyword surface
    is the JAX package's ``bulkscan_perms``, plus ``perm_idx`` and
    ``device``.

    ``engine``: "pallas" is the fused CUDA kernel (float32 GEMM presets on a
    CUDA device, else a ``ValueError``; with ``interpret=True`` its plain
    version, on any device), "xla" the plain chunked engine in the preset's
    own dtypes, "auto" the kernel on a CUDA device under a float32 GEMM
    dtype and the plain engine otherwise. ``trait_chunk`` (default 1,024
    for the kernel, 16 for the plain engine) and ``perm_chunk`` bound the
    device memory of one step; ``perm_chunk`` is also capped from the
    engine's memory rule (``ops/bulkperm.py``) for the traits a block
    actually holds, at most the sweep's m. ``tile_p`` is accepted for
    the surface's sake and ignored: the CUDA kernel has no marker-tile
    parameter. ``solve_method`` is checked and has no effect (no
    coefficient solve is returned).

    ``perm_idx``: a (K, n) integer array that replaces the drawn shuffle
    indices, K = nperms (+1 when ``original``; row 0 then the identity), or
    a function of n that returns one (so that each missingness group of a
    masked call, with its own n, takes its own).
    Without it the indices come from a CPU ``torch.Generator`` seeded with
    ``rndseed`` (the same on the CPU and on a card). The JAX package draws
    its indices with another generator, so for the same seed the two
    packages' permutation columns are different draws from the same null:
    their parity is distributional, and exact only when that package's
    indices are passed here.

    ``K`` may be a ``LowRankKinship``: the rank-k engine
    (:func:`_lowrank_block_lods`; plain products, trait blocks of 16 by
    default, ``engine="pallas"`` refused as in the JAX package).

    ``checkpoint``: a directory; completed trait chunks are saved there and
    a repeated call resumes (:class:`_PermCheckpoint`). With
    ``missing="mask"/"drop"`` each pattern group keeps its own
    subdirectory (``pattern_000``, ...).

    ``missing``: "error" (default), "mask" or "drop", as for ``bulkscan``;
    each pattern group is a sweep of its own rows, with the shuffle indices
    of its own n.

    ``device`` defaults to the first tensor's among ``Y``, ``G``, ``K`` and
    ``covar``; with numpy inputs only it is the current CUDA device, and
    without one the call raises (``device="cpu"`` runs the plain versions
    on the CPU).

    Returns a :class:`BulkPermResult`; ``log10_adj_pvals`` holds -log10 of
    the permutation-adjusted genome-wide p-value of each trait,
    ``(1 + #{null max >= observed}) / (nperms + 1)``.
    """
    _check_perm_args(method, engine, solve_method)
    validate_missing_kwarg(missing)
    device = resolve_device(device, Y, G, K, covar)
    return _bulkscan_perms_on_mesh(
        Y, G, K, covar, mesh=Mesh.single(device), sharded=False, nperms=nperms,
        rndseed=rndseed, method=method, h2_grid=h2_grid, add_intercept=add_intercept,
        weights=weights, prior_variance=prior_variance, prior_sample_size=prior_sample_size,
        reml=reml, solve_method=solve_method, optim_interval=optim_interval,
        decomp_scheme=decomp_scheme, precision=precision, engine=engine, trait_chunk=trait_chunk,
        perm_chunk=perm_chunk, original=original, tile_p=tile_p, interpret=interpret,
        checkpoint=checkpoint, _adj_pvals=_adj_pvals, missing=missing, perm_idx=perm_idx,
    )


def bulkscan_perms_sharded(
    Y,
    G,
    K,
    covar=None,
    *,
    mesh: Optional[Mesh] = None,
    nperms: int = 1000,
    rndseed: int = 0,
    method: str = "null-grid",
    h2_grid=None,
    add_intercept: bool = True,
    weights=None,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    solve_method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    engine: str = "auto",
    trait_chunk: Optional[int] = None,
    perm_chunk: int = 2048,
    original: bool = True,
    tile_p: int = 256,
    interpret: bool = False,
    checkpoint=None,
    _adj_pvals: bool = True,
    missing: str = "error",
    perm_idx=None,
) -> BulkPermResult:
    """All-trait permutation maxima sharded over the device mesh.

    The sweep of :func:`bulkscan_perms` (:func:`_bulkscan_perms_on_mesh`)
    on ``mesh`` (default ``make_mesh()``): device (i, j) computes trait
    shard i x permutation shard j of every global trait block against the
    replicated marker panel (the permutation kernel's chunks on CUDA tiles
    under the float32 presets), with no collective. ``trait_chunk`` is the
    global trait block (:func:`_mesh_perm_tiling`); ``perm_chunk`` is the
    PER-DEVICE permutation width, so that one step's memory matches the
    single-device engine at the same value, where the keyword is the global
    width; results are unaffected. ``K`` may be a ``LowRankKinship`` (the
    rank-k engine, ``engine="pallas"`` refused). ``checkpoint`` saves and
    resumes global trait blocks as ``bulkscan_perms`` does (the run's rank
    key "full-sharded" or "lowrank<k>-sharded"); ``missing``, ``weights``,
    ``perm_idx`` as there. The result's tensors lie on the mesh's first
    device.
    """
    _check_perm_args(method, engine, solve_method)
    if mesh is None:
        mesh = make_mesh()
    return _bulkscan_perms_on_mesh(
        Y, G, K, covar, mesh=mesh, sharded=True, nperms=nperms, rndseed=rndseed,
        method=method, h2_grid=h2_grid, add_intercept=add_intercept, weights=weights,
        prior_variance=prior_variance, prior_sample_size=prior_sample_size, reml=reml,
        solve_method=solve_method, optim_interval=optim_interval, decomp_scheme=decomp_scheme,
        precision=precision, engine=engine, trait_chunk=trait_chunk, perm_chunk=perm_chunk,
        original=original, tile_p=tile_p, interpret=interpret, checkpoint=checkpoint,
        _adj_pvals=_adj_pvals, missing=missing, perm_idx=perm_idx,
    )
