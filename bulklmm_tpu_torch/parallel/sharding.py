"""Sharded scan engines over a (traits x markers) grid of devices.

Counterpart of ``bulklmm_tpu/parallel/sharding.py``: the public face of
the port's device mesh. The mesh itself (``Mesh``, ``make_mesh``, the tile
runner and the assembly of the results) is ``models/tiles.py``, and the
sharded bulk engines are the single-device engines' own bodies run on a
mesh: ``bulkscan_sharded`` in ``models/bulkscan.py``,
``bulkscan_perms_sharded`` in ``models/bulkperm.py``, so that the streamed
engines and LOCO reach them without importing this package. Here are the
rest: :func:`shard_rotated` and the single-trait permutation scan
:func:`scan_perms_sharded`.

Device (i, j) owns trait shard i x marker shard j (permutation shard j in
the permutation engines); each CUDA tile launches the hand-written kernels
on its own device, the hot path has no collective, and results are
assembled on the mesh's first device, the counterpart of JAX's globally
sharded array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.bulkperm import bulkscan_perms_sharded
from ..models.bulkscan import bulkscan_sharded
from ..models.results import ScanResult
from ..models.scan import _one_trait, _perm_scan_lods, _perm_scan_operands, _rotated_with_null_fit
from ..models.tiles import (
    MARKERS_AXIS, TRAITS_AXIS, Mesh, _assemble, _pad_cols, _per_device, _run_tiles, make_mesh,
)
from ..ops.stats import check_covar_full_rank
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig

__all__ = [
    "MARKERS_AXIS",
    "TRAITS_AXIS",
    "Mesh",
    "bulkscan_perms_sharded",
    "bulkscan_sharded",
    "make_mesh",
    "scan_perms_sharded",
    "shard_rotated",
]


def shard_rotated(y0, X0, lam, n_covars: int, mesh: Mesh):
    """Place rotated data on the mesh: traits sharded, markers sharded,
    covariates and eigenvalues replicated. Pads the trait and marker counts
    to the mesh axes (the caller slices the padding off its results).

    Returns ``(y0s, X0ms, C0s, lams, m, p)``: the first four map each tile
    ``(i, j, device)`` to its operand on its device (trait shard i, marker
    shard j; the replicated ones placed once a device).
    """
    tshards, mshards = mesh.shape[TRAITS_AXIS], mesh.shape[MARKERS_AXIS]
    y0p, m = _pad_cols(y0, tshards)
    Xm, p = _pad_cols(X0[:, n_covars:], mshards)
    w, pp = y0p.shape[1] // tshards, Xm.shape[1] // mshards
    C0 = _per_device(mesh, lambda d: X0[:, :n_covars].to(d))
    lamd = _per_device(mesh, lambda d: lam.to(d))
    tiles = mesh.tiles()
    return (
        {t: y0p[:, t[0] * w:(t[0] + 1) * w].to(t[2]) for t in tiles},
        {t: Xm[:, t[1] * pp:(t[1] + 1) * pp].to(t[2]) for t in tiles},
        {t: C0[t[2]] for t in tiles},
        {t: lamd[t[2]] for t in tiles},
        m, p,
    )


def scan_perms_sharded(
    y,
    g,
    K,
    covar=None,
    *,
    mesh: Optional[Mesh] = None,
    nperms: int = 1024,
    rndseed: int = 0,
    add_intercept: bool = True,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    method: str = "qr",
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    perm_idx=None,
) -> ScanResult:
    """Single-trait permutation scan with the permutation columns sharded
    over the mesh's traits axis and the markers over its markers axis.

    The operands of ``scan(permutation_test=True)`` (the host float64 null
    fit, the whitened residual and its shuffles, the residualized markers)
    are formed once on the mesh's first device; tile (i, j) computes the
    (p / marker shards, (nperms + 1) / trait shards) block of LODs. Unlike
    the JAX package, which rounds ``nperms`` up to the traits axis and draws
    that many, exactly ``nperms`` shuffles are drawn (or taken from
    ``perm_idx``, as for ``scan``) and the padding columns are zeros, so the
    result equals the unsharded ``scan`` with the same indices.
    """
    if mesh is None:
        mesh = make_mesh()
    dev0 = mesh.first
    y = _one_trait(y, "scan_perms_sharded handles one trait; use bulkscan_perms_sharded.")
    n = y.shape[0]
    if covar is None:
        covar = np.ones((n, 1))
        add_intercept = False
    else:
        covar = np.asarray(covar, dtype=np.float64)
        covar = covar[:, None] if covar.ndim == 1 else covar
        check_covar_full_rank(covar, add_intercept)
    if add_intercept:
        covar = np.concatenate([np.ones((n, 1)), covar], axis=1)
    dtype = precision.resolve_solve()
    y0, X0m, C0, lam, (b, sigma2_e, h2, _) = _rotated_with_null_fit(
        y, torch.as_tensor(g, device=dev0), covar, K, decomp_scheme=decomp_scheme,
        prior=(float(prior_variance), float(prior_sample_size)), reml=reml,
        optim_interval=optim_interval, dtype=dtype, device=dev0,
    )
    X00n, r0n = _perm_scan_operands(y0, X0m, C0, lam, b, h2, method=method, nperms=nperms,
                                    rndseed=rndseed, perm_idx=perm_idx)
    tshards, mshards = mesh.shape[TRAITS_AXIS], mesh.shape[MARKERS_AXIS]
    Xp, p = _pad_cols(X00n, mshards)
    Rp, K_cols = _pad_cols(r0n, tshards)
    pp, w = Xp.shape[1] // mshards, Rp.shape[1] // tshards

    def tile(i, j, dev):
        return (_perm_scan_lods(Xp[:, j * pp:(j + 1) * pp].to(dev),
                                Rp[:, i * w:(i + 1) * w].to(dev), n, precision),)

    (L,) = _assemble(_run_tiles(mesh.tiles(), tile), mesh, w, K_cols)
    L = L[:p]
    return ScanResult(sigma2_e=sigma2_e, h2_null=h2, lod=L[:, 0], L_perms=L[:, 1:])
