"""Profile likelihood over a heritability grid.

Counterpart of ``bulklmm_tpu/analysis/profile_ll.py`` (reference ``getLL``
/ ``profile_LL``, src/analysis_helpers/single_trait_analysis.jl:29-75). The
reference loops over the grid; here the grid is one batch dimension of
``wls``, which takes one weight vector per grid point.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.rotation import transform_rotation
from ..ops.weights import make_weights
from ..ops.wls import wls
from ..utils.device import resolve_device
from ..utils.host import to_numpy


class ProfileLL(NamedTuple):
    ll_list_null: torch.Tensor
    ll_list_alt: torch.Tensor


def _profile_rotated(y0, C0, x0, lam, h2, prior, reml):
    """(ll_null, ll_marker) of the rotated trait against the covariates
    ``C0`` and ``[C0, x0]``, at ``h2`` (a scalar, or (g,) for a grid)."""
    w = make_weights(h2, lam)
    ll_null = wls(y0, C0, w, prior, reml=reml).ell
    ll_marker = wls(y0, torch.cat([C0, x0[:, None]], 1), w, prior, reml=reml).ell
    if w.ndim == 1:
        return ll_null[0], ll_marker[0]
    return ll_null, ll_marker


def getLL(
    y0,
    X0,
    lam,
    num_of_covar: int,
    marker_id: int,
    h2,
    *,
    prior: Tuple[float, float] = (0.0, 0.0),
    reml: bool = False,
):
    """(ll_null, ll_marker) at ``h2`` (a scalar, or a (g,) tensor of grid
    points) for rotated tensors: ``X0`` holds the covariates first, then the
    markers. ``marker_id`` is 1-based like the reference (X0 column
    ``num_of_covar + marker_id - 1``)."""
    h2 = torch.as_tensor(h2, dtype=lam.dtype, device=lam.device)
    return _profile_rotated(
        y0, X0[:, :num_of_covar], X0[:, num_of_covar + marker_id - 1], lam, h2, prior, reml
    )


def profile_LL(
    y,
    G,
    covar,
    K,
    h2_grid,
    marker_id: int,
    *,
    prior: Tuple[float, float] = (0.0, 0.0),
    reml: bool = False,
    device=None,
) -> ProfileLL:
    """Null and alternative log-likelihoods across ``h2_grid`` for one
    marker (1-based ``marker_id``). ``covar`` is the whole covariate design
    (no intercept is added). Only the covariates and that marker's column
    are rotated. The rotation runs in ``DEFAULT_PRECISION``'s dtype, torch's
    default (float64 after :func:`~bulklmm_tpu_torch.utils.config.
    enable_x64`). ``device`` as for the scans
    (``utils/device.py::resolve_device``)."""
    device = resolve_device(device, y, G, covar, K)
    check_marker_id(marker_id, np.shape(G)[1])
    covar = torch.as_tensor(covar, device=device)
    covar = covar[:, None] if covar.ndim == 1 else covar
    x = torch.as_tensor(G, device=device)[:, marker_id - 1 : marker_id]
    design = torch.cat([covar.to(torch.promote_types(covar.dtype, x.dtype)), x], 1)
    rot = transform_rotation(y, design, K, add_intercept=False, device=device)
    if not torch.is_tensor(h2_grid):
        h2_grid = np.asarray(to_numpy(h2_grid), dtype=np.float64)
    grid = torch.as_tensor(h2_grid, device=device).to(rot.y0.dtype)
    c = covar.shape[1]
    ll_null, ll_alt = _profile_rotated(
        rot.y0, rot.X0[:, :c], rot.X0[:, c], rot.lam, grid, prior, reml
    )
    return ProfileLL(ll_list_null=ll_null, ll_list_alt=ll_alt)


def check_marker_id(marker_id: int, p: int) -> None:
    """Refuse a ``marker_id`` outside the 1-based range [1, p]; 0 would
    silently profile the last covariate."""
    if not 1 <= int(marker_id) <= p:
        raise ValueError(f"marker_id must be a 1-based marker index in [1, {p}]; got {marker_id}")
