"""FaST-LMM decorrelation: kinship eigendecomposition and rotation.

Counterpart of ``bulklmm_tpu/ops/rotation.py`` (reference
src/transform_helpers.jl):

- ``transform_rotation`` (:1-55): the O(n^3) symmetric eigendecomposition
  runs on the host in float64 LAPACK, so on the same K its factors are those
  of the JAX package exactly; the O(n^2 (p + c + m)) rotation products run
  on the tensors' device.
- ``transform_reweight`` (:57-92): fit the null model on the covariates,
  residualize, sqrt-weight, project the covariates out of the markers.
- ``transform_permute`` (:94-102): shuffles of the weighted null residual,
  iid under the null; the indices of ``ops/bulkperm.py::
  permutation_indices`` or the caller's ``perm_idx``.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import resolve_device
from ..utils.host import to_device, to_numpy
from .bulkperm import check_permutation_indices
from .stats import shuffle_vector
from .weights import make_weights
from .wls import resid


class RotatedData(NamedTuple):
    """``y0 = U^T y``, ``X0 = U^T [covar geno]`` and the eigenvalues ``lam``
    (ascending for decomp_scheme='eigen', descending for 'svd')."""

    y0: torch.Tensor
    X0: torch.Tensor
    lam: torch.Tensor


class KinshipDecomposition(NamedTuple):
    """Cached kinship eigendecomposition, resident on a device.

    Decompose once with :func:`decompose_kinship` (or carry the JAX
    package's factors over with :func:`decomposition_from_numpy`) and pass
    it wherever ``K`` is accepted: repeated scans then skip the host
    eigendecomposition and the upload of the (n, n) eigenvectors.
    """

    Ut: torch.Tensor  # (n, n) transposed eigenvectors
    lam: torch.Tensor  # (n,) eigenvalues
    Ut_host: "np.ndarray | None" = None  # untruncated float64 factors
    lam_host: "np.ndarray | None" = None


def kinship_eigen(K, decomp_scheme: str = "eigen") -> Tuple[np.ndarray, np.ndarray]:
    """Host float64 decomposition of the kinship matrix: ``(Ut, lam)`` with
    the eigenvectors as rows of ``Ut``. Warns on eigenvalues below -1e-7,
    like the reference (src/transform_helpers.jl:27-30)."""
    K64 = to_numpy(K, np.float64)
    if decomp_scheme == "eigen":
        lam, U = np.linalg.eigh(K64)
        Ut = U.T
    elif decomp_scheme == "svd":
        _, lam, Vt = np.linalg.svd(K64)
        Ut = Vt
    else:
        raise ValueError("decomp_scheme must be 'eigen' or 'svd'")
    if np.any(lam < -1e-7):
        warnings.warn(
            "Negative eigenvalues exist. The kinship matrix supplied may not be SPD."
        )
    return Ut, lam


def decomposition_from_numpy(Ut, lam, *, device, dtype) -> KinshipDecomposition:
    """A :class:`KinshipDecomposition` from host float64 factors, such as the
    JAX package's ``KinshipDecomposition.Ut_host`` / ``.lam_host``."""
    Ut_h = np.asarray(Ut, dtype=np.float64)
    lam_h = np.asarray(lam, dtype=np.float64)
    return KinshipDecomposition(
        Ut=torch.as_tensor(Ut_h, dtype=dtype, device=device),
        lam=torch.as_tensor(lam_h, dtype=dtype, device=device),
        Ut_host=Ut_h,
        lam_host=lam_h,
    )


def decompose_kinship(
    K, decomp_scheme: str = "eigen", dtype=None, *, device=None
) -> KinshipDecomposition:
    """Host eigendecomposition -> factors on ``device``, computed once.
    ``device`` defaults to ``K``'s when it is a tensor, else the current CUDA
    device (``utils/device.py::resolve_device``; ``device="cpu"`` for the
    CPU)."""
    device = resolve_device(device, K)
    Ut, lam = kinship_eigen(K, decomp_scheme)
    if dtype is None:
        dtype = DEFAULT_PRECISION.resolve_solve()
    return decomposition_from_numpy(Ut, lam, device=device, dtype=dtype)


def resolve_kinship(K, decomp_scheme: str, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Ut, lam) on ``device`` from a raw kinship matrix or a cached
    :class:`KinshipDecomposition`."""
    if isinstance(K, KinshipDecomposition):
        return K.Ut.to(device=device, dtype=dtype), K.lam.to(device=device, dtype=dtype)
    return resolve_kinship_with_host(K, decomp_scheme, dtype, device)[:2]


def host_factors(dec: KinshipDecomposition) -> Tuple[np.ndarray, np.ndarray]:
    """A decomposition's host float64 ``(Ut, lam)``: the untruncated LAPACK
    factors where it keeps them, else its device factors fetched."""
    Ut_h = dec.Ut_host if dec.Ut_host is not None else to_numpy(dec.Ut, np.float64)
    lam_h = dec.lam_host if dec.lam_host is not None else to_numpy(dec.lam, np.float64)
    return Ut_h, lam_h


def resolve_kinship_with_host(K, decomp_scheme: str, dtype, device):
    """``(Ut, lam, Ut_host, lam_host)``: :func:`resolve_kinship`'s device
    factors and the host float64 pair that feeds the host null fit
    (``ops/hostfit.py``). A decomposition without host factors has its
    device factors fetched once, here, before any product is queued."""
    if isinstance(K, KinshipDecomposition):
        Ut, lam = resolve_kinship(K, decomp_scheme, dtype, device)
        return (Ut, lam) + host_factors(K)
    Ut_h, lam_h = kinship_eigen(K, decomp_scheme)
    return (
        to_device(Ut_h, device, dtype),
        to_device(lam_h, device, dtype),
        Ut_h,
        lam_h,
    )


@with_highest_matmul()
def transform_rotation(
    y,
    g,
    K,
    *,
    add_intercept: bool = True,
    decomp_scheme: str = "eigen",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    device=None,
) -> RotatedData:
    """Rotate traits and design into the kinship eigenbasis.

    ``y``: (n,) or (n, m) traits; ``g``: (n, p) design (covariates already
    prepended, or just markers when ``add_intercept=True``). ``device``
    defaults to the first tensor's among ``y``, ``g`` and ``K``, else the
    current CUDA device (``utils/device.py::resolve_device``;
    ``device="cpu"`` for the CPU).
    """
    device = resolve_device(device, y, g, K)
    dtype = precision.resolve_solve()
    y = torch.as_tensor(y, device=device).to(dtype)
    y2 = y[:, None] if y.ndim == 1 else y
    g = torch.as_tensor(g, device=device).to(dtype)
    n = y2.shape[0]
    K_n = K.Ut.shape[0] if isinstance(K, KinshipDecomposition) else np.shape(K)[0]
    if g.shape[0] != n or K_n != n:
        raise ValueError("Dimension mismatch.")
    X = torch.cat([torch.ones((n, 1), dtype=dtype, device=device), g], 1) if add_intercept else g
    Ut, lam = resolve_kinship(K, decomp_scheme, dtype, device)
    return RotatedData(y0=Ut @ y2, X0=Ut @ X, lam=lam)


class ReweightedData(NamedTuple):
    r0: torch.Tensor  # (n, 1) weighted null residuals
    X00: torch.Tensor  # (n, p) weighted markers with the covariates projected out
    sigma2_e: torch.Tensor
    h2_null: torch.Tensor


@with_highest_matmul()
def transform_reweight(
    y0,
    X0,
    lam,
    *,
    n_covars: int = 1,
    prior_a: float = 0.0,
    prior_b: float = 0.0,
    reml: bool = False,
    method: str = "qr",
    optim_interval: int = 1,
) -> ReweightedData:
    """Null-model fit -> residualize -> sqrt-weight -> project out the
    covariates (reference transform_reweight, src/transform_helpers.jl:57-92).

    ``y0`` (n,) or (n, 1) and ``X0`` (n, n_covars + p) are rotated tensors,
    the covariates first; the null h2 comes from the device Brent
    (``ops/lmm.py::fit_lmm``).
    """
    from .lmm import fit_lmm

    if y0.ndim == 2 and y0.shape[1] != 1:
        raise ValueError(
            "transform_reweight is single-trait (the null h2 fit applies "
            f"to one trait); got {y0.shape[1]} trait columns. Reweight one "
            "column at a time, or use bulkscan/bulkscan_perms."
        )
    y0 = y0[:, None] if y0.ndim == 1 else y0
    X0_cov = X0[:, :n_covars]
    vc = fit_lmm(
        y0, X0_cov, lam, (prior_a, prior_b),
        reml=reml, method=method, optim_interval=optim_interval,
    )
    r0 = y0 - X0_cov @ vc.b
    # abs guard: the reference's sqrt.(abs.(makeweights(...))) for slightly
    # negative kinship eigenvalues (src/bulkscan_helpers.jl:138)
    sqrtw = torch.sqrt(make_weights(vc.h2, lam).abs())
    w_X0 = X0 * sqrtw[:, None]
    X00 = resid(w_X0[:, n_covars:], w_X0[:, :n_covars], method=method)
    return ReweightedData(r0=r0 * sqrtw[:, None], X00=X00, sigma2_e=vc.sigma2, h2_null=vc.h2)


def transform_permute(
    r0, *, nperms: int = 1024, rndseed=0, original: bool = True, perm_idx=None
) -> torch.Tensor:
    """(n, nperms [+1]) shuffles of the weighted residual ``r0`` (n,) or
    (n, 1); column 0 is ``r0`` itself when ``original=True`` (reference
    transform_permute, src/transform_helpers.jl:94-102).

    The shuffles are :func:`~bulklmm_tpu_torch.ops.stats.shuffle_vector`'s
    under ``rndseed``: deterministic, but not the JAX package's threefry
    stream, so parity with it under a seed alone is distributional.
    ``perm_idx`` ((K, n) integers, each row a permutation, the identity
    first when ``original``) gives the shuffles instead, such as the JAX
    package's ``ops.bulkperm.permutation_indices(n, nperms, rndseed)``.
    """
    col = r0[:, 0] if r0.ndim == 2 else r0
    if perm_idx is not None:
        idx = check_permutation_indices(perm_idx, col.shape[0], nperms, original=original)
        return col[idx.to(col.device)].T
    return shuffle_vector(rndseed, col, nperms, original=original)
