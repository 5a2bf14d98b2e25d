"""FaST-LMM decorrelation: kinship eigendecomposition and rotation.

Counterpart of the rotation half of ``bulklmm_tpu/ops/rotation.py``
(reference src/transform_helpers.jl:1-55). The O(n^3) symmetric
eigendecomposition runs on the host in float64 LAPACK, so on the same K
its factors are those of the JAX package exactly; the O(n^2 (p + c + m))
rotation products run on the tensors' device. ``transform_reweight`` and
``transform_permute`` belong to the single-trait engines and wait.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import resolve_device
from ..utils.host import to_numpy


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
    Ut, lam = kinship_eigen(K, decomp_scheme)
    return (
        torch.as_tensor(Ut, dtype=dtype, device=device),
        torch.as_tensor(lam, dtype=dtype, device=device),
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
