"""Numerical primitives on torch tensors."""

from .kinship import calc_kinship
from .liteqtl import lods_per_trait, weighted_correlation_per_trait
from .lod import lod2log10p, lod2p, p2lod, r2lod
from .rotation import (
    KinshipDecomposition,
    RotatedData,
    decompose_kinship,
    decomposition_from_numpy,
    kinship_eigen,
    resolve_kinship,
    transform_rotation,
)
from .smallchol import (
    cancel_keep_mask,
    fwd_subst,
    pair_indices,
    residual_keep_mask,
    residual_sq,
    unrolled_cholesky,
)
from .stats import check_covar_full_rank
from .weights import make_weights
from .wls import wls_ell

__all__ = [
    "KinshipDecomposition",
    "RotatedData",
    "calc_kinship",
    "cancel_keep_mask",
    "check_covar_full_rank",
    "decompose_kinship",
    "decomposition_from_numpy",
    "fwd_subst",
    "kinship_eigen",
    "lod2log10p",
    "lod2p",
    "lods_per_trait",
    "make_weights",
    "p2lod",
    "pair_indices",
    "r2lod",
    "residual_keep_mask",
    "residual_sq",
    "resolve_kinship",
    "transform_rotation",
    "unrolled_cholesky",
    "weighted_correlation_per_trait",
    "wls_ell",
]
