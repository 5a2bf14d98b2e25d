"""Numerical primitives on torch tensors."""

from .brent import brent_min, gridbrent
from .bulkperm import (
    max_r2_perms_plain,
    maxr2_to_lod,
    perm_state_from_numpy,
    perm_trait_marker_parts,
    perm_trait_parts,
    permutation_indices,
)
from .hostfit import HostFit, fit_lmm_host, fit_lmm_host_lowrank
from .kinship import calc_kinship, calc_kinship_sharded
from .liteqtl import (
    lods_per_trait,
    lods_shared,
    weighted_correlation_per_trait,
    weighted_correlation_shared,
)
from .lmm import LMMResult, fit_h2_markers, fit_h2_traits, fit_lmm, fit_lmm_traits
from .lod import lod2log10p, lod2p, p2lod, r2lod
from .lowrank import (
    LowRankKinship,
    as_lowrank,
    kinship_lowrank,
    kinship_lowrank_exact,
    kinship_lowrank_from_geno,
)
from .rotation import (
    KinshipDecomposition,
    ReweightedData,
    RotatedData,
    decompose_kinship,
    decomposition_from_numpy,
    kinship_eigen,
    resolve_kinship,
    resolve_kinship_with_host,
    transform_permute,
    transform_reweight,
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
from .stats import (
    check_covar_full_rank,
    col_center,
    col_divide,
    col_standardize,
    row_center,
    row_divide,
    row_multiply,
    shuffle_vector,
)
from .weights import make_weights
# ``wls`` the function stays in ``ops.wls``: the name here is the module
from .wls import WLSResult, resid, rss, wls_ell, wls_ell_columns, wls_ell_markers, wls_multivar

__all__ = [
    "HostFit",
    "KinshipDecomposition",
    "LMMResult",
    "LowRankKinship",
    "ReweightedData",
    "RotatedData",
    "WLSResult",
    "as_lowrank",
    "brent_min",
    "calc_kinship",
    "calc_kinship_sharded",
    "cancel_keep_mask",
    "check_covar_full_rank",
    "col_center",
    "col_divide",
    "col_standardize",
    "decompose_kinship",
    "decomposition_from_numpy",
    "fit_h2_markers",
    "fit_h2_traits",
    "fit_lmm",
    "fit_lmm_host",
    "fit_lmm_host_lowrank",
    "fit_lmm_traits",
    "fwd_subst",
    "gridbrent",
    "kinship_eigen",
    "kinship_lowrank",
    "kinship_lowrank_exact",
    "kinship_lowrank_from_geno",
    "lod2log10p",
    "lod2p",
    "lods_per_trait",
    "lods_shared",
    "make_weights",
    "max_r2_perms_plain",
    "maxr2_to_lod",
    "p2lod",
    "pair_indices",
    "perm_state_from_numpy",
    "perm_trait_marker_parts",
    "perm_trait_parts",
    "permutation_indices",
    "r2lod",
    "resid",
    "residual_keep_mask",
    "residual_sq",
    "resolve_kinship",
    "resolve_kinship_with_host",
    "row_center",
    "row_divide",
    "row_multiply",
    "rss",
    "shuffle_vector",
    "transform_permute",
    "transform_reweight",
    "transform_rotation",
    "unrolled_cholesky",
    "weighted_correlation_per_trait",
    "weighted_correlation_shared",
    "wls_ell",
    "wls_ell_columns",
    "wls_ell_markers",
    "wls_multivar",
]
