"""bulklmm_tpu_torch: the PyTorch / CUDA port of ``bulklmm_tpu``.

A second package beside the JAX one, held against it test by test. It
imports torch, numpy and scipy, never JAX. ``bulkscan`` runs its three
methods end to end: null-grid and null-exact, whose per-trait LOD step is a
hand-written CUDA kernel (``csrc/liteqtl_fused.cu``) on CUDA tensors, and
alt-grid, whose scan over the h2 grid is another
(``csrc/altgrid_fused.cu``). ``bulkscan_perms`` gives every trait's
genome-wide permutation maxima through a third (``csrc/bulkperm_fused.cu``),
and ``get_thresholds_bulk`` their family-wise thresholds. The single-trait
``scan`` (null and alt assumptions, permutations, effects, the profile
likelihood) and ``scan_perms_lite`` run on plain torch products, as they do
in the JAX package. A ``LowRankKinship`` (top-k eigenpairs from
``kinship_lowrank``, ``kinship_lowrank_from_geno`` or
``kinship_lowrank_exact``) runs every one of these entry points on the
rank-k engine, with no (n, n) array, on plain products as in the JAX
package. Inputs and outputs keep the JAX package's layouts: Y (n, m),
G (n, p), L (p, m).

Entry points run on the current CUDA device when their inputs are numpy
arrays and on a tensor input's device otherwise; ``device="cpu"`` asks for
the CPU, where every kernel's plain PyTorch version runs instead.
"""

from .analysis import (
    ProfileLL,
    Thresholds,
    bh_adjust,
    getLL,
    get_thresholds,
    get_thresholds_bulk,
    lod_fdr,
    profile_LL,
)
from .models import (
    BulkPermResult,
    BulkScanResult,
    ScanResult,
    bulkscan,
    bulkscan_alt_grid,
    bulkscan_null,
    bulkscan_null_grid,
    bulkscan_perms,
    bulkscan_perms_streamed,
    bulkscan_streamed,
    scan,
    scan_perms_lite,
)
from .ops import (
    KinshipDecomposition,
    LowRankKinship,
    calc_kinship,
    decompose_kinship,
    decomposition_from_numpy,
    fit_lmm,
    gridbrent,
    kinship_lowrank,
    kinship_lowrank_exact,
    kinship_lowrank_from_geno,
    lod2log10p,
    lod2p,
    make_weights,
    p2lod,
    r2lod,
    resid,
    rss,
    transform_permute,
    transform_reweight,
    transform_rotation,
    wls_multivar,
)
from .ops.wls import wls
from .utils.config import (
    BALANCED,
    DEFAULT_PRECISION,
    EXACT64,
    FAST32,
    MIXED,
    THROUGHPUT,
    PrecisionConfig,
    enable_x64,
    precision_by_name,
)

__version__ = "0.1.0"

__all__ = [
    "BALANCED",
    "BulkPermResult",
    "BulkScanResult",
    "DEFAULT_PRECISION",
    "EXACT64",
    "FAST32",
    "KinshipDecomposition",
    "LowRankKinship",
    "MIXED",
    "PrecisionConfig",
    "ProfileLL",
    "ScanResult",
    "THROUGHPUT",
    "Thresholds",
    "__version__",
    "bh_adjust",
    "bulkscan",
    "bulkscan_alt_grid",
    "bulkscan_null",
    "bulkscan_null_grid",
    "bulkscan_perms",
    "bulkscan_perms_streamed",
    "bulkscan_streamed",
    "calc_kinship",
    "decompose_kinship",
    "decomposition_from_numpy",
    "enable_x64",
    "fit_lmm",
    "getLL",
    "get_thresholds",
    "get_thresholds_bulk",
    "gridbrent",
    "kinship_lowrank",
    "kinship_lowrank_exact",
    "kinship_lowrank_from_geno",
    "lod2log10p",
    "lod2p",
    "lod_fdr",
    "make_weights",
    "p2lod",
    "precision_by_name",
    "profile_LL",
    "r2lod",
    "resid",
    "rss",
    "scan",
    "scan_perms_lite",
    "transform_permute",
    "transform_reweight",
    "transform_rotation",
    "wls",
    "wls_multivar",
]
