"""bulklmm_tpu_torch: the PyTorch / CUDA port of ``bulklmm_tpu``.

A second package beside the JAX one, held against it test by test. It
imports torch, numpy and scipy, never JAX. ``bulkscan`` runs its three
methods end to end: null-grid and null-exact, whose per-trait LOD step is a
hand-written CUDA kernel (``csrc/liteqtl_fused.cu``) on CUDA tensors, and
alt-grid, whose scan over the h2 grid is another
(``csrc/altgrid_fused.cu``). ``bulkscan_perms`` gives every trait's
genome-wide permutation maxima through a third (``csrc/bulkperm_fused.cu``),
and ``get_thresholds_bulk`` their family-wise thresholds. Inputs and outputs
keep the JAX package's layouts: Y (n, m), G (n, p), L (p, m).

Entry points run on the current CUDA device when their inputs are numpy
arrays and on a tensor input's device otherwise; ``device="cpu"`` asks for
the CPU, where every kernel's plain PyTorch version runs instead.
"""

from .analysis import Thresholds, get_thresholds, get_thresholds_bulk
from .models import (
    BulkPermResult,
    BulkScanResult,
    bulkscan,
    bulkscan_alt_grid,
    bulkscan_null,
    bulkscan_null_grid,
    bulkscan_perms,
)
from .ops import (
    KinshipDecomposition,
    calc_kinship,
    decompose_kinship,
    decomposition_from_numpy,
    lod2log10p,
    transform_rotation,
)
from .utils.config import (
    BALANCED,
    DEFAULT_PRECISION,
    EXACT64,
    FAST32,
    MIXED,
    THROUGHPUT,
    PrecisionConfig,
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
    "MIXED",
    "PrecisionConfig",
    "THROUGHPUT",
    "Thresholds",
    "bulkscan",
    "bulkscan_alt_grid",
    "bulkscan_null",
    "bulkscan_null_grid",
    "bulkscan_perms",
    "calc_kinship",
    "decompose_kinship",
    "decomposition_from_numpy",
    "get_thresholds",
    "get_thresholds_bulk",
    "lod2log10p",
    "precision_by_name",
    "transform_rotation",
]
