"""bulklmm_tpu_torch: the PyTorch / CUDA port of ``bulklmm_tpu``.

A second package beside the JAX one, held against it test by test. It
imports torch, numpy and scipy, never JAX. ``bulkscan`` runs its three
methods end to end: null-grid and null-exact, whose per-trait LOD step is a
hand-written CUDA kernel (``csrc/liteqtl_fused.cu``) on CUDA tensors, and
alt-grid, whose scan over the h2 grid is another
(``csrc/altgrid_fused.cu``). Inputs and outputs keep the JAX package's
layouts: Y (n, m), G (n, p), L (p, m).
"""

from .models import (
    BulkScanResult,
    bulkscan,
    bulkscan_alt_grid,
    bulkscan_null,
    bulkscan_null_grid,
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
    "BulkScanResult",
    "DEFAULT_PRECISION",
    "EXACT64",
    "FAST32",
    "KinshipDecomposition",
    "MIXED",
    "PrecisionConfig",
    "THROUGHPUT",
    "bulkscan",
    "bulkscan_alt_grid",
    "bulkscan_null",
    "bulkscan_null_grid",
    "calc_kinship",
    "decompose_kinship",
    "decomposition_from_numpy",
    "lod2log10p",
    "precision_by_name",
    "transform_rotation",
]
