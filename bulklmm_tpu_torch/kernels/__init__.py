"""Hand-written CUDA kernels (sources in ``csrc/``), each with its plain
PyTorch version. Importing this package builds nothing."""

from .altgrid_fused import (
    altgrid_cuda,
    altgrid_plain,
    fused_alt_grid,
    fused_alt_grid_reference,
)
from .bulkperm_fused import (
    bulkperm_maxr2_cuda,
    bulkperm_maxr2_plain,
    fused_perm_maxlods,
    fused_perm_maxlods_reference,
)
from .liteqtl_fused import (
    fused_lods_per_trait,
    fused_lods_per_trait_reference,
    liteqtl_lod_cuda,
    liteqtl_lod_plain,
)

__all__ = [
    "altgrid_cuda",
    "altgrid_plain",
    "bulkperm_maxr2_cuda",
    "bulkperm_maxr2_plain",
    "fused_alt_grid",
    "fused_alt_grid_reference",
    "fused_lods_per_trait",
    "fused_lods_per_trait_reference",
    "fused_perm_maxlods",
    "fused_perm_maxlods_reference",
    "liteqtl_lod_cuda",
    "liteqtl_lod_plain",
]
