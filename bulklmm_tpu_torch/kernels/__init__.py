"""Hand-written CUDA kernels (sources in ``csrc/``), each with its plain
PyTorch version. Importing this package builds nothing."""

from .liteqtl_fused import (
    fused_lods_per_trait,
    fused_lods_per_trait_reference,
    liteqtl_lod_cuda,
    liteqtl_lod_plain,
)

__all__ = [
    "fused_lods_per_trait",
    "fused_lods_per_trait_reference",
    "liteqtl_lod_cuda",
    "liteqtl_lod_plain",
]
