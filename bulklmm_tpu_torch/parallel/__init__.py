"""Multi-GPU scaling: device meshes and the sharded scan engines.

Counterpart of ``bulklmm_tpu/parallel``. BulkLMM.jl parallelizes with Julia
threads and BLAS thread pools on one host (reference src/bulkscan.jl:252,
268) and defers multi-machine runs to future work (reference
README.md:66-72). Here the same axes (traits, markers, permutations) are the
axes of a grid of devices (``sharding.py``), and a pod of processes joined by
``torch.distributed`` runs one trait block each (``distributed.py``). The
JAX package's ``train_step_sharded``, an alias for its dry-run entry script, has
no counterpart.
"""

from .distributed import (
    bulkscan_distributed,
    bulkscan_perms_distributed,
    init_distributed,
    local_trait_slice,
    make_global_mesh,
    merge_perm_shards,
    merge_shards,
)
from .sharding import (
    Mesh,
    bulkscan_perms_sharded,
    bulkscan_sharded,
    make_mesh,
    scan_perms_sharded,
    shard_rotated,
)

__all__ = [
    "Mesh",
    "bulkscan_distributed",
    "bulkscan_perms_distributed",
    "bulkscan_perms_sharded",
    "bulkscan_sharded",
    "init_distributed",
    "local_trait_slice",
    "make_global_mesh",
    "make_mesh",
    "merge_perm_shards",
    "merge_shards",
    "scan_perms_sharded",
    "shard_rotated",
]
