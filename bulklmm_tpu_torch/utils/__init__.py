from .config import (
    BALANCED,
    DEFAULT_PRECISION,
    EXACT64,
    FAST32,
    MIXED,
    THROUGHPUT,
    PrecisionConfig,
    default_float,
    enable_x64,
    precision_by_name,
    with_highest_matmul,
)
from .device import mesh_device, resolve_device
from .profiling import timed

__all__ = [
    "BALANCED",
    "DEFAULT_PRECISION",
    "EXACT64",
    "FAST32",
    "MIXED",
    "THROUGHPUT",
    "PrecisionConfig",
    "default_float",
    "enable_x64",
    "mesh_device",
    "precision_by_name",
    "resolve_device",
    "timed",
    "with_highest_matmul",
]
