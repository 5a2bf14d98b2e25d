from .config import (
    BALANCED,
    DEFAULT_PRECISION,
    EXACT64,
    FAST32,
    MIXED,
    THROUGHPUT,
    PrecisionConfig,
    default_float,
    precision_by_name,
    with_highest_matmul,
)

__all__ = [
    "BALANCED",
    "DEFAULT_PRECISION",
    "EXACT64",
    "FAST32",
    "MIXED",
    "THROUGHPUT",
    "PrecisionConfig",
    "default_float",
    "precision_by_name",
    "with_highest_matmul",
]
