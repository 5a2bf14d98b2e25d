from .bulkperm import BulkPermResult, bulkscan_perms
from .bulkscan import bulkscan, bulkscan_alt_grid, bulkscan_null, bulkscan_null_grid
from .results import BulkScanResult

__all__ = [
    "BulkPermResult",
    "BulkScanResult",
    "bulkscan",
    "bulkscan_alt_grid",
    "bulkscan_null",
    "bulkscan_null_grid",
    "bulkscan_perms",
]
