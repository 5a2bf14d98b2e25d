from .bulkperm import BulkPermResult, bulkscan_perms
from .bulkscan import (
    bulkscan, bulkscan_alt_grid, bulkscan_null, bulkscan_null_grid, grid_null_ell,
)
from .loco import bulkscan_loco, bulkscan_perms_loco, loco_kinship, scan_loco
from .results import BulkScanResult, ScanResult
from .scan import scan, scan_perms_lite
from .streaming import bulkscan_perms_streamed, bulkscan_streamed

__all__ = [
    "BulkPermResult",
    "BulkScanResult",
    "ScanResult",
    "bulkscan",
    "bulkscan_alt_grid",
    "bulkscan_loco",
    "bulkscan_null",
    "bulkscan_null_grid",
    "bulkscan_perms",
    "bulkscan_perms_loco",
    "bulkscan_perms_streamed",
    "bulkscan_streamed",
    "grid_null_ell",
    "loco_kinship",
    "scan",
    "scan_loco",
    "scan_perms_lite",
]
