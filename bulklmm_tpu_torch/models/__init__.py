from .bulkscan import bulkscan, bulkscan_null_grid
from .results import BulkScanResult

__all__ = ["BulkScanResult", "bulkscan", "bulkscan_null_grid"]
