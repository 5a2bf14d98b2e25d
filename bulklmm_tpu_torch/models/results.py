"""Result container of the multi-trait scan.

Counterpart of ``bulklmm_tpu/models/results.py::BulkScanResult``; field
names mirror the reference's returned named tuples (src/bulkscan.jl:62-84).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class BulkScanResult:
    """Multi-trait scan output; tensors on the scan's device."""

    L: torch.Tensor  # (p, m) LOD matrix
    h2_null_list: Optional[torch.Tensor] = None  # (m,) null/grid methods
    h2_panel: Optional[torch.Tensor] = None  # (p, m) alt-grid argmax h2
    beta_mat: Optional[torch.Tensor] = None  # (p, m) effects (not ported yet)
    beta_se_mat: Optional[torch.Tensor] = None  # (p, m)
    log10Pvals_mat: Optional[torch.Tensor] = None  # (p, m), float64
    chisq_df: Optional[int] = None
