"""Result containers of the single-trait and multi-trait scans.

Counterpart of ``bulklmm_tpu/models/results.py``; field names mirror the
reference's returned named tuples (src/scan.jl:162-193,
src/bulkscan.jl:62-84).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ScanResult:
    """Single-trait scan output (null or alt assumption); tensors on the
    scan's device, ``sigma2_e`` and ``h2_null`` 0-d."""

    sigma2_e: torch.Tensor
    h2_null: torch.Tensor
    lod: torch.Tensor  # (p,)
    h2_each_marker: Optional[torch.Tensor] = None  # (p,), alt only
    L_perms: Optional[torch.Tensor] = None  # (p, nperms), permutation test only
    beta: Optional[torch.Tensor] = None  # (p,) GLS marker effects, output_effects only
    beta_se: Optional[torch.Tensor] = None  # (p,) Wald standard errors
    log10pvals: Optional[torch.Tensor] = None  # (p,), float64
    log10Pvals_perms: Optional[torch.Tensor] = None  # (p, nperms), float64
    ll_list_null: Optional[torch.Tensor] = None  # profile-likelihood grid values
    ll_list_alt: Optional[torch.Tensor] = None
    h2_null_by_chrom: Optional[dict] = None  # LOCO scans: chrom -> h2
    sigma2_by_chrom: Optional[dict] = None  # LOCO scans: chrom -> sigma2_e


@dataclasses.dataclass
class BulkScanResult:
    """Multi-trait scan output: tensors on the scan's device, or host numpy
    arrays where the result was assembled on the host (host trait blocks,
    marker streaming)."""

    L: torch.Tensor  # (p, m) LOD matrix
    h2_null_list: Optional[torch.Tensor] = None  # (m,) null/grid methods
    h2_panel: Optional[torch.Tensor] = None  # (p, m) alt-grid argmax h2
    beta_mat: Optional[torch.Tensor] = None  # (p, m) GLS marker effects, output_effects only
    beta_se_mat: Optional[torch.Tensor] = None  # (p, m)
    log10Pvals_mat: Optional[torch.Tensor] = None  # (p, m), float64
    chisq_df: Optional[int] = None
    h2_null_by_chrom: Optional[dict] = None  # LOCO scans: chrom -> (m,) h2s, (p_c, m) alt-grid
