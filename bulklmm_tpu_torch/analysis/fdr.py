"""False-discovery-rate control (no reference counterpart).

Counterpart of ``bulklmm_tpu/analysis/fdr.py``, in numpy on the host: the
reference offers only family-wise thresholds from permutation maxima
(src/analysis_helpers/single_trait_analysis.jl:13-23); for eQTL-scale scans
Benjamini-Hochberg / Benjamini-Yekutieli adjustment over LOD matrices is the
standard complement.
"""

from __future__ import annotations

import numpy as np

from ..ops.lod import lod2p
from ..utils.host import to_numpy


def bh_adjust(pvals, *, dependent: bool = False) -> np.ndarray:
    """Benjamini-Hochberg (or Benjamini-Yekutieli if ``dependent``) adjusted
    p-values (q-values), in the input's shape."""
    p = to_numpy(pvals, np.float64)
    flat = p.ravel()
    # NaN p-values get NaN q-values and must not poison the rest: argsort
    # puts NaN last, and the minimum from the tail would spread it to all
    valid = ~np.isnan(flat)
    out = np.full_like(flat, np.nan)
    v = flat[valid]
    n = v.size
    if n:
        order = np.argsort(v)
        ranked = v[order]
        scale = n / np.arange(1, n + 1)
        if dependent:
            scale = scale * np.sum(1.0 / np.arange(1, n + 1))
        q = ranked * scale
        q = np.minimum.accumulate(q[::-1])[::-1]  # monotone from the largest p down
        qo = np.empty_like(v)
        qo[order] = np.clip(q, 0.0, 1.0)
        out[valid] = qo
    return out.reshape(p.shape)


def lod_fdr(L, df: int = 1, *, alpha: float = 0.05, dependent: bool = False):
    """(qvals, significant_mask) for a LOD array (a tensor on any device or
    anything numpy takes) through chi-square p-values and
    Benjamini-Hochberg; ``df`` is the LRT's degrees of freedom."""
    qv = bh_adjust(lod2p(to_numpy(L), df), dependent=dependent)
    return qv, qv <= alpha
