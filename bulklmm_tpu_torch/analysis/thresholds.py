"""Permutation-based family-wise-error LOD thresholds.

Counterpart of ``bulklmm_tpu/analysis/thresholds.py`` (reference
``get_thresholds``, src/analysis_helpers/single_trait_analysis.jl:13-23):
per-permutation max LOD across markers, thresholds = quantiles of the
maxima at 1 - alpha.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils.host import to_numpy

#: rows of maxima per ``torch.quantile`` call, which refuses inputs above
#: 16 million elements (35,554 traits x 1,000 permutations is 35.6 million)
_ROWS_PER_CALL = 4096


class Thresholds(NamedTuple):
    probs: np.ndarray
    thrs: np.ndarray


def get_thresholds(L, signif_level: Sequence[float]) -> Thresholds:
    """Thresholds from a (p, nperms) permutation LOD matrix.

    ``signif_level``: right-tail significance levels (e.g. [0.10, 0.05]).
    Quantiles are Julia's ``quantile`` (linear interpolation, type 7),
    numpy's default.
    """
    L = L.max(0).values if torch.is_tensor(L) else np.asarray(L).max(axis=0)
    probs = 1.0 - np.asarray(signif_level, dtype=np.float64)
    return Thresholds(probs=probs, thrs=np.quantile(to_numpy(L), probs))


def get_thresholds_bulk(perm_maxima, signif_level: Sequence[float]) -> Thresholds:
    """Per-trait thresholds from (m, nperms) genome-wide permutation maxima
    (:attr:`bulklmm_tpu_torch.BulkPermResult.perm_maxima`: the per-marker
    max is already taken). ``thrs`` has shape (len(signif_level), m), row l
    the level-l threshold of every trait, by the same type-7 quantiles as
    :func:`get_thresholds`.

    The quantiles are taken where ``perm_maxima`` lies (``torch.quantile``,
    "linear", along axis 1, a few thousand traits per call); only the
    (levels, m) matrix is fetched.
    """
    peaks = torch.as_tensor(perm_maxima)
    probs = 1.0 - np.asarray(signif_level, dtype=np.float64)
    q = torch.as_tensor(probs, dtype=peaks.dtype, device=peaks.device)
    step = max(1, min(_ROWS_PER_CALL, 2**23 // max(1, peaks.shape[1])))
    thrs = torch.cat(
        [torch.quantile(peaks[s : s + step], q, dim=1) for s in range(0, peaks.shape[0], step)],
        dim=1,
    )
    return Thresholds(probs=probs, thrs=to_numpy(thrs, np.float64))
