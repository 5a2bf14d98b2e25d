"""LOD-score conversions.

Counterpart of ``bulklmm_tpu/ops/lod.py``:

- ``r2lod``: correlation -> LOD (reference src/bulkscan_helpers.jl:22-24),
  a tensor op on any device.
- ``p2lod`` / ``lod2p`` / ``lod2log10p``: chi-square LRT <-> p-value
  conversions (reference src/util.jl:181-206) on the host with scipy, for
  full tail accuracy. They take numpy arrays or tensors; a tensor comes back
  as a float64 tensor on its own device, anything else as numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.host import to_numpy

_LN10 = math.log(10.0)


def r2lod(r: torch.Tensor, n, *, fast_log: bool = False) -> torch.Tensor:
    """LOD = -(n/2) * log10(1 - r^2).

    ``1 - r^2`` is floored at the dtype's smallest normal number, so a
    near-collinear marker whose computed |r| rounds past 1 gets a huge
    finite LOD and not a NaN. ``fast_log`` forms ``1 - r^2`` in ``r``'s
    dtype, floors it at float32's smallest normal, and takes the log in
    float32.
    """
    one_minus_r2 = 1.0 - r * r
    if fast_log:
        f32 = torch.float32
        one_minus_r2 = torch.clamp(one_minus_r2, min=torch.finfo(f32).tiny)
        return -(n / 2.0) * torch.log10(one_minus_r2.to(f32))
    one_minus_r2 = torch.clamp(one_minus_r2, min=torch.finfo(one_minus_r2.dtype).tiny)
    return -(n / 2.0) * torch.log10(one_minus_r2)


def _like(out, ref):
    out = np.asarray(out, dtype=np.float64)
    if torch.is_tensor(ref):
        return torch.from_numpy(out).to(ref.device)
    return out


def p2lod(pval, df: int):
    """p-value -> LOD: inverse chi-square survival function, over 2 ln10."""
    from scipy.stats import chi2

    return _like(chi2.isf(to_numpy(pval), df) / (2.0 * _LN10), pval)


def lod2p(lod, df: int):
    """LOD -> p-value: chi-square survival function of LOD * 2 ln10."""
    from scipy.stats import chi2

    return _like(chi2.sf(to_numpy(lod) * 2.0 * _LN10, df), lod)


def lod2log10p(lod, df: int):
    """LOD -> -log10(p-value), accurate deep into the tail."""
    from scipy.stats import chi2

    return _like(-chi2.logsf(to_numpy(lod) * 2.0 * _LN10, df) / _LN10, lod)
