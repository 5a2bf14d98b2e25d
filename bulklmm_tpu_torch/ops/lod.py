"""LOD-score conversions.

Counterpart of ``bulklmm_tpu/ops/lod.py``:

- ``r2lod``: correlation -> LOD (reference src/bulkscan_helpers.jl:22-24),
  and ``rss2lod``: residual sums of squares -> LOD, tensor ops on any
  device.
- ``p2lod`` / ``lod2p`` / ``lod2log10p``: chi-square LRT <-> p-value
  conversions (reference src/util.jl:181-206) on the host with scipy, for
  full tail accuracy. They take numpy arrays or tensors; a tensor comes back
  as a float64 tensor on its own device, anything else as numpy.
  ``lod2log10p_device`` is -log10 p as a tensor op on the LOD's own device
  and in its dtype.
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


def rss2lod(rss1, rss0, n):
    """LOD from null/alt residual sums of squares: (n/2) log10(rss0/rss1),
    the reference's per-marker formula ``(-n/2)(log10 rss1 - log10 rss0)``
    (src/scan.jl:449)."""
    rss1, rss0 = torch.as_tensor(rss1), torch.as_tensor(rss0)
    return (n / 2.0) * (torch.log10(rss0) - torch.log10(rss1))


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


def lod2log10p_device(lod, df: int):
    """LOD -> -log10(p) on the LOD's device, in its dtype: the chi-square
    survival function as the regularized upper incomplete gamma function
    (``torch.special.gammaincc``), floored at the dtype's smallest normal
    number. Accurate for moderate LODs; where p underflows the dtype, the
    host :func:`lod2log10p` keeps the tail."""
    lod = torch.as_tensor(lod)
    lrs = lod * (2.0 * _LN10)
    sf = torch.special.gammaincc(torch.full_like(lrs, df / 2.0), lrs / 2.0)
    sf = torch.clamp(sf, min=torch.finfo(sf.dtype).tiny)
    return -torch.log10(sf)
