"""Variance-component weights for the rotated LMM.

Counterpart of ``bulklmm_tpu/ops/weights.py`` (reference ``makeweights``,
src/lmm.jl:15-33): observation i gets weight ``1 / (delta * lam_i + 1)``
with ``delta = h2 / (1 - h2)``, delta clipped to +/-1e18 so h2 = 1 stays
finite.
"""

from __future__ import annotations

import torch

_MAX_DELTA = 1e18


def make_weights(h2, lam: torch.Tensor) -> torch.Tensor:
    """Weights ``1 / (delta * lam + 1)``.

    ``h2`` is a scalar, giving shape ``(n,)``, or a tensor of any batch shape
    ``B``, giving ``B + (n,)``.
    """
    if not torch.is_tensor(h2):
        # a Python number keeps float64 until it meets lam, as in JAX
        h2 = torch.as_tensor(h2, dtype=torch.float64, device=lam.device)
    delta = (h2 / (1.0 - h2)).clamp(-_MAX_DELTA, _MAX_DELTA)
    if h2.ndim == 0:
        return 1.0 / (delta * lam + 1.0)
    return 1.0 / (delta[..., None] * lam + 1.0)
