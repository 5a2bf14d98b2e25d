"""Host copies for the parts that run in numpy / scipy / LAPACK."""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x, dtype=None) -> np.ndarray:
    """``x`` (a tensor on any device, or anything numpy takes) as a host array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)
