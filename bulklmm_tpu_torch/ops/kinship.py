"""Kinship (genetic-relatedness) matrix from genotype probabilities.

Counterpart of ``bulklmm_tpu/ops/kinship.py::calc_kinship`` (reference
``calcKinship``, src/kinship.jl:4-13):

    X = G - 0.5;  K = 2 * (X X^T) / p + 0.5;  diag(K) = 1
"""

from __future__ import annotations

import torch

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import resolve_device


@with_highest_matmul()
def calc_kinship(
    geno,
    precision: PrecisionConfig = DEFAULT_PRECISION,
    *,
    marker_chunk: int = 0,
    device=None,
) -> torch.Tensor:
    """(n, n) kinship from an (n, p) genotype-probability matrix.

    ``marker_chunk`` > 0 accumulates the cross-product over marker blocks of
    that width, so the shifted panel never exists whole; 0 is one product.
    ``device`` defaults to ``geno``'s when it is a tensor, else the current
    CUDA device (``utils/device.py::resolve_device``; ``device="cpu"`` for
    the CPU).
    """
    dtype = precision.resolve_solve()
    X = torch.as_tensor(geno, device=resolve_device(device, geno)).to(dtype)
    p = X.shape[1]
    if marker_chunk and marker_chunk < p:
        XXt = torch.zeros((X.shape[0], X.shape[0]), dtype=dtype, device=X.device)
        for s in range(0, p, marker_chunk):
            blk = X[:, s : s + marker_chunk] - 0.5
            XXt += blk @ blk.T
    else:
        X = X - 0.5
        XXt = X @ X.T
    K = 2.0 * XXt / p + 0.5
    K.fill_diagonal_(1.0)
    return K
