"""Kinship (genetic-relatedness) matrix from genotype probabilities.

Counterpart of ``bulklmm_tpu/ops/kinship.py`` (reference ``calcKinship``,
src/kinship.jl:4-13):

    X = G - 0.5;  K = 2 * (X X^T) / p + 0.5;  diag(K) = 1

:func:`calc_kinship_sharded` forms it from marker shards held by the
processes of a ``torch.distributed`` group.
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


@with_highest_matmul()
def calc_kinship_sharded(
    geno_shard, group=None, precision: PrecisionConfig = DEFAULT_PRECISION, *, device=None
) -> torch.Tensor:
    """Kinship from marker shards spread over the processes of a
    ``torch.distributed`` process group (``group``; None: the default group).

    ``geno_shard`` is this process's (n, p_local) block of markers; the
    cross-product and the marker count are summed over the group
    (``all_reduce``, the counterpart of the JAX package's ``psum`` over a
    mesh axis), so every process ends with the same full (n, n) kinship.
    ``device`` as for :func:`calc_kinship`.

    IMPORTANT: shards must contain REAL marker columns only. Zero-padding a
    shard would be silently wrong here: the ``- 0.5`` shift turns padded
    zeros into -0.5 columns that contribute 0.25 to every cross-product
    entry, and the summed marker count would include them. Pad-then-scan
    callers should drop pad columns before calling (or use
    :func:`calc_kinship` with ``marker_chunk``, which pads *after* the
    shift).
    """
    import torch.distributed as dist

    dtype = precision.resolve_solve()
    X = torch.as_tensor(geno_shard, device=resolve_device(device, geno_shard)).to(dtype) - 0.5
    XXt = X @ X.T
    count = torch.tensor([float(X.shape[1])], dtype=dtype, device=X.device)
    dist.all_reduce(XXt, group=group)
    dist.all_reduce(count, group=group)
    K = 2.0 * XXt / count + 0.5
    K.fill_diagonal_(1.0)
    return K
