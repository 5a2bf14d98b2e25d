"""Wall-clock timing of a call.

Counterpart of ``bulklmm_tpu/utils/profiling.py::timed``. Its ``trace``
(a ``jax.profiler`` capture) has no counterpart here: ``profile_paths.py``
traces the port's paths with ``torch.profiler``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Tuple

import torch


def _cuda_devices(x, found=None) -> set:
    """The CUDA devices of the tensors in ``x``: a tensor, a sequence, a
    mapping, or a result object whose fields hold them."""
    found = set() if found is None else found
    if torch.is_tensor(x):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), found)
    return found


def _finish(result) -> None:
    """Wait until the devices of the result's CUDA tensors are done: the
    kernels are asynchronous, so a clock read without this measures their
    enqueue."""
    for device in _cuda_devices(result):
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, repeats: int = 3, warmup: int = 1, **kwargs) -> Tuple[float, object]:
    """(best_seconds, last_result) of ``fn(*args, **kwargs)``: ``warmup``
    calls, then the least of ``repeats`` timed calls, each on the host clock
    and each ending when the result's CUDA devices are done (one-time costs,
    the kernels' build among them, land in the warm-up)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        _finish(result)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _finish(result)
        best = min(best, time.perf_counter() - t0)
    return best, result
