"""Wall-clock timing of a call, the port's spans and its launch record.

Counterpart of ``bulklmm_tpu/utils/profiling.py::timed``. Its ``trace``
(a ``jax.profiler`` capture) has no counterpart: :func:`span` marks the
port's layer boundaries in any ``torch.profiler`` session instead.

:data:`launch_counts` records which hand-written kernel ran: each CUDA
wrapper counts a launch there, after it succeeds, under the route it
launched (:func:`count_launch`). It is always on and costs one locked
increment a launch; ``launch_counts.clear()`` starts it afresh.

Spans are on exactly while a ``torch.profiler`` session records; there is
no setting. Each is a host record named ``bulklmm.<layer>.<what>``, on the
profiler's clock, so a trace shows it above the kernels it launched. Off,
a span costs one check and returns a shared no-op.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import threading
import time
from typing import Callable, Tuple

import torch

#: what :func:`span` returns while no profiler records
_NO_SPAN = contextlib.nullcontext()

#: the process's calls of the spanned entry points, numbered from 1
_calls = itertools.count(1)

#: launches of the hand-written kernels in this process, by route:
#: "<kernel>.<path>.<products>", e.g. "liteqtl_lod.resident.tf32x3"
launch_counts: collections.Counter = collections.Counter()

#: the host threads of a mesh's devices launch at once
_launch_lock = threading.Lock()


def count_launch(kernel: str, path: str, products: str) -> None:
    """Count one launch of ``kernel`` on ``path`` with ``products`` in
    :data:`launch_counts`. The names are the wrappers' own: ``kernel`` is
    "liteqtl_lod", "liteqtl_lod_effects", "bulkperm_maxr2" or "altgrid";
    ``path`` the ``kernel_route`` path ("resident", "general", "wide";
    "resident", "chunked", or "chunked_split" where the marker walk was
    split across blocks; "fused" for the alt-grid kernel); ``products``
    "tf32x3" or "bf16x3"."""
    with _launch_lock:
        launch_counts[f"{kernel}.{path}.{products}"] += 1


def span(name: str, args: dict | None = None):
    """A context that records ``name`` as a ``torch.profiler`` span while a
    profiler session records, and the shared no-op otherwise. ``args``
    (names to ints or strings) go with the record: a trace taken with
    ``record_shapes=True`` shows them, under ``kwinputs`` of its events and
    beside the span in ``export_chrome_trace``.

    The record is a host record alone. ``torch.profiler.record_function``
    would also lay an annotation on the card's timeline over the kernels it
    encloses, which a reader of the device records can take for device work
    (PyTorch 2.11's events carry no activity type to tell them apart), and
    it drops ``args``."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name, (), args or {})


def spanned(name: str, *, numbered: bool = False):
    """Decorator: each call of the function runs inside ``span(name)``;
    ``numbered`` (the entry points) adds the process's call number as the
    span's ``call`` argument, so every span of a call lies inside one
    numbered span."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            call = next(_calls) if numbered else None
            with span(name, None if call is None else {"call": call}):
                return fn(*args, **kwargs)

        return inner

    return wrap


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
