"""Host copies for the parts that run in numpy / scipy / LAPACK, and the
pinned-memory transfers of the engines that assemble results on the host."""

from __future__ import annotations

import numpy as np
import torch

from .profiling import span


def to_numpy(x, dtype=None) -> np.ndarray:
    """``x`` (a tensor on any device, or anything numpy takes) as a host
    array; a tensor's copy runs under a ``bulklmm.sync.download`` span (on a
    card it waits for the device)."""
    if torch.is_tensor(x):
        with span("bulklmm.sync.download"):
            x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``. Unless ``x`` is a
    tensor on ``device`` already, under a ``bulklmm.sync.upload`` span: on a
    card a copy from pageable host memory waits for the device's stream."""
    if torch.is_tensor(x) and x.device == torch.device(device):
        return torch.as_tensor(x, dtype=dtype, device=device)
    with span("bulklmm.sync.upload"):
        return torch.as_tensor(x, dtype=dtype, device=device)


class PinnedCopies:
    """Device tensors to host arrays without stalling the device.

    :meth:`start` enqueues non-blocking copies of a dict of tensors into
    pinned host buffers on the current stream and records a CUDA event;
    :meth:`wait` waits on that event and returns the buffers as numpy arrays.
    Two sets of buffers alternate, so the host can read one set while the
    next set fills; a set is written again two starts later, which must
    come after the earlier set's :meth:`wait` (the callers' pipelines read
    each set before they start the one after the next). A copy into pageable
    memory would be synchronous. CPU tensors pass through as they are.
    """

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self._sets = [{}, {}]
        self._next = 0

    def start(self, tensors: dict):
        if not self.cuda:
            return {k: to_numpy(t) for k, t in tensors.items()}, None
        bufs = self._sets[self._next]
        self._next ^= 1
        for k, t in tensors.items():
            buf = bufs.get(k)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = bufs[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return {k: bufs[k] for k in tensors}, event

    @staticmethod
    def wait(handle) -> dict:
        staged, event = handle
        if event is None:
            return staged
        event.synchronize()
        return {k: b.numpy() for k, b in staged.items()}
