"""The program's own spans in a traced window, and the window's idle time
put down to the layers that held the card.

The program (``bulklmm_tpu_torch/utils/profiling.py::span``) names each span
``bulklmm.<layer>.<what>`` and opens it, while a profiler records, on the
thread that called it, so that its spans nest by time. Each span is a host
record of the window (:class:`trace.Summary`'s ``host``). An idle gap of the
device (``Summary.gaps``) belongs, at each instant, to the layer of the
innermost span covering it; a ``bulklmm.sync.*`` span (a point where the
host waits on the card or its driver) passes its idle time to its enclosing
span's layer. Idle time outside every program span is the harness's and no
layer's. A window without program spans (a program that has none) reads
None.
"""

from __future__ import annotations

import bisect
import itertools

from .trace import Summary

PREFIX = "bulklmm."
SYNC = "sync"


def layer(name: str) -> str:
    """The layer that a span's name gives: ``bulklmm.<layer>.<what>``."""
    return name.split(".")[1]


def program_spans(summary: Summary) -> list:
    """The program's span records of the window, outer before inner."""
    return sorted((r for r in summary.host if r.name.startswith(PREFIX)),
                  key=lambda r: (r.start, -r.end))


def _idle_between(gaps):
    """``f(a, b)``: the seconds of the sorted, disjoint ``gaps`` inside
    [a, b]."""
    starts = [s for s, _ in gaps]
    before = [0.0, *itertools.accumulate(e - s for s, e in gaps)]

    def until(t):
        k = bisect.bisect_right(starts, t)
        if k == 0:
            return 0.0
        s, e = gaps[k - 1]
        return before[k - 1] + min(t, e) - s

    return lambda a, b: max(0.0, until(b) - until(a))


def idle_by_layer(summary: Summary) -> dict | None:
    """Idle seconds of the window by layer (the innermost span's, a sync
    span's enclosing one's), or None where the window holds no program
    span."""
    spans = program_spans(summary)
    if not spans:
        return None
    idle = _idle_between(summary.gaps)
    owner = []  # the layer that each span's own idle time goes to
    out = {}
    stack = []  # indices of the open spans, innermost last
    for i, sp in enumerate(spans):
        while stack and spans[stack[-1]].end <= sp.start:
            stack.pop()
        parent = stack[-1] if stack else None
        own = layer(sp.name)
        owner.append(owner[parent] if own == SYNC and parent is not None
                     else None if own == SYNC else own)
        inside = idle(sp.start, sp.end)
        if owner[i] is not None:
            out[owner[i]] = out.get(owner[i], 0.0) + inside
        if parent is not None and owner[parent] is not None:
            # the parent's own time is its interval less its children's
            p = spans[parent]
            out[owner[parent]] -= idle(max(sp.start, p.start), min(sp.end, p.end))
        stack.append(i)
    return out


def idle_pct(summary: Summary, name: str):
    """The share of the window that is idle while layer ``name`` holds the
    card, in %."""
    by_layer = idle_by_layer(summary)
    if by_layer is None:
        return None
    return 100.0 * max(0.0, by_layer.get(name, 0.0)) / summary.window_s


def syncs_per_call(summary: Summary):
    """The program's ``bulklmm.sync.*`` spans in the window over its calls."""
    spans = program_spans(summary)
    if not spans:
        return None
    return sum(layer(r.name) == SYNC for r in spans) / summary.calls
