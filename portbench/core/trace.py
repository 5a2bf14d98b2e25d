"""From one ``torch.profiler`` window of whole calls to the numbers that the
per-layer readers take.

The window runs from the start of the first call's ``portbench.call``
annotation to the end of the last one's; each call ends in a scalar fetch,
so the device has finished its work by then. Device records are the
kernels, copies and fills that CUPTI saw on the card (the kernels of the
ctypes-loaded library among them). Busy time is the union of their
intervals, not their sum, so work that overlaps counts once; an idle gap is
a stretch of the window that no device record covers, named by the
innermost host operation running at its middle.

Each call ends in the harness's own checksum of its outputs, under a
``portbench.checksum`` annotation that starts once the device has finished
the call's work. A device record that starts inside such an annotation is
the harness's: it counts as busy time, and the program's layers (its
launches and its preparation) leave it out.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

CALL = "portbench.call"
CHECKSUM = "portbench.checksum"
_DEVICE_ACTIVITIES = {"kernel": "kernel", "concurrent_kernel": "kernel",
                      "gpu_memcpy": "copy", "gpu_memset": "copy"}


@dataclasses.dataclass(frozen=True)
class Record:
    name: str
    kind: str  # "kernel", "copy" (copies and fills) or "host"
    start: float  # seconds
    end: float
    harness: bool = False  # a device record of the harness's checksum


def _kind_of(event) -> str | None:
    """"kernel", "copy", "host", or None for a device-side annotation."""
    activity = None
    if hasattr(event, "activity_type"):
        activity = str(event.activity_type()).lower().split(".")[-1]
    device = str(event.device_type()).split(".")[-1]
    if activity in _DEVICE_ACTIVITIES:
        return _DEVICE_ACTIVITIES[activity]
    if device != "CUDA":
        return "host"
    if activity is not None and "annotation" in activity:
        return None
    name = event.name()
    if name.startswith("portbench."):
        return None
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


def records_from(prof) -> list[Record]:
    """Every host and device record of a finished ``torch.profiler``
    session, in seconds on one clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind_of(e)
        if kind is None:
            continue
        start = e.start_ns() * 1e-9
        out.append(Record(e.name(), kind, start, start + e.duration_ns() * 1e-9))
    return out


def function_name(name: str) -> str:
    """A device record's function name without its return type, namespaces
    and template or call arguments: ``void ns::k<T>(float*)`` is ``k``."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        head = head.split(stop, 1)[0]
    return head.rsplit("::", 1)[-1].strip()


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


@dataclasses.dataclass
class Summary:
    """One traced window: its calls, length, device records (clipped to
    the window), busy time and idle gaps."""

    calls: int
    start: float
    end: float
    device: list
    host: list
    busy_s: float
    gaps: list  # (start, end)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self, prefixes=None):
        """The program's kernel records, those whose function name
        (:func:`function_name`) starts with one of ``prefixes`` where given."""
        return [r for r in self.device if r.kind == "kernel" and not r.harness
                and (prefixes is None or function_name(r.name).startswith(tuple(prefixes)))]

    def kernel_seconds(self, prefixes) -> float:
        return sum(r.end - r.start for r in self.kernels(prefixes))

    def busy_except(self, prefixes) -> float:
        """Seconds in which a device record of the program other than the
        kernels named by ``prefixes`` ran (union)."""
        main = set(map(id, self.kernels(prefixes)))
        return covered((r.start, r.end) for r in self.device
                       if id(r) not in main and not r.harness)

    def device_ops(self, top: int = 10):
        """The device operations that took most time: ``[[name, seconds]]``;
        the harness's are named after its checksum."""
        total = defaultdict(float)
        for r in self.device:
            total[f"{CHECKSUM}: {r.name}" if r.harness else r.name] += r.end - r.start
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """Idle seconds by the innermost host operation running at each
        gap's middle: ``[[name, seconds]]``, the longest first."""
        host = sorted(self.host, key=lambda r: r.start)
        starts = [r.start for r in host]
        total = defaultdict(float)
        for s, e in self.gaps:
            mid = 0.5 * (s + e)
            name = "(no host operation)"
            i = bisect.bisect_right(starts, mid) - 1
            # nested operations: the latest start that still covers the
            # middle is the innermost; look back a bounded distance
            for j in range(i, max(i - 4096, -1), -1):
                if host[j].end >= mid:
                    name = host[j].name
                    break
            total[name] += e - s
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def summarize(records) -> Summary:
    """The window of the ``portbench.call`` annotations and what ran in it."""
    calls = [r for r in records if r.kind == "host" and r.name == CALL]
    if not calls:
        raise ValueError("the trace holds no call annotation")
    w0, w1 = min(r.start for r in calls), max(r.end for r in calls)
    sums = sorted((r.start, r.end) for r in records if r.kind == "host" and r.name == CHECKSUM)
    sum_starts = [s for s, _ in sums]

    def in_checksum(t):
        i = bisect.bisect_right(sum_starts, t) - 1
        return i >= 0 and t <= sums[i][1]

    device = [Record(r.name, r.kind, max(r.start, w0), min(r.end, w1), in_checksum(r.start))
              for r in records if r.kind != "host" and r.end > w0 and r.start < w1]
    host = [r for r in records if r.kind == "host" and r.name != CALL
            and r.end > w0 and r.start < w1]
    merged = union((r.start, r.end) for r in device)
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return Summary(calls=len(calls), start=w0, end=w1, device=device, host=host,
                   busy_s=sum(e - s for s, e in merged), gaps=gaps)
