"""What the per-layer readers (``metrics/<metric>.py``) compute.

Each reader takes a :class:`Context` and returns a number, or None where
the traced window holds nothing for it to read (then the metric is left out
of the line). Nothing here returns 0 for a share of a roofline or a peak.
"""

from __future__ import annotations

import dataclasses

from . import spec
from .trace import Summary


@dataclasses.dataclass
class Context:
    summary: Summary
    call: dict  # the call's shape: n, p, m, c, g, columns
    kernel: str  # the cell's main kernel: the name of its flops/<kernel>.py
    peaks: dict | None  # core/peaks.py's entry of the card


def launches_per_call(ctx: Context):
    """Kernel launches a call, from the device's kernel records."""
    kernels = ctx.summary.kernels()
    return len(kernels) / ctx.summary.calls if kernels else None


def prep_device_ms(ctx: Context):
    """Milliseconds a call in which the device ran anything but the cell's
    main kernel (kernels, copies and fills; union of their intervals)."""
    counts = spec.kernel_counts(ctx.kernel)
    if not ctx.summary.kernels(counts.NAME_PREFIXES):
        return None
    return 1e3 * ctx.summary.busy_except(counts.NAME_PREFIXES) / ctx.summary.calls


def idle_pct(ctx: Context):
    """The share of the traced window in which no device record ran."""
    if not ctx.summary.device:
        return None
    return 100.0 * (1.0 - ctx.summary.busy_s / ctx.summary.window_s)


def least_seconds(counts, call: dict, launches: int, calls: int, peaks: dict) -> float:
    """The least time of ``launches`` launches over ``calls`` calls: per
    launch the larger of its flops over the peak rate and its bytes over the
    peak bandwidth."""
    shape = counts.launch_shape(call, launches / calls)
    per_launch = max(counts.flops(shape) / peaks["flops"],
                     counts.bytes(shape) / peaks["bytes_per_s"])
    return launches * per_launch


def roofline_pct(ctx: Context, kernel: str):
    """Kernel ``kernel``'s least time over its device time, in the traced
    calls; None where the cell does not run it or the card has no peaks."""
    if ctx.kernel != kernel or ctx.peaks is None:
        return None
    counts = spec.kernel_counts(kernel)
    records = ctx.summary.kernels(counts.NAME_PREFIXES)
    if not records:
        return None
    least = least_seconds(counts, ctx.call, len(records), ctx.summary.calls, ctx.peaks)
    return 100.0 * least / ctx.summary.kernel_seconds(counts.NAME_PREFIXES)


def call_flops(ctx: Context) -> float:
    """A call's flops: its main kernel's count and the rotation of the
    markers, traits and covariates, 2 n^2 (p + m + c)."""
    c = ctx.call
    counts = spec.kernel_counts(ctx.kernel)
    return counts.flops(c) + 2.0 * c["n"] ** 2 * (c["p"] + c["m"] + c["c"])


def mfu_pct(ctx: Context):
    """The calls' flops over the traced window at the card's peak rate."""
    if ctx.peaks is None or not ctx.summary.device:
        return None
    return (100.0 * ctx.summary.calls * call_flops(ctx)
            / (ctx.summary.window_s * ctx.peaks["flops"]))
