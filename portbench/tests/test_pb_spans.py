"""The program's spans in a traced window (``core/spans.py``) on hand-built
records: the innermost span's layer takes an idle gap, a sync span passes
its idle time to its enclosing span's layer, idle time outside every span
goes to no layer, and a window without the program's spans reads None."""

from __future__ import annotations

import pytest

from portbench.core import readers, spans, spec, trace

R = trace.Record


def _summary(extra):
    """Two calls of 1 s; the device busy over [0.1, 0.3] and [1.2, 1.5],
    so idle over [0, 0.1], [0.3, 1.2] and [1.5, 2.0]."""
    return trace.summarize([
        R(trace.CALL, "host", 0.0, 1.0), R(trace.CALL, "host", 1.0, 2.0),
        R("liteqtl_general_wgmma_kernel<1>", "kernel", 0.1, 0.3),
        R("liteqtl_general_wgmma_kernel<1>", "kernel", 1.2, 1.5),
        R("aten::mm", "host", 0.35, 0.4),  # not the program's: never a layer
        *extra,
    ])


def _program():
    return [
        R("bulklmm.entry.bulkscan", "host", 0.0, 0.9),
        R("bulklmm.sync.mem_get_info", "host", 0.02, 0.05),  # in entry: entry's
        R("bulklmm.prep.rotate", "host", 0.3, 0.6),
        R("bulklmm.sync.upload", "host", 0.4, 0.5),  # in prep: prep's
        R("bulklmm.entry.chunk", "host", 0.6, 0.8),
        R("bulklmm.prep.inputs", "host", 0.65, 0.7),
        R("bulklmm.entry.bulkscan", "host", 1.0, 1.9),
        R("bulklmm.sync.scalar", "host", 1.6, 1.7),
    ]


def test_the_innermost_span_takes_the_idle_time():
    by_layer = spans.idle_by_layer(_summary(_program()))
    # entry: [0, 0.1] + [0.6, 0.65] + [0.7, 0.9] (the chunk and the call
    # around it), [1.0, 1.2] + [1.5, 1.9] (the sync inside it as well)
    assert by_layer["entry"] == pytest.approx(0.1 + 0.05 + 0.2 + 0.2 + 0.4)
    # prep: the rotation's [0.3, 0.6] with its sync, the operands' [0.65, 0.7]
    assert by_layer["prep"] == pytest.approx(0.3 + 0.05)
    assert set(by_layer) == {"entry", "prep"}


def test_idle_outside_the_program_spans_goes_to_no_layer():
    s = _summary(_program())
    idle = s.window_s - s.busy_s
    assert idle == pytest.approx(0.1 + 0.9 + 0.5)
    outside = idle - sum(spans.idle_by_layer(s).values())
    assert outside == pytest.approx(0.2)  # [0.9, 1.0] and [1.9, 2.0]
    ctx = readers.Context(summary=s, call={}, kernel="lod", peaks=None)
    entry = spec.metric_reader("entry_idle_pct.scan").read(ctx)
    prep = spec.metric_reader("prep_idle_pct.scan").read(ctx)
    assert entry == pytest.approx(100 * 0.95 / 2.0) and prep == pytest.approx(100 * 0.35 / 2.0)
    assert entry + prep <= readers.idle_pct(ctx) + 1e-9


def test_a_sync_span_passes_its_idle_time_to_its_parent():
    s = _summary([R("bulklmm.prep.null_fit", "host", 0.3, 1.0),
                  R("bulklmm.sync.scalar", "host", 0.5, 0.9)])
    assert spans.idle_by_layer(s) == {"prep": pytest.approx(0.7)}
    # a sync span with no program span around it belongs to no layer
    alone = _summary([R("bulklmm.sync.download", "host", 0.5, 0.9)])
    assert spans.idle_by_layer(alone) == {}
    assert spans.syncs_per_call(alone) == pytest.approx(0.5)


def test_syncs_are_counted_a_call():
    ctx = readers.Context(summary=_summary(_program()), call={}, kernel="perm", peaks=None)
    for kind in ("scan", "altgrid", "perm"):
        assert spec.metric_reader(f"syncs_per_call.{kind}").read(ctx) == pytest.approx(3 / 2)


@pytest.mark.parametrize("metric", ["entry_idle_pct", "prep_idle_pct", "syncs_per_call"])
@pytest.mark.parametrize("kind", ["scan", "altgrid", "perm"])
def test_a_window_without_program_spans_reads_none(metric, kind):
    ctx = readers.Context(summary=_summary([]), call={}, kernel="lod", peaks=None)
    assert spec.metric_reader(f"{metric}.{kind}").read(ctx) is None
