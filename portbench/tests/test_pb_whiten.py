"""``whiten_idle_pct.scan`` on hand-built records: the idle time of the
wide LOD kernel's whitening span and of the sync spans inside it, and
nothing else; a part of the preparation's idle share; None in a window
without the span. ``prep_idle_pct.p95``, the preparation's idle share of a
cell judged by its p95, reads as ``prep_idle_pct.scan`` does."""

from __future__ import annotations

import pytest

from portbench.core import readers, spec, trace

R = trace.Record


def _summary(extra):
    """Two calls of 1 s; the device busy over [0.1, 0.3] and [1.2, 1.5],
    so idle over [0, 0.1], [0.3, 1.2] and [1.5, 2.0]."""
    return trace.summarize([
        R(trace.CALL, "host", 0.0, 1.0), R(trace.CALL, "host", 1.0, 2.0),
        R("liteqtl_wide_wgmma_kernel<1>", "kernel", 0.1, 0.3),
        R("liteqtl_wide_wgmma_kernel<1>", "kernel", 1.2, 1.5),
        *extra,
    ])


def _program():
    return [
        R("bulklmm.entry.bulkscan", "host", 0.0, 0.95),
        R("bulklmm.prep.inputs", "host", 0.3, 0.9),
        R("bulklmm.sync.pinv", "host", 0.3, 0.4),  # the inputs' own: prep, not whitening
        R("bulklmm.prep.whiten", "host", 0.4, 0.8),
        R("bulklmm.sync.cholesky", "host", 0.5, 0.6),  # inside the whitening: its
        R("bulklmm.entry.bulkscan", "host", 1.0, 1.95),
        R("bulklmm.prep.inputs", "host", 1.5, 1.9),
        R("bulklmm.prep.whiten", "host", 1.6, 1.7),
    ]


def _read(name, s):
    ctx = readers.Context(summary=s, call={}, kernel="lod", peaks=None)
    return spec.metric_reader(name).read(ctx)


def test_the_whitening_and_its_syncs_take_their_idle_time():
    s = _summary(_program())
    # [0.4, 0.8] with the factorisation's wait inside it, and [1.6, 1.7]
    assert _read("whiten_idle_pct.scan", s) == pytest.approx(100 * (0.4 + 0.1) / 2.0)
    # the preparation's share holds the whitening's and the rest of the inputs'
    prep = _read("prep_idle_pct.scan", s)
    assert prep == pytest.approx(100 * (0.6 + 0.4) / 2.0)
    assert _read("whiten_idle_pct.scan", s) < prep
    # the reader leaves the summary as it found it
    assert sum(r.name == "bulklmm.prep.whiten" for r in s.host) == 2


def test_a_window_without_the_whitening_reads_none():
    assert _read("whiten_idle_pct.scan", _summary([])) is None
    other = [r for r in _program() if r.name != "bulklmm.prep.whiten"]
    assert _read("whiten_idle_pct.scan", _summary(other)) is None
    assert _read("prep_idle_pct.scan", _summary(other)) is not None


def test_whitening_while_the_device_is_busy_reads_zero():
    s = _summary([R("bulklmm.entry.bulkscan", "host", 0.0, 0.95),
                  R("bulklmm.prep.whiten", "host", 0.12, 0.28)])
    assert _read("whiten_idle_pct.scan", s) == 0.0


def test_the_p95_cells_preparation_share_is_the_scans():
    s = _summary(_program())
    assert _read("prep_idle_pct.p95", s) == pytest.approx(100 * (0.6 + 0.4) / 2.0)
    assert _read("prep_idle_pct.p95", s) == _read("prep_idle_pct.scan", s)
    assert _read("prep_idle_pct.p95", _summary([])) is None
