"""The harness finds its pieces by name, and its arithmetic on synthetic
records: the window rate, the p95, the union of device intervals, the idle
share and its gaps, the harness's checksum kept out of the program's
layers, the roofline and the share of the peak, and the comparison's tie of
two grid likelihoods."""

from __future__ import annotations

import json
import re

import pytest
import torch

from portbench.core import cell, judge, readers, spec, trace
from portbench.tests.conftest import WORKLOADS

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_finds_its_pieces(workload):
    c = spec.cell(workload)
    assert c.chips == 1
    assert {"n", "p", "m", "covariates", "h2_grid", "precision", "kinship_input"} <= set(c.config)
    kind = spec.kind(c.traffic["kind"])
    spec.kernel_counts(c.traffic["kernel"])
    assert set(c.checks["limits"]) == set(kind.NUMBERS)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert spec.applies(e2e[m["moves"]], w), (m["name"], w)
    for c in BENCH["configs"]:
        cfg = spec.read_json(spec.ROOT / c["file"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert len(json.dumps(BENCH)) < 64 * 1024


KIND_API = ("NUMBERS", "SHUFFLES", "lods", "call_kwargs", "outputs", "keep", "compare", "control")


@pytest.mark.parametrize("name", sorted(p.stem for p in (spec.PACKAGE / "kinds").glob("*.py")))
def test_every_kind_has_the_whole_interface_and_a_mix(name):
    kind = spec.kind(name)
    assert all(hasattr(kind, a) for a in KIND_API), name
    mixes = [spec.read_json(p)["kind"] for p in (spec.PACKAGE / "traffic").glob("*.json")]
    assert name in mixes


def test_the_last_call_compares_every_shuffle_column():
    c = spec.cell("biobank.perms")
    first, last, columns = cell.compared_calls(c, 2**33 + 5)
    assert first.numel() == c.checks["sample_traits"] and last.numel() == 32
    assert columns(7).numel() == c.checks["perm_columns"] and int(columns(7)[0]) == 0
    assert torch.equal(columns(7, True), torch.arange(1001))
    assert cell.compared_calls(spec.cell("bxd.altgrid"), 3)[2](4, True) is None


def test_every_metric_file_is_declared():
    declared = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (spec.PACKAGE / "metrics").glob("*.py")}
    assert files == declared


def test_window_rate_and_p95():
    shape = {"n": 79, "p": 7321, "m": 35554, "c": 1, "g": 10, "columns": 1001}
    perms, scan, alt = spec.kind("perms"), spec.kind("scan"), spec.kind("altgrid")
    times = [0.5, 0.52, 0.49, 0.51]
    rate = cell.end_to_end("perm_lods_per_s", perms, shape=shape, times=times, window_s=2.1,
                           setup_s=9.0)
    assert rate == pytest.approx(35554 * 7321 * 1001 * 4 / 2.1)
    assert cell.end_to_end("scan_lods_per_s", scan, shape=shape, times=times, window_s=2.0,
                           setup_s=9.0) == pytest.approx(35554 * 7321 * 2)
    assert cell.end_to_end("altgrid_lods_per_s", alt, shape=shape, times=times, window_s=2.0,
                           setup_s=9.0) == pytest.approx(35554 * 7321 * 2)
    times = [float(t) for t in range(1, 101)]  # 1 .. 100 ms
    assert cell.end_to_end("scan_p95_ms", alt, shape=shape, times=[t / 1e3 for t in times],
                           window_s=5.0, setup_s=1.0) == pytest.approx(95.05)
    assert cell.end_to_end("setup_s", alt, shape=shape, times=times, window_s=1,
                           setup_s=7.5) == 7.5


def test_window_report_names_the_longest_call():
    times = [0.1] * 10 + [0.9] + [0.1] * 9
    line = cell.window_report(times, sum(times))
    assert "longest 900.000 ms (call 10 of 20, at 1.00 s)" in line
    quarters = [float(q) for q in line.rsplit("quarter ", 1)[1].split()]
    assert len(quarters) == 4 and min(quarters) == quarters[1] < 5 < quarters[0] == quarters[3]


def _records():
    R = trace.Record
    return [
        R(trace.CALL, "host", 0.0, 1.0), R(trace.CALL, "host", 1.0, 2.0),
        R("aten::item", "host", 0.35, 0.6), R("cudaStreamSynchronize", "host", 0.4, 0.55),
        R("liteqtl_general_wgmma_kernel<1>", "kernel", 0.1, 0.3),
        R("elementwise", "kernel", 0.2, 0.4),  # overlaps the first: counted once
        R("Memcpy DtoH", "copy", 0.6, 0.7),
        R("liteqtl_general_wgmma_kernel<1>", "kernel", 1.2, 1.5),
        R("outside", "kernel", 2.5, 3.0),  # after the window: left out
    ]


def test_busy_is_the_union_and_gaps_name_the_host_operation():
    s = trace.summarize(_records())
    assert s.calls == 2 and s.window_s == pytest.approx(2.0)
    assert s.busy_s == pytest.approx(0.3 + 0.1 + 0.3)
    assert [tuple(round(x, 6) for x in g) for g in s.gaps] == [
        (0.0, 0.1), (0.4, 0.6), (0.7, 1.2), (1.5, 2.0)]
    gaps = dict(s.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.2)  # innermost at 0.5
    assert gaps["(no host operation)"] == pytest.approx(0.1 + 0.5 + 0.5)
    assert s.device_ops()[0] == ["liteqtl_general_wgmma_kernel<1>", pytest.approx(0.5)]
    ctx = readers.Context(summary=s, call={}, kernel="lod", peaks=None)
    assert readers.idle_pct(ctx) == pytest.approx(100 * (1 - 0.7 / 2.0))
    assert readers.launches_per_call(ctx) == pytest.approx(3 / 2)
    # everything but the LOD kernel: elementwise past 0.3 and the copy
    assert readers.prep_device_ms(ctx) == pytest.approx(1e3 * (0.2 + 0.1) / 2)


@pytest.mark.parametrize("name, function", [
    ("void liteqtl::liteqtl_general_wgmma_kernel<tf32x3::Policy, 1, 1, false, true>(float const*)",
     "liteqtl_general_wgmma_kernel"),
    ("void (anonymous namespace)::bulkperm_wide_kernel<tf32x3::Policy, 10>(float const*, int)",
     "bulkperm_wide_kernel"),
    ("void (anonymous namespace)::altgrid_kernel<tf32x3::Policy, true>(float const*)",
     "altgrid_kernel"),
    ("sm90_xmma_gemm_f64f64_f64_nt_n_tilesize64x64x32", "sm90_xmma_gemm_f64f64_f64_nt_n_tilesize64x64x32"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH"),
])
def test_kernel_function_names(name, function):
    assert trace.function_name(name) == function


def test_the_checksum_is_left_out_of_the_programs_layers():
    R = trace.Record
    records = _records() + [
        R(trace.CHECKSUM, "host", 0.8, 0.95),
        R("reduce_kernel", "kernel", 0.82, 0.84), R("Memcpy DtoH", "copy", 0.85, 0.86),
    ]
    s = trace.summarize(records)
    assert s.busy_s == pytest.approx(0.7 + 0.02 + 0.01)  # busy all the same
    ctx = readers.Context(summary=s, call={}, kernel="lod", peaks=None)
    assert readers.launches_per_call(ctx) == pytest.approx(3 / 2)
    assert readers.prep_device_ms(ctx) == pytest.approx(1e3 * (0.2 + 0.1) / 2)
    ops = dict(s.device_ops())
    assert ops[f"{trace.CHECKSUM}: reduce_kernel"] == pytest.approx(0.02)
    assert ops["Memcpy DtoH"] == pytest.approx(0.1)  # the program's copy alone


def test_roofline_and_mfu():
    s = trace.summarize(_records())
    call = {"n": 100, "p": 1000, "m": 4000, "c": 1, "g": 10, "columns": 1}
    peaks = {"flops": 1e12, "bytes_per_s": 1e9}
    ctx = readers.Context(summary=s, call=call, kernel="lod", peaks=peaks)
    lod = spec.kernel_counts("lod")
    # one launch a call, the whole call's traits each
    per_launch = max(lod.flops(call) / 1e12, lod.bytes(call) / 1e9)
    assert per_launch == pytest.approx(lod.bytes(call) / 1e9)  # bound by bytes here
    assert readers.roofline_pct(ctx, "lod") == pytest.approx(100 * 2 * per_launch / 0.5)
    assert readers.roofline_pct(ctx, "perm") is None  # not this cell's kernel
    flops = 2 * 100 * 3 * 1000 * 4000 + 2 * 100**2 * (1000 + 4000 + 1)
    assert readers.mfu_pct(ctx) == pytest.approx(100 * 2 * flops / (2.0 * 1e12))
    assert readers.mfu_pct(readers.Context(s, call, "lod", None)) is None


def test_least_time_splits_the_traits_evenly():
    perm = spec.kernel_counts("perm")
    call = {"n": 79, "p": 7321, "m": 35554, "c": 1, "g": 10, "columns": 1001}
    peaks = {"flops": 989e12, "bytes_per_s": 3.35e12}
    one = readers.least_seconds(perm, call, 35, 1, peaks)
    assert one == pytest.approx(perm.flops(call) / 989e12)  # bound by flops, any split
    assert perm.flops(call) == 2 * 79 * 7321 * 1001 * 35554
    alt = spec.kernel_counts("altgrid")
    # bound by bytes: the markers are read once a launch
    two = readers.least_seconds(alt, call, 2, 1, peaks)
    assert two == pytest.approx(2 * alt.bytes(dict(call, m=35554 / 2)) / 3.35e12)


def test_readers_read_nothing_without_device_records():
    R = trace.Record
    s = trace.summarize([R(trace.CALL, "host", 0.0, 1.0)])
    ctx = readers.Context(summary=s, call={}, kernel="perm", peaks={"flops": 1, "bytes_per_s": 1})
    assert readers.idle_pct(ctx) is None and readers.launches_per_call(ctx) is None
    assert readers.prep_device_ms(ctx) is None and readers.roofline_pct(ctx, "perm") is None
    assert readers.mfu_pct(ctx) is None


def test_a_tie_is_measured_per_sample_not_by_the_likelihood():
    """A float32 grid likelihood's rounding grows with the samples, not with
    the likelihood's value: a shortfall of 1.2e-3 at 5,000 samples ties near
    a likelihood of 0 as near one of -1,112, and one of 0.1 does not."""
    best = torch.tensor([-1111.773, -0.004, -1111.773], dtype=torch.float64)
    at = best - torch.tensor([1.2e-3, 1.2e-3, 0.1], dtype=torch.float64)
    assert judge.ties(best, at, 5000).tolist() == [True, True, False]
