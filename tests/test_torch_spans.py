"""The port's spans (``utils/profiling.py::span``): off, a span is one shared
no-op and enters no record function; under ``torch.profiler`` each entry
point's call records its ``bulklmm.*`` spans, every one inside the call's
numbered entry span, with a fixed set of spans a path; and a call's outputs
are the same bit for bit with the profiler on and off.

The paths run on the CPU at a tiny size. A ``bulklmm.sync.*`` span marks
where the host waits on a card; it opens on the CPU as well, so the counts
here are the card's but for the memory probe (``mem_get_info``, CUDA only)
and the uploads of tensors that the CPU already holds."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.ops.bulkperm import permutation_indices
from bulklmm_tpu_torch.utils import profiling
from bulklmm_tpu_torch.utils.host import to_device, to_numpy

N, P, M, NPERMS = 30, 40, 12, 9


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    G = rng.uniform(size=(N, P))
    X = G - 0.5
    K = 2.0 * X @ X.T / P + 0.5
    np.fill_diagonal(K, 1.0)
    return dict(Y=torch.from_numpy(rng.normal(size=(N, M))), G=torch.from_numpy(G), K=K)


def _call(path, d):
    kw = dict(precision=bt.BALANCED, device="cpu")
    Y, G, K = d["Y"], d["G"], d["K"]
    if path == "null-grid":
        return bt.bulkscan(Y, G, K, **kw)
    if path == "null-grid-wide":  # 5 covariate columns: the wide kernel's operands
        covar = torch.from_numpy(np.random.default_rng(6).normal(size=(N, 4)))
        return bt.bulkscan(Y, G, K, covar, **kw)
    if path == "null-grid-chunks":
        return bt.bulkscan(Y, G, bt.decompose_kinship(K, device="cpu"), trait_chunk=5, **kw)
    if path == "alt-grid":
        return bt.bulkscan(Y, G, K, method="alt-grid", **kw)
    if path == "perms":
        return bt.bulkscan_perms(Y, G, K, nperms=NPERMS, **kw)
    assert path == "perms-kernel"  # the kernel's route, its plain version; shuffles passed
    return bt.bulkscan_perms(Y, G, K, nperms=NPERMS, engine="pallas", interpret=True,
                             trait_chunk=5, perm_idx=permutation_indices(N, NPERMS, 3), **kw)


#: the spans a call of each path records on the CPU
EXPECTED = {
    "null-grid": {
        "bulklmm.entry.bulkscan": 1, "bulklmm.entry.budget": 1, "bulklmm.entry.chunk": 2,
        "bulklmm.prep.rotate": 1, "bulklmm.prep.null_fit": 1, "bulklmm.prep.inputs": 1,
        "bulklmm.sync.upload": 3, "bulklmm.sync.scalar": 2, "bulklmm.sync.pinv": 1,
    },
    "null-grid-wide": {  # the covariates' rank check downloads them; the whitening and its wait
        "bulklmm.entry.bulkscan": 1, "bulklmm.entry.budget": 1, "bulklmm.entry.chunk": 2,
        "bulklmm.prep.rotate": 1, "bulklmm.prep.null_fit": 1, "bulklmm.prep.inputs": 1,
        "bulklmm.prep.whiten": 1, "bulklmm.sync.upload": 3, "bulklmm.sync.download": 1,
        "bulklmm.sync.scalar": 2, "bulklmm.sync.pinv": 1, "bulklmm.sync.cholesky": 1,
    },
    "null-grid-chunks": {  # a cached decomposition; 3 trait chunks for the fit, 3 for the LODs
        "bulklmm.entry.bulkscan": 1, "bulklmm.entry.chunk": 6, "bulklmm.prep.rotate": 1,
        "bulklmm.prep.null_fit": 3, "bulklmm.prep.inputs": 3, "bulklmm.sync.upload": 1,
        "bulklmm.sync.scalar": 4, "bulklmm.sync.pinv": 3,
    },
    "alt-grid": {  # the plain formulation: the kernel's operands are the card's
        "bulklmm.entry.bulkscan": 1, "bulklmm.entry.budget": 1, "bulklmm.entry.chunk": 1,
        "bulklmm.prep.rotate": 1, "bulklmm.sync.upload": 3, "bulklmm.sync.scalar": 1,
    },
    "perms": {
        "bulklmm.entry.bulkscan_perms": 1, "bulklmm.entry.budget": 1, "bulklmm.entry.chunk": 1,
        "bulklmm.prep.rotate": 3, "bulklmm.prep.null_fit": 1, "bulklmm.prep.inputs": 2,
        "bulklmm.prep.shuffles": 2, "bulklmm.sync.upload": 3, "bulklmm.sync.scalar": 1,
    },
    "perms-kernel": {  # 3 trait blocks, each its block's and its shuffles' operands
        "bulklmm.entry.bulkscan_perms": 1, "bulklmm.entry.budget": 1, "bulklmm.entry.chunk": 3,
        "bulklmm.prep.rotate": 3, "bulklmm.prep.null_fit": 1, "bulklmm.prep.inputs": 8,
        "bulklmm.prep.shuffles": 2, "bulklmm.sync.upload": 3, "bulklmm.sync.download": 1,
        "bulklmm.sync.scalar": 1, "bulklmm.sync.pinv": 1,
    },
}


def _spans(prof):
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("bulklmm.")), key=lambda e: (e.start_ns(), -e.end_ns()))


def test_off_a_span_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("bulklmm.entry.x") is profiling.span("bulklmm.prep.y", {"traits": 3})
    assert profiling.span("bulklmm.entry.x") is profiling._NO_SPAN
    with profiling.span("bulklmm.entry.x") as inside:
        assert inside is None


def test_off_no_record_function_is_entered(data, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record function was entered with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for path in EXPECTED:
        _call(path, data)


def test_spanned_keeps_the_function_and_numbers_its_calls():
    @profiling.spanned("bulklmm.entry.f", numbered=True)
    def f(x, *, k=2):
        """f's docstring"""
        return x * k

    assert f.__name__ == "f" and f.__doc__ == "f's docstring" and f(3, k=4) == 12
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        f(1)
        f(2)
    calls = [e.kwinputs()["call"] for e in _spans(prof)]
    assert len(calls) == 2 and calls[1] == calls[0] + 1


@pytest.mark.parametrize("path", sorted(EXPECTED))
def test_a_call_records_its_spans_inside_its_numbered_entry_span(data, path):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        _call(path, data)
        _call(path, data)
    spans = _spans(prof)
    counts = collections.Counter(e.name() for e in spans)
    assert dict(counts) == {k: 2 * v for k, v in EXPECTED[path].items()}
    entries = [e for e in spans if e.name().startswith("bulklmm.entry.bulkscan")]
    numbers = [e.kwinputs()["call"] for e in entries]
    assert len(entries) == 2 and numbers[1] > numbers[0]
    for e in spans:
        owners = [c for c in entries if c.start_ns() <= e.start_ns() and e.end_ns() <= c.end_ns()]
        assert len(owners) == 1, e.name()
        assert e.name().split(".")[1] in ("entry", "prep", "sync")
    widths = [e.kwinputs()["traits"] for e in spans if e.name() == "bulklmm.entry.chunk"]
    assert sum(widths) == 2 * M * (2 if path.startswith("null-grid") else 1)


def _tensors(result):
    return {f.name: getattr(result, f.name) for f in dataclasses.fields(result)
            if torch.is_tensor(getattr(result, f.name))}


@pytest.mark.parametrize("path", sorted(EXPECTED))
def test_outputs_are_bit_identical_with_the_profiler_on_and_off(data, path):
    off = _tensors(_call(path, data))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _tensors(_call(path, data))
    assert off.keys() == on.keys() and off
    for name in off:
        assert torch.equal(off[name], on[name]), name


def test_copies_between_memories_are_sync_spans():
    here = torch.zeros(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert to_device(here, "cpu") is here  # already there: no copy, no span
        assert torch.equal(to_device(np.zeros(3), "cpu", torch.float32), here)
        assert np.array_equal(to_numpy(here), np.zeros(3))
        to_numpy([1.0, 2.0])  # host data: no copy
    assert [e.name() for e in _spans(prof)] == ["bulklmm.sync.upload", "bulklmm.sync.download"]
