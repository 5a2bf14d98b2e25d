"""One run of one cell: set-up, the timed window, the comparison.

The traffic mix names the entry point (``bulkscan`` or ``bulkscan_perms``
of ``bulklmm_tpu_torch``), the kind of call (``kinds/<kind>.py``), its
keyword arguments, how many traits a call takes and how many trait panels
the calls cycle through. Call i takes panel ``i % panels`` and, where its
kind takes shuffles, fresh shuffle indices drawn from (seed, i) and passed
as ``perm_idx``. A call is timed from its start to the scalar fetch of a
device-side checksum of its outputs, so the host clock around it covers the
device's work. The checksum is the harness's own work: it starts once the
device has finished the call, under an annotation of its own, so that the
trace's readers can leave it out of the program's layers.

Set-up runs from the process's start to the first timed call: imports,
CUDA's start, the data drawn on the device, the kinship's decomposition
where the configuration hands the program one, and :data:`WARMUP_CALLS`
calls (the first builds or loads the kernel library). The window then runs whole calls
back to back until ``seconds`` have passed; the last call finishes. With
``trace`` the calls of the window's first :data:`TRACE_SECONDS` run under
``torch.profiler`` and the run reports the per-layer metrics, read from
them, instead of the end-to-end ones.

After the window the comparison (``core/judge.py``) takes the first call,
one drawn from the seed among those on another trait panel, and the last;
its time counts in neither set-up nor the window.
"""

from __future__ import annotations

import random
import sys
import time
import traceback

import numpy as np
import torch

from . import data, judge, peaks, readers, spec, trace


#: the traced run profiles the whole calls of the window's first seconds
TRACE_SECONDS = 10.0
#: calls before the window: the first builds or loads the kernels and warms
#: every shape; the second runs on the other trait panel, as warm as the window
WARMUP_CALLS = 2


def _log(*args):
    print("#", *args, file=sys.stderr, flush=True)


def call_shape(cell: spec.Cell) -> dict:
    cfg, tr = cell.config, cell.traffic
    return {
        "n": cfg["n"], "p": cfg["p"], "m": tr["traits_per_call"] or cfg["m"],
        "c": cfg["covariates"], "g": len(cfg["h2_grid"]),
        "columns": tr["kwargs"].get("nperms", 0) + 1,
    }


def end_to_end(name: str, kind, *, shape, times, window_s, setup_s):
    """The end-to-end metric ``name`` of a run: ``setup_s``; ``<x>_lods_per_s``,
    the LODs of every call of the window (the kind's ``lods(shape)`` a
    call) over its seconds; ``<x>_p95_ms``, the 95th percentile of every
    call's time."""
    if name == "setup_s":
        return setup_s
    if name.endswith("_lods_per_s"):
        return kind.lods(shape) * len(times) / window_s
    if name.endswith("_p95_ms"):
        return 1e3 * float(np.percentile(np.asarray(times), 95))
    raise KeyError(f"no end-to-end metric named {name!r}")


def checksum(kind, res) -> float:
    """A scalar fetched from a device-side sum of every output of a call
    (the kind's ``outputs``), once the device has finished the call: under
    its own annotation, which the trace's readers leave out of the
    program's layers."""
    outputs = kind.outputs(res)
    if outputs[0].is_cuda:
        torch.cuda.synchronize(outputs[0].device)
    with torch.profiler.record_function(trace.CHECKSUM):
        parts = [t.sum(dtype=torch.float64).to(outputs[0].device) for t in outputs]
        return float(torch.stack(parts).sum())


class Data:
    """A cell's inputs, drawn from the seed on ``device``: genotypes G
    (n, p) float32, the kinship on the host (float64), the extra
    covariates, the trait panels, and each call's shuffle indices."""

    def __init__(self, cell: spec.Cell, seed: int, device):
        cfg, tr = cell.config, cell.traffic
        shape = call_shape(cell)
        self.seed = seed
        self.device = torch.device(device)
        self.n, self.traits = shape["n"], shape["m"]
        self.nperms = tr["kwargs"].get("nperms")
        self.G = data.genotypes(cfg, seed, self.device)
        K = data.kinship(self.G)
        self.covar = data.covariates(cfg, seed, self.device)
        self.panels = data.trait_panels(cfg, K, self.traits, tr["panels"], seed)
        self.K_host = K.cpu().numpy()

    def panel(self, call: int) -> torch.Tensor:
        return self.panels[call % len(self.panels)]

    def shuffles(self, call: int) -> torch.Tensor:
        return data.shuffles(self.n, self.nperms, self.seed, call, self.device)


class Program:
    """The system under test as a cell calls it, on ``Data``."""

    def __init__(self, cell: spec.Cell, d: Data):
        import bulklmm_tpu_torch as bt

        cfg, tr = cell.config, cell.traffic
        self.kind = spec.kind(tr["kind"])
        self.data = d
        precision = bt.precision_by_name(cfg["precision"])
        if cfg["kinship_input"] == "decomposition":
            self.kinship = bt.decompose_kinship(d.K_host, dtype=precision.resolve_solve(),
                                                device=d.device)
        else:
            self.kinship = d.K_host
        self.entry = getattr(bt, tr["entry"])
        self.kwargs = dict(tr["kwargs"], precision=precision, h2_grid=list(cfg["h2_grid"]),
                           reml=cfg["reml"])
        if d.device.type == "cpu":
            self.kwargs["device"] = "cpu"

    def __call__(self, call: int):
        """(result, checksum) of call ``call``."""
        d = self.data
        kw = dict(self.kwargs, **self.kind.call_kwargs(d, call))
        res = self.entry(d.panel(call), d.G, self.kinship, d.covar, **kw)
        return res, checksum(self.kind, res)

    def free(self):
        """Drop the program's own state (the decomposition); the data stays
        for the reference."""
        self.kinship = None


def compared_calls(cell: spec.Cell, seed: int):
    """``(first, last, columns)``: the trait columns that the comparison
    takes from the first and middle calls and from the last call, and
    ``columns(i, last)``, the shuffle columns compared of call i: every one
    of the last call's, ``perm_columns`` of the others' (None where the
    kind takes no shuffles)."""
    shape, checks = call_shape(cell), cell.checks
    first = data.sample_traits(shape["m"], checks["sample_traits"], seed)
    last = data.sample_traits(shape["m"], checks["last_call_traits"], seed)
    if not spec.kind(cell.traffic["kind"]).SHUFFLES:
        return first, last, lambda i, last=False: None

    def columns(i, last=False):
        count = None if last else checks.get("perm_columns")
        return data.sample_columns(shape["columns"], count, seed, i)

    return first, last, columns


def reference(cell: spec.Cell, d: Data, *, control=False):
    from ..reference.lmm import LMM

    if cell.config["reml"]:
        raise ValueError("the reference fits ML only")
    return LMM(d.K_host, d.G, d.covar, cell.config["h2_grid"], control=control)


def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool, device,
        process_start: float) -> dict:
    """One run of ``cell``; returns the result's line (as a dict)."""
    device = torch.device(device)
    kind, checks = spec.kind(cell.traffic["kind"]), cell.checks
    shape = call_shape(cell)
    d = Data(cell, seed, device)
    prog = Program(cell, d)
    _log(f"data ready at {time.time() - process_start:.3f} s")
    warm = WARMUP_CALLS
    sample, last_sample, columns = compared_calls(cell, seed)
    for i in range(warm):
        res, _ = prog(i)
        judge.keep(kind, res, i, sample, columns(i))  # the window's copies, loaded here
        del res
        _log(f"warm-up call {i} done at {time.time() - process_start:.3f} s")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    reservoir = random.Random(data.mix(seed, "reservoir"))
    kept_first = kept_middle = None
    panels = len(d.panels)
    times, failed = [], 0
    prof = None
    if trace_on:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    tracing = trace_on
    setup_s = time.time() - process_start
    i = warm
    t0 = time.perf_counter()
    while True:
        res = None  # one result alive at a time
        ts = time.perf_counter()
        try:
            with torch.profiler.record_function(trace.CALL):
                res, _ = prog(i)
        except Exception:  # a failed call counts against the run, which goes on
            traceback.print_exc(file=sys.stderr)
            failed += 1
            res = None
        te = time.perf_counter()
        times.append(te - ts)
        if res is not None:
            if kept_first is None:
                kept_first = judge.keep(kind, res, i, sample, columns(i))
            elif (i - warm) % panels and reservoir.random() * ((i - warm + 1) // 2) < 1.0:
                # among the calls on another panel than the first timed one's
                kept_middle = judge.keep(kind, res, i, sample, columns(i))
        i += 1
        if tracing and (te - t0 >= TRACE_SECONDS or te - t0 >= seconds):
            prof.__exit__(None, None, None)  # the traced calls end; the window goes on
            tracing = False
        if te - t0 >= seconds:
            break
    window_s = te - t0
    last_call = i - 1
    _log(window_report(times, window_s))
    summary = trace.summarize(trace.records_from(prof)) if trace_on else None
    del prof
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kept = [k for k in (kept_first, kept_middle) if k is not None]
    if res is not None:
        kept.append(judge.keep(kind, res, last_call, last_sample, columns(last_call, True)))
    del res
    _log(f"window closed: {len(times)} calls, {failed} failed, {window_s:.3f} s")

    line = {"correct": False, "attempted": len(times), "failed": failed}
    if trace_on:
        ctx = readers.Context(summary=summary, call=shape, kernel=cell.traffic["kernel"],
                              peaks=peaks.for_device(_device_name(device)))
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], kind, shape=shape, times=times,
                                                   window_s=window_s, setup_s=setup_s),
                               "unit": m["unit"]} for m in cell.end_to_end}
    line["metrics"] = metrics
    line["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                      "kind": _device_name(device), "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        line["device"]["busy_s"] = summary.busy_s
        line["device"]["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.device_ops(), "idle_gaps": summary.idle_gaps()}

    t_ref = time.perf_counter()
    prog.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = judge.judge(kind, reference(cell, d), kept, d.panels, d.shuffles)
    ok, line["checks"] = judge.verdict(values, checks["limits"])
    line["correct"] = bool(ok and failed == 0 and len(kept) > 0)
    _log(f"comparison took {time.perf_counter() - t_ref:.3f} s over calls "
         f"{[k.call for k in kept]}")
    return line


def window_report(times, window_s) -> str:
    """One line on how the window's calls spread: the median and longest
    call (its index and when it started) and the calls a second in each
    quarter of the window."""
    t = np.asarray(times)
    starts = np.concatenate([[0.0], np.cumsum(t)[:-1]])
    worst = int(np.argmax(t))
    quarters = []
    for q in range(4):
        inside = (starts >= q * window_s / 4) & (starts < (q + 1) * window_s / 4)
        quarters.append(f"{inside.sum() / max(t[inside].sum(), 1e-12):.4g}")
    return (f"calls: median {1e3 * float(np.median(t)):.3f} ms, longest "
            f"{1e3 * float(t[worst]):.3f} ms (call {worst} of {len(t)}, at "
            f"{float(starts[worst]):.2f} s); calls/s by quarter {' '.join(quarters)}")


def _device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
