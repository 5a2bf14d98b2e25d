"""Finding a cell's pieces by name.

``BENCHMARK.json`` names the cells; each cell names a configuration (whose
file ``BENCHMARK.json`` gives) and a traffic mix (``traffic/<name>.json``);
the cell's own checks are ``checks/<cell>.json``; the kind of call that a
traffic mix names is ``kinds/<kind>.py``, a per-layer metric's reader
``metrics/<metric>.py`` and a kernel's counts ``flops/<kernel>.py``.
Nothing here knows a particular cell, mix or metric.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Cell:
    """One cell of the benchmark with everything it reads."""

    name: str
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list
    chips: int = 1


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    """Whether a metric entry of ``BENCHMARK.json`` is reported in a cell:
    the cells its ``workloads`` key lists, or every cell without one."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, checks and the metrics that it reports."""
    bench = load_benchmark(root) if bench is None else bench
    w = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], w["config"], "configuration")
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, name) and m["moves"] in reported]
    return Cell(
        name=name,
        config=read_json(root / cfg_entry["file"]),
        traffic=read_json(PACKAGE / "traffic" / f"{w['traffic']}.json"),
        checks=read_json(PACKAGE / "checks" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
        chips=int(w["chips"]),
    )


def _load_file(path: Path, prefix: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_name = f"portbench.{prefix}.{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def kind(name: str):
    """``kinds/<name>.py``: what a kind of call outputs, keeps and compares
    (``core/judge.py`` lists its names)."""
    return _load_file(PACKAGE / "kinds" / f"{name}.py", "kinds")


def metric_reader(name: str):
    """``metrics/<name>.py``: a module with ``read(ctx) -> float | None``."""
    return _load_file(PACKAGE / "metrics" / f"{name}.py", "metrics")


def kernel_counts(name: str):
    """``flops/<name>.py``: a module with ``NAME_PREFIXES``,
    ``launch_shape(call, launches)``, ``flops(shape)`` and ``bytes(shape)``."""
    return _load_file(PACKAGE / "flops" / f"{name}.py", "flops")
