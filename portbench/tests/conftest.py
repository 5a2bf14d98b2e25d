"""Tests of the benchmark's harness: ``python -m pytest portbench/tests``.

They run on the CPU, the program through its plain versions, at tiny sizes;
``card`` marks a test that needs a CUDA card and skips without one.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core import spec  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny(name: str, **config) -> spec.Cell:
    """Cell ``name`` of BENCHMARK.json cut to a size the CPU runs in a
    fraction of a second, every trait of the last call compared."""
    c = spec.cell(name)
    c.config = dict(c.config, n=30, p=64, m=40, **config)
    c.traffic = dict(c.traffic, kwargs=dict(c.traffic["kwargs"]))
    if c.traffic["traits_per_call"]:
        c.traffic["traits_per_call"] = 6
    if "nperms" in c.traffic["kwargs"]:
        c.traffic["kwargs"]["nperms"] = 20
    c.checks = dict(c.checks, sample_traits=5, last_call_traits=None,
                    perm_columns=c.checks.get("perm_columns") and 7)
    return c


WORKLOADS = [w["name"] for w in spec.load_benchmark()["workloads"]]
