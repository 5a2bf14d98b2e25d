"""What a run may load and read: no module of JAX or of the JAX package in
a run's process (top-level names compared whole: the port's name begins
with the JAX package's), nothing of the program in the reference, and no
file of the JAX package's benchmarks or drivers."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "bulklmm_tpu"}


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _harness_files():
    return [p for p in spec.PACKAGE.rglob("*.py") if "tests" not in p.parts]


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in _harness_files():
        assert not _top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.PACKAGE / "reference").glob("*.py"):
        allowed = {"__future__", "contextlib", "math", "numpy", "torch"}
        assert _top_level_imports(path) <= allowed, path


def test_no_harness_file_names_the_jax_benchmarks_or_drivers():
    for path in _harness_files():
        text = path.read_text()
        for name in ("benchmarks/", "bench.py", "chip_smoke"):
            assert name not in text, (path, name)


PROBE = r"""
import sys, time
sys.path.insert(0, {root!r})
from portbench import run
from portbench.core import cell
from portbench.tests.conftest import tiny
{body}
print("LOADED", ",".join(run.forbidden_modules()), "PROGRAM", "bulklmm_tpu_torch" in sys.modules)
"""


def _probe(body):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(spec.ROOT), body=body)],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    line = [ln for ln in out.splitlines() if ln.startswith("LOADED")][-1]
    return line.split()[1:]


@pytest.mark.parametrize("workload", ["bxd.perms", "bxd.altgrid"])
def test_a_whole_run_loads_no_jax(workload):
    loaded = _probe(f"cell.run(tiny({workload!r}), 5, 0.1, True, 'cpu', time.time())")
    assert loaded[0] == "PROGRAM", loaded  # nothing between LOADED and PROGRAM
    assert loaded[1] == "True"


def test_the_reference_alone_loads_no_program():
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, %r); "
         "import portbench.reference.lmm; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
         % (str(spec.ROOT), FORBIDDEN | {"bulklmm_tpu_torch"})],
        capture_output=True, text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"
