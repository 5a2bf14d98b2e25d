"""The validation sweep (``bulklmm_tpu_torch/validation.py``), the port's
counterpart of ``benchmarks/tpu_validation.py``: its bar table against the
JAX sweep's, key by key, and its in-process paths with both sides on the
CPU (BALANCED against the EXACT64 goldens) under its own bars. The
subprocess paths (kill-and-resume, the command line) run on the card in
``chip_smoke.py`` phase 16; ``tests/test_torch_cli.py`` holds the command
line on the CPU.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bulklmm_tpu_torch import validation

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _jax_sweep_tol() -> dict:
    """``TOL`` of benchmarks/tpu_validation.py, whose top level needs only
    numpy."""
    spec = importlib.util.spec_from_file_location(
        "tpu_validation", REPO / "benchmarks" / "tpu_validation.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.TOL


def test_bar_table_is_the_jax_sweeps():
    """Every key of the JAX sweep at the same bar, plus the two c = 12 keys
    of the wide LOD kernel, and nothing else."""
    jax_tol = _jax_sweep_tol()
    assert len(jax_tol) == 41
    assert {k: validation.TOL[k] for k in jax_tol} == jax_tol
    assert set(validation.TOL) - set(jax_tol) == {"bulk_null_grid_c12", "effects_c12"}
    assert validation.TOL["bulk_null_grid_c12"] == validation.TOL["effects_c12"] == 2e-5
    assert set(validation.SUBPROCESS_PATHS) <= set(jax_tol)


def test_fixture_is_the_jax_sweeps():
    d = validation.fixture()
    assert d["G"].shape == (79, 512) and d["Y"].shape == (79, 64) and d["covar12"].shape == (79, 11)
    assert d["lrU"].shape == (79, 32) and np.isnan(d["Ym"]).sum() == 13
    # the first draws are the JAX sweep's: default_rng(17), G first
    G = np.random.default_rng(17).uniform(0, 1, (79, 512)).astype(np.float32)
    assert np.array_equal(d["G"], G)


def test_in_process_paths_pass_on_the_cpu():
    lines = validation.run(torch.device("cpu"), in_process=True)
    want = set(validation.TOL) - set(validation.SUBPROCESS_PATHS)
    assert [line["path"] for line in lines] == [k for k in validation.TOL if k in want]
    failed = [line for line in lines if not line["pass"]]
    assert not failed, failed
    assert all(line["tol"] == validation.TOL[line["path"]] for line in lines)


def test_compare_marks_the_paths_that_miss_their_bar():
    gold = {"scan_null": np.zeros(3), "scan_reml": np.zeros(2)}
    lines = validation.compare({
        "scan_null": np.array([0.0, 1e-6, 0.0]), "scan_reml": (np.array([0.0, 3e-5]), "scan_reml"),
        "resume_on_chip": (0.0, "SELF"), "cli_kinship": (np.array([1e-4]), "ZERO"),
    }, gold)
    assert [(x["path"], x["pass"]) for x in lines] == [
        ("scan_null", True), ("scan_reml", False), ("resume_on_chip", True), ("cli_kinship", False)]
    assert lines[1]["max_abs_err"] == 3e-5


def test_main_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        validation.main()
