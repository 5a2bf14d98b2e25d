"""THROUGHPUT's FWER study (``bulklmm_tpu_torch/throughput_fwer.py``)
against ``benchmarks/throughput_fwer.py`` on the CPU: the data bit for bit,
the per-seed thresholds of both tiers against the JAX package's
``bulkscan_perms`` and ``get_thresholds_bulk`` fed the same shuffle indices,
the rows against the JAX script's own ``fwer_measurement``, and the engine
table's keys and CPU run. On the CPU THROUGHPUT keeps float32 products, so
these tests hold the machinery; the claim itself is measured on the card
(``chip_smoke.py`` phase 18).
"""

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.ops import bulkperm as jops
from bulklmm_tpu.utils import config as jcfg
from bulklmm_tpu_torch import throughput_fwer as tf

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, P, M, NPERMS, NSEEDS = 79, 128, 8, 50, 2
#: max |d threshold|, port against the JAX package on the same indices:
#: tests/test_torch_bulkperm.py's bars on the maxima (a type-7 quantile
#: moves no farther than the maxima it interpolates)
BAR = {"balanced": 1e-4, "throughput": 1e-3}


def _script():
    """benchmarks/throughput_fwer.py, whose top level needs only numpy."""
    spec = importlib.util.spec_from_file_location("throughput_fwer_jax",
                                                  REPO / "benchmarks" / "throughput_fwer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def script():
    return _script()


@pytest.fixture(scope="module")
def data():
    return tf.synth(n=N, p=P, m=M)


def _jax_idx(seed):
    return np.asarray(jops.permutation_indices(N, NPERMS, seed))


@pytest.fixture(scope="module")
def port_thresholds(data):
    G, K, Y = data
    return tf.tier_thresholds(G, K, Y, nseeds=NSEEDS, nperms=NPERMS, device="cpu",
                              perm_idx=_jax_idx)


def test_constants_are_the_jax_scripts(script):
    assert (tf.ALPHAS, tf.NSEEDS, tf.NPERMS) == (script.ALPHAS, script.NSEEDS, script.NPERMS)
    assert (tf.NSEEDS, tf.NPERMS) == (10, 1000)


@pytest.mark.parametrize("kw", [dict(n=N, p=P, m=M), dict(), dict(n=79, p=512, m=64, seed=5)],
                         ids=["small", "default", "engine_table"])
def test_synth_is_the_jax_scripts_bit_for_bit(script, kw):
    for ours, theirs in zip(tf.synth(**kw), script.synth(**kw)):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("tier,preset", [("balanced", jcfg.BALANCED),
                                         ("throughput", jcfg.THROUGHPUT)])
def test_thresholds_match_the_jax_package_on_its_draws(data, port_thresholds, tier, preset):
    G, K, Y = data
    got = port_thresholds[tier]
    assert got.shape == (NSEEDS, len(tf.ALPHAS), M)
    for seed in range(NSEEDS):
        bp = bl.bulkscan_perms(Y, G, K, nperms=NPERMS, rndseed=seed, precision=preset)
        ref = bl.get_thresholds_bulk(bp.perm_maxima, tf.ALPHAS).thrs
        assert np.max(np.abs(got[seed] - ref)) <= BAR[tier], (tier, seed)


def test_rows_match_the_jax_scripts_fwer_measurement(script, data, monkeypatch):
    """The JAX script's own loop, with NSEEDS and NPERMS cut, draws the
    indices the port is given. Each threshold is within BAR of the JAX
    package's, so a paired difference or a spread moves by at most
    2 (1e-4 + 1e-3); a ratio by that over the smallest spread."""
    monkeypatch.setattr(script, "NSEEDS", NSEEDS)
    monkeypatch.setattr(script, "NPERMS", NPERMS)
    G, K, Y = data
    ref = script.fwer_measurement(G, K, Y)
    got = tf.fwer_measurement(G, K, Y, nseeds=NSEEDS, nperms=NPERMS, device="cpu",
                              perm_idx=_jax_idx)
    assert [r["alpha"] for r in got] == tf.ALPHAS and [set(r) for r in got] == [set(r) for r in ref]
    atol = 2 * (BAR["balanced"] + BAR["throughput"])
    for g, r in zip(got, ref):
        for key in r:
            tol = atol / r["mc_spread_min"] if key.startswith("delta_over") else atol
            assert abs(g[key] - r[key]) <= tol, (r["alpha"], key, g[key], r[key])


def test_fwer_rows_arithmetic():
    """Two seeds, one trait: the spread is |a - b| / sqrt(2)."""
    bal = np.array([[[1.0, 2.0]], [[1.2, 2.6]]]).transpose(0, 2, 1)  # (seeds, alphas, m=1)
    thr = bal + np.array([[[0.01], [0.02]], [[0.03], [0.0]]])
    rows = tf.fwer_rows(bal, thr, [0.1, 0.05])
    assert rows[0]["tier_delta_mean"] == pytest.approx(0.02)
    assert rows[0]["tier_delta_max"] == pytest.approx(0.03)
    assert rows[0]["mc_spread_mean"] == pytest.approx(0.2 / np.sqrt(2))
    assert rows[1]["delta_over_spread_max"] == pytest.approx(0.01 / (0.6 / np.sqrt(2)))


def test_engine_table_keys_are_engine_child_outputs(script):
    assert tuple(re.findall(r'out\["(\w+)"\]', script.ENGINE_CHILD)) == tf.ENGINES
    assert tf.ENGINE_DATA == dict(n=79, p=512, m=64, seed=5)


def test_engine_table_runs_on_the_cpu():
    """THROUGHPUT on the CPU (float32 products) against the CPU EXACT64
    goldens: the JAX package's THROUGHPUT bars, 4e-3 in LOD for the
    rotated scans (tests/test_bulkscan.py:138) and 2e-2 for the rest
    (tests/test_pallas_altgrid.py, tests/test_bulkperm.py)."""
    lines = []
    table = tf.engine_accuracy_table("cpu", log=lines.append)
    assert tuple(table) == tf.ENGINES and len(lines) == len(tf.ENGINES)
    assert all(np.isfinite(v) and v > 0 for v in table.values()), table
    assert max(table[k] for k in ("scan_null", "bulk_null_grid", "streamed")) <= 4e-3, table
    assert max(table.values()) <= 2e-2, table


def test_main_needs_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        tf.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_the_drivers_import_no_jax():
    code = ("import sys\n"
            "import bulklmm_tpu_torch.throughput_fwer, bulklmm_tpu_torch.biobank\n"
            "import bulklmm_tpu_torch.lowrank_cohort\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('bulklmm_tpu.')\n"
            "             or m == 'bulklmm_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
