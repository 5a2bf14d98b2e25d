"""The cohort driver (``bulklmm_tpu_torch/lowrank_cohort.py``) against
``benchmarks/lowrank_cohort.py`` on the CPU: its flags and metric names,
the cohort's recipe, and the rank-k against full-rank comparison at a small
size against the JAX package's ``bulkscan`` on the same numpy arrays and
the same factors. The cohort is drawn from a torch generator, not
``jax.random``, so the two packages share the arrays through numpy here.
The card runs the driver at n = 5,000 (``chip_smoke.py`` phase 18) and at
the JAX script's 20,000 x 50,000 x 2,000.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch import lowrank_cohort as lc

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parent.parent / "benchmarks" / "lowrank_cohort.py"
N, P, M, K_RANK = 150, 400, 12, 24
#: max |dLOD|, the port against the JAX package under EXACT64 on the same
#: factors: tests/test_torch_lowrank.py's EXACT64 bar
BAR = 1e-8


@pytest.fixture(scope="module")
def run():
    G, Y = lc.cohort(N, P, M, device="cpu")
    lines = []
    out = lc.drive(G, Y, K_RANK, compare_full=True, all_methods=True, precision=bt.EXACT64,
                   log=lines.append)
    return G, Y, out, [json.loads(line) for line in lines]


def test_flags_are_the_jax_scripts():
    src = SCRIPT.read_text()
    theirs = re.findall(r'add_argument\("(--[\w-]+)"(?:, type=int, default=(\d+))?', src)
    assert [t[0] for t in theirs] == ["--n", "--p", "--m", "--k", "--compare-full", "--all-methods"]
    assert [int(t[1]) for t in theirs[:4]] == [20000, 50000, 2000, 2048]


def test_main_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        lc.main(["--n", "20000", "--p", "50000", "--m", "2000", "--k", "2048", "--compare-full",
                 "--all-methods"])


def test_metric_names_are_the_jax_scripts(run):
    src = SCRIPT.read_text()
    names = [line["metric"] for line in run[3]]
    assert names == [
        "lowrank_construct_first_incl_compile", "lowrank_construct_from_geno",
        "lowrank_bulkscan_compile_first", "lowrank_bulkscan_null_grid",
        "lowrank_null-exact_compile_first", "lowrank_bulkscan_null_exact",
        "lowrank_alt-grid_compile_first", "lowrank_bulkscan_alt_grid",
        "lowrank_perms_compile_first", "lowrank_scan_perms_1024",
        "full_host_eigh_plus_upload", "full_bulkscan_compile_first", "full_bulkscan_null_grid",
        "lowrank_vs_full_fidelity"]
    literal = set(re.findall(r'"((?:lowrank|full)_[a-z_0-9]+)"', src))
    assert literal <= set(names) | {"lowrank_bulkscan_{meth.replace('-', '_')}"}
    assert {"lowrank_construct_from_geno", "lowrank_bulkscan_null_grid", "full_bulkscan_null_grid",
            "full_host_eigh_plus_upload", "lowrank_vs_full_fidelity",
            "lowrank_scan_perms_1024"} <= literal
    fid = run[3][-1]
    assert list(fid) == ["metric", "h2_grid_agreement", "same_h2_max_absL", "overall_p99_absL",
                         "overall_max_absL", "note"]
    assert all(k in src for k in fid if k != "metric")
    assert all(line["unit"] == "s" and line["value"] >= 0 for line in run[3][:-1])


def test_cohort_follows_the_recipe():
    src = SCRIPT.read_text()
    assert "(n, 8)" in src and "jax.nn.sigmoid(\n        0.5 * jnp.matmul" in src
    G, Y = lc.cohort(300, 2000, 5, device="cpu")
    G2, _ = lc.cohort(300, 2000, 5, device="cpu")
    assert torch.equal(G, G2) and G.dtype == Y.dtype == torch.float32
    assert set(torch.unique(G).tolist()) == {0.0, 1.0}
    # the kinship's spectrum: the constant 0.5 and the 8 ancestry directions
    # stand above the rest
    lam = np.linalg.eigvalsh(bt.calc_kinship(G, bt.EXACT64, device="cpu").numpy())[::-1]
    assert lam[8] > 3 * lam[9]
    assert abs(float(Y.mean())) < 0.1 and abs(float(Y.std()) - 1) < 0.1


def test_full_and_lowrank_scans_match_the_jax_package(run):
    G, Y, out, _ = run
    Gn, Yn = G.numpy(), Y.numpy()
    lr = bl.LowRankKinship(U=out["lr"].U.numpy(), lam=out["lr"].lam.numpy())
    ref_lr = bl.bulkscan(Yn, Gn, lr, precision=jcfg.EXACT64)
    ref_fu = bl.bulkscan(Yn, Gn, bl.decompose_kinship(np.asarray(bl.calc_kinship(Gn))),
                         precision=jcfg.EXACT64)
    assert np.max(np.abs(out["lowrank"].L.numpy() - np.asarray(ref_lr.L))) <= BAR
    assert np.max(np.abs(out["full"].L.numpy() - np.asarray(ref_fu.L))) <= BAR
    assert out["decomp"].Ut.dtype == torch.float64  # the preset's solve dtype
    ref = lc.fidelity(np.asarray(ref_lr.L), np.asarray(ref_lr.h2_null_list), np.asarray(ref_fu.L),
                      np.asarray(ref_fu.h2_null_list), k=K_RANK, n=N)
    for key, value in ref.items():
        if isinstance(value, float):
            assert out["fidelity"][key] == pytest.approx(value, abs=1e-6 + BAR), key
        else:
            assert out["fidelity"][key] == value
    assert out["fidelity"]["note"] == f"k={K_RANK} of n={N}"


def test_fidelity_arithmetic():
    L_lr = np.array([[1.0, 2.0, 3.0], [0.5, 0.0, 1.0]])
    L_fu = L_lr + np.array([[0.01, 0.5, 0.0], [0.02, -0.1, 0.0]])
    f = lc.fidelity(L_lr, [0.1, 0.2, 0.3], L_fu, [0.1, 0.3, 0.3], k=2, n=9)
    assert f["h2_grid_agreement"] == round(2 / 3, 4)
    assert f["same_h2_max_absL"] == 0.02 and f["overall_max_absL"] == 0.5
    assert f["overall_p99_absL"] == round(float(np.quantile(np.abs(L_lr - L_fu), 0.99)), 6)
    assert np.isnan(lc.fidelity(L_lr, [0.0] * 3, L_fu, [0.1] * 3, k=2, n=9)["same_h2_max_absL"])
