"""The frozen reference against the port on the wide LOD kernel's route
(more than 3 covariate columns) at a tiny size on the CPU: the null-grid
``bulkscan`` of ``gtex_muscle.scan``'s data with 12 and 20 covariate
columns (20 past ``ops/wls.py::UNROLLED_COLUMNS``: the null grid's batched
factorization), the plain EXACT64 path to float64 rounding and BALANCED's
route (the wide operands V = W C L^-T and the kernel's plain version) to
float32's; and a whole run of the cell at that size is correct, and comes
out false under each of ``test_pb_faults.py``'s faults (that file's own
cases of the cell run at the configuration's 69 columns, which its tiny
size of 30 samples cannot hold)."""

from __future__ import annotations

import time

import pytest
import torch

import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
from portbench.core import cell
from portbench.reference.lmm import LMM
from portbench.tests.conftest import tiny
from portbench.tests.test_pb_faults import _alter_where_produced, _half, _stale, _wrong_h2


@pytest.fixture(scope="module", params=[12, 20])
def case(request):
    c = tiny("gtex_muscle.scan", covariates=request.param)
    d = cell.Data(c, 2**31 + 21, "cpu")
    ref = LMM(d.K_host, d.G, d.covar, c.config["h2_grid"])
    return c, d, ref


def _reference_lods(ref, Y, h2):
    Y0 = ref.rotate(Y)
    L = torch.empty((ref.X0.shape[1], Y.shape[1]), dtype=torch.float64)
    for cols, block in ref.lods(Y0, h2.to(torch.float64)):
        L[:, cols] = block
    return L


@pytest.mark.parametrize("precision, atol", [(bt.EXACT64, 1e-10), (bt.BALANCED, 2e-4)],
                         ids=["EXACT64", "BALANCED"])
def test_null_grid_scan_with_wide_covariates(case, precision, atol):
    c, d, ref = case
    assert d.covar.shape == (c.config["n"], c.config["covariates"] - 1)
    assert lf.kernel_path(c.config["n"], c.config["covariates"]) == "wide"
    Y = d.panel(0)
    res = bt.bulkscan(Y, d.G, d.K_host, d.covar, method="null-grid", precision=precision,
                      h2_grid=c.config["h2_grid"], device="cpu")
    _, h2, _ = ref.grid_fit(ref.rotate(Y))
    assert torch.equal(h2, res.h2_null_list.to(h2.dtype))
    L = _reference_lods(ref, Y, h2)
    assert torch.allclose(L, res.L.to(torch.float64), rtol=0, atol=atol)


def test_a_run_on_the_wide_route_is_correct(case):
    c, _, _ = case
    line = cell.run(c, 2**31 + 99, 0.6, False, "cpu", time.time())
    assert line["attempted"] >= 3 and line["failed"] == 0
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["altered", "stale", "half", "wrong_h2"])
def test_a_broken_program_on_the_wide_route_is_not_correct(monkeypatch, case, fault):
    c, _, _ = case
    if fault == "altered":
        _alter_where_produced(monkeypatch, c.traffic["kind"])
    elif fault == "stale":
        _stale(monkeypatch, c.traffic["entry"])
    elif fault == "half":
        _half(monkeypatch, c.traffic["entry"])
    else:
        _wrong_h2(monkeypatch)
    line = cell.run(c, 2**31 + 99, 0.6, False, "cpu", time.time())
    assert line["attempted"] >= 3 and line["failed"] == 0
    assert not line["correct"], line["checks"]
    assert any(v["value"] > v["limit"] for v in line["checks"].values())
