"""The frozen reference against the port's CPU EXACT64 path at a tiny size,
for each entry point the cells drive: the two agree to float64 rounding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bulklmm_tpu_torch as bt
from portbench.core import cell, data
from portbench.reference.lmm import LMM
from portbench.tests.conftest import tiny


@pytest.fixture(scope="module", params=[None, 2])
def case(request):
    """Tiny data drawn by the harness; with ``covariates=3`` two covariates
    beside the intercept."""
    extra = {} if request.param is None else {"covariates": 3}
    c = tiny("bxd.perms", **extra)
    d = cell.Data(c, 2**31 + 7, "cpu")
    ref = LMM(d.K_host, d.G, d.covar, c.config["h2_grid"])
    return c, d, ref


def _exact64(c):
    return dict(precision=bt.EXACT64, h2_grid=c.config["h2_grid"], device="cpu")


def test_null_grid_scan(case):
    c, d, ref = case
    Y = d.panel(0)
    res = bt.bulkscan(Y, d.G, d.K_host, d.covar, method="null-grid", **_exact64(c))
    Y0 = ref.rotate(Y)
    _, h2, _ = ref.grid_fit(Y0)
    assert torch.equal(h2, res.h2_null_list.to(h2.dtype))
    L = torch.empty_like(res.L)
    for cols, block in ref.lods(Y0, h2):
        L[:, cols] = block
    assert torch.allclose(L, res.L, rtol=0, atol=1e-10)


def test_alt_grid_scan(case):
    c, d, ref = case
    Y = d.panel(1)
    res = bt.bulkscan(Y, d.G, d.K_host, d.covar, method="alt-grid", engine="xla", **_exact64(c))
    L, k, best, short = ref.alt_grid(ref.rotate(Y), torch.zeros_like(res.L, dtype=torch.int64))
    assert torch.allclose(L, res.L, rtol=0, atol=1e-10)
    assert torch.equal(ref.grid[k], res.h2_panel)
    assert bool((short >= 0).all()) and bool((short[k == 0] == 0).all())


def test_permutation_maxima(case):
    c, d, ref = case
    Y = d.panel(0)
    idx = d.shuffles(5)
    res = bt.bulkscan_perms(Y, d.G, d.K_host, d.covar, nperms=idx.shape[0] - 1, perm_idx=idx,
                            engine="xla", **_exact64(c))
    Y0 = ref.rotate(Y)
    got = ref.perm_maxlods(Y0, res.h2_null_list, idx)
    assert torch.allclose(got, res.maxlods, rtol=0, atol=1e-10)
    assert torch.allclose(got[:, 0], ref_observed(ref, Y0, res.h2_null_list), rtol=0, atol=1e-12)


def ref_observed(ref, Y0, h2):
    """Column 0 of the maxima is the observed scan's largest LOD."""
    L = torch.empty((ref.X0.shape[1], Y0.shape[1]), dtype=ref.dtype)
    for cols, block in ref.lods(Y0, h2):
        L[:, cols] = block
    return L.max(0).values


def test_shuffles_are_permutations_led_by_the_identity():
    idx = data.shuffles(50, 30, 2**33 + 1, 4, "cpu")
    assert idx.shape == (31, 50)
    assert torch.equal(idx[0], torch.arange(50))
    assert torch.equal(idx.sort(1).values, torch.arange(50).expand(31, 50))
    assert torch.equal(idx, data.shuffles(50, 30, 2**33 + 1, 4, "cpu"))
    assert not torch.equal(idx, data.shuffles(50, 30, 2**33 + 1, 5, "cpu"))


def test_data_is_drawn_from_the_seed():
    c = tiny("biobank.scan")
    a, b = cell.Data(c, 11, "cpu"), cell.Data(c, 11, "cpu")
    assert torch.equal(a.G, b.G) and np.array_equal(a.K_host, b.K_host)
    assert all(torch.equal(x, y) for x, y in zip(a.panels, b.panels))
    other = cell.Data(c, 12, "cpu")
    assert not torch.equal(a.G, other.G)
    assert a.G.shape == (30, 64) and float(a.G.min()) >= 0 and float(a.G.max()) <= 1
    assert np.allclose(np.diag(a.K_host), 1.0)
    np.linalg.cholesky(a.K_host)  # positive definite
