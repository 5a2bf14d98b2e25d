"""The multi-trait missing-phenotype policy (COMPAT.md #18) of the port
against the JAX package: pattern groups, the lazy row and column views,
masked and dropped ``bulkscan`` and ``bulkscan_perms``, the refusals, and one
of the JAX package's randomized ``missing="mask"`` sweeps at its seeds.

Bars: EXACT64 1e-8 for null-grid and alt-grid (the same groups, each a
scan on its own rows, through the same float64 formulas), 1e-6 for
null-exact (Brent's tolerance window, test_torch_nullexact.py); masked
permutation maxima 1e-9 with the JAX package's shuffle indices passed in,
as tests/test_missing.py holds its own.
"""

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.models import missing as jmiss
from bulklmm_tpu.ops.bulkperm import permutation_indices as jax_permutation_indices
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.models import missing as tmiss
from test_property_sweep import _config

torch.set_num_threads(1)

BAR = {"null-grid": 1e-8, "alt-grid": 1e-8, "null-exact": 1e-6}


@pytest.fixture(scope="module")
def nan_data():
    """tests/test_missing.py's fixture: traits 0 and 1 share a pattern, 3 and
    5 have their own, the rest are complete."""
    rng = np.random.default_rng(11)
    n, p, m = 52, 40, 8
    G = rng.uniform(0, 1, (n, p))
    K = np.asarray(bl.calc_kinship(G))
    X = G - 0.5
    g_eff = X[:, 7][:, None] * rng.normal(0.9, 0.1, m)
    poly = rng.multivariate_normal(np.zeros(n), K, size=m).T
    Y = g_eff + 0.7 * poly + 0.5 * rng.normal(size=(n, m))
    Y[2:7, 0] = np.nan
    Y[2:7, 1] = np.nan
    Y[10:13, 3] = np.nan
    Y[[1, 20, 30], 5] = np.nan
    return G, Y, K


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(port, ref, fields, bar):
    for f in fields:
        a, b = _np(getattr(port, f)), _np(getattr(ref, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(np.isnan(a), np.isnan(b)), f
        assert np.nanmax(np.abs(a.astype(np.float64) - b.astype(np.float64))) <= bar, f


def test_missing_groups_partition(nan_data):
    _, Y, _ = nan_data
    finite = np.isfinite(Y)
    for drop in (False, True):
        tg, jg = tmiss.missing_groups(finite, drop=drop), jmiss.missing_groups(finite, drop=drop)
        assert len(tg) == len(jg)
        for (tr, tt), (jr, jt) in zip(tg, jg):
            assert np.array_equal(tr, jr) and np.array_equal(tt, jt)
    groups = tmiss.missing_groups(finite, drop=False)
    assert sorted(np.concatenate([t for _, t in groups])) == list(range(Y.shape[1]))
    for rows, traits in groups:
        for j in traits:
            assert np.array_equal(rows, np.flatnonzero(finite[:, j]))


def test_row_subset_view_and_col_out():
    G = np.arange(40.0).reshape(5, 8)
    rows = np.array([0, 2, 3])
    v = tmiss.RowSubsetView(G, rows)
    assert v.shape == (3, 8) and v.dtype == G.dtype
    assert np.array_equal(v[:, 2:5], G[rows][:, 2:5])
    assert np.array_equal(v[1], G[2]) and np.array_equal(np.asarray(v), G[rows])
    out = np.zeros((8, 6))
    traits = np.array([1, 4])
    co = tmiss.ColSubsetOut(out, traits)
    assert co.shape == (8, 2)
    co[2:5] = np.ones((3, 2))
    assert out[2:5][:, traits].sum() == 6 and out.sum() == 6
    assert np.array_equal(co[2:5], np.ones((3, 2)))


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_masked_bulkscan_matches_jax(nan_data, method):
    G, Y, K = nan_data
    kw = dict(method=method, missing="mask", output_pvals=True)
    ref = bl.bulkscan(Y, G, K, precision=jcfg.EXACT64, **kw)
    port = bt.bulkscan(Y, G, K, precision=bt.EXACT64, device="cpu", **kw)
    fields = ["L", "log10Pvals_mat"] + (["h2_panel"] if method == "alt-grid" else ["h2_null_list"])
    _same(port, ref, fields, BAR[method])
    assert ref.chisq_df == port.chisq_df == 1


def test_drop_mode(nan_data):
    G, Y, K = nan_data
    port = bt.bulkscan(Y, G, K, missing="drop", precision=bt.EXACT64, device="cpu")
    _same(port, bl.bulkscan(Y, G, K, missing="drop", precision=jcfg.EXACT64),
          ["L", "h2_null_list"], 1e-8)
    r = np.isfinite(Y).all(axis=1)
    sub = bt.bulkscan(Y[r], G[r], K[np.ix_(r, r)], precision=bt.EXACT64, device="cpu")
    assert torch.equal(port.L, sub.L)


def test_masked_effects_covariates_weights(nan_data):
    G, Y, K = nan_data
    rng = np.random.default_rng(3)
    covar = rng.normal(size=(Y.shape[0], 2))
    w = rng.uniform(0.5, 2.0, Y.shape[0])
    kw = dict(missing="mask", output_effects=True)
    ref = bl.bulkscan(Y, G, K, covar, weights=w, precision=jcfg.EXACT64, **kw)
    port = bt.bulkscan(Y, G, K, covar, weights=w, precision=bt.EXACT64, device="cpu", **kw)
    _same(port, ref, ["L", "h2_null_list", "beta_mat", "beta_se_mat"], 1e-8)
    # BALANCED: the effects variant of the LOD step on every group
    bal = bt.bulkscan(Y, G, K, covar, weights=w, precision=bt.BALANCED, device="cpu", **kw)
    assert np.max(np.abs(_np(bal.L) - _np(ref.L))) < 1e-4
    assert bal.beta_mat.dtype == torch.float32


def test_masked_decomposition_input(nan_data):
    """A cached decomposition is subset through its factors and each group
    decomposed anew."""
    G, Y, K = nan_data
    dec = bt.decompose_kinship(K, dtype=torch.float64, device="cpu")
    a = bt.bulkscan(Y, G, dec, missing="mask", precision=bt.EXACT64)
    b = bt.bulkscan(Y, G, K, missing="mask", precision=bt.EXACT64, device="cpu")
    assert torch.max((a.L - b.L).abs()) < 1e-9


def test_masked_bulkscan_perms_matches_jax(nan_data, tmp_path):
    """Each group draws the shuffle indices of its own n; the JAX package's
    are passed in as a function of n."""
    G, Y, K = nan_data
    nperms, seed = 16, 9
    ref = bl.bulkscan_perms(Y, G, K, nperms=nperms, rndseed=seed, missing="mask",
                            precision=jcfg.EXACT64)
    idx = lambda n: np.asarray(jax_permutation_indices(n, nperms, seed))  # noqa: E731
    port = bt.bulkscan_perms(Y, G, K, nperms=nperms, missing="mask", perm_idx=idx,
                             precision=bt.EXACT64, device="cpu")
    _same(port, ref, ["maxlods", "log10_adj_pvals", "h2_null_list", "sigma2_e_list"], 1e-9)
    assert port.nperms == nperms and port.original and torch.is_tensor(port.maxlods)
    # a checkpointed masked sweep keeps one subdirectory a pattern group and resumes
    ck = tmp_path / "ck"
    kw = dict(nperms=nperms, missing="mask", perm_idx=idx, precision=bt.EXACT64,
              device="cpu", checkpoint=str(ck))
    a = bt.bulkscan_perms(Y, G, K, **kw)
    names = sorted(d.name for d in ck.iterdir())
    assert names == [f"pattern_{i:03d}" for i in range(len(names))] and len(names) == 4
    b = bt.bulkscan_perms(Y, G, K, **kw)
    assert torch.equal(a.maxlods, port.maxlods) and torch.equal(b.maxlods, port.maxlods)


def test_degenerate_and_nan_side_inputs_refused(nan_data):
    G, Y, K = nan_data
    Yb = Y.copy()
    Yb[2:, 2] = np.nan  # trait 2: 2 observations left
    for call in (bl.bulkscan, lambda *a, **k: bt.bulkscan(*a, device="cpu", **k)):
        with pytest.raises(ValueError, match=r"trait\(s\) \[2\]"):
            call(Yb, G, K, missing="mask")
    Yall = Y.copy()
    Yall[np.arange(Y.shape[0]), np.arange(Y.shape[0]) % Y.shape[1]] = np.nan
    with pytest.raises(ValueError, match="drop"):
        bt.bulkscan(Yall, G, K, missing="drop", device="cpu")
    covar = np.ones((Y.shape[0], 1))
    covar[3, 0] = np.nan
    with pytest.raises(ValueError, match="covar"):
        bt.bulkscan(Y, G, K, covar, missing="mask", device="cpu")
    w = np.ones(Y.shape[0])
    w[4] = np.nan
    with pytest.raises(ValueError, match="weights"):
        bt.bulkscan_perms(Y, G, K, weights=w, nperms=4, missing="mask", device="cpu")


def test_complete_data_identical_to_error_mode(nan_data):
    G, Y, K = nan_data
    Yc = np.nan_to_num(Y, nan=0.0)
    for mode in ("mask", "drop"):
        a = bt.bulkscan(Yc, G, K, missing=mode, device="cpu")
        b = bt.bulkscan(Yc, G, K, device="cpu")
        assert torch.equal(a.L, b.L) and torch.equal(a.h2_null_list, b.h2_null_list)


def test_pattern_count_warning():
    rng = np.random.default_rng(5)
    n, p, m = 90, 6, 70
    G = rng.uniform(0, 1, (n, p))
    Y = rng.normal(size=(n, m))
    for j in range(m):
        Y[j, j] = np.nan
    with pytest.warns(UserWarning, match="missingness patterns"):
        tmiss.missing_groups(np.isfinite(Y), drop=False)


@pytest.mark.parametrize("seed", [61, 73, 89])
def test_masked_random_config_sweep(seed):
    """tests/test_property_sweep.py::test_masked_engines_match_complete_case_
    random_config at its seeds: random shapes, covariates, weights, REML and
    per-trait missingness; the port's masked null-grid (the complete-case
    h2 injected as the grid) and null-exact scans equal the JAX package's
    complete-case single-trait scans at that test's bars (1e-6, 5e-5)."""
    G, K, Y, covar, weights, reml = _config(seed)
    rng = np.random.default_rng(seed + 1000)
    Ym = np.asarray(Y, dtype=np.float64).copy()
    n, m = Ym.shape
    for j in range(m):
        if rng.integers(0, 2):
            k = int(rng.integers(1, max(2, n // 6)))
            Ym[rng.choice(n, size=k, replace=False), j] = np.nan
    h2s, lods = [], []
    for j in range(m):
        r = np.isfinite(Ym[:, j])
        res = bl.scan(Ym[r, j], G[r], K[np.ix_(r, r)], None if covar is None else covar[r],
                      weights=None if weights is None else weights[r], reml=reml)
        h2s.append(float(res.h2_null))
        lods.append(np.asarray(res.lod))
    ok = [j for j in range(m) if h2s[j] < 0.999]  # as the JAX test: no boundary fits
    if not ok:
        pytest.skip("all traits hit the h2=1 boundary for this seed")
    kw = dict(weights=weights, reml=reml, missing="mask", precision=bt.EXACT64, device="cpu")
    res = bt.bulkscan(Ym, G, K, covar, method="null-grid",
                      h2_grid=np.asarray(sorted({h2s[j] for j in ok})), **kw)
    res2 = bt.bulkscan(Ym, G, K, covar, method="null-exact", **kw)
    for j in ok:
        np.testing.assert_allclose(res.L[:, j].numpy(), lods[j], atol=1e-6,
                                   err_msg=f"seed={seed} trait={j}")
        np.testing.assert_allclose(res2.L[:, j].numpy(), lods[j], atol=5e-5,
                                   err_msg=f"seed={seed} trait={j}")
