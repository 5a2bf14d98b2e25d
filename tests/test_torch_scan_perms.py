"""The single-trait permutation scan and the small modules of its slice:
``scan_perms_lite``, ``scan(permutation_test=True)``, ``transform_reweight``,
``transform_permute``, ``shuffle_vector``, ``wls_multivar`` / ``resid`` /
``rss``, the column helpers, ``bh_adjust`` / ``lod_fdr``, and the exports,
against the JAX package on the CPU, fed the same numpy inputs and the JAX
package's shuffle indices (``perm_idx=``).

Bars:

- h2 of the null model (the host float64 fit): equal.
- EXACT64 permutation columns and the observed column: 1e-9 (float64 in
  both, summed in other orders); BALANCED, MIXED, FAST32, THROUGHPUT:
  ``test_torch_bulkscan.py``'s preset bars (1e-4, 1e-4, 1e-3, 1e-3).
- ``transform_reweight``: its h2 comes from the device Brent in both
  packages, held to Brent's window (3e-8, ``test_torch_nullexact.py``);
  the weighted residual and markers to 1e-6, since they move with h2.
- ``wls_multivar``, ``resid``, ``rss`` and the column helpers: 1e-10.
- ``bh_adjust`` and ``lod_fdr``: exactly equal (the same numpy and scipy
  operations), NaN where the JAX package has NaN.
"""

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.ops import stats as jstats
from bulklmm_tpu.ops.bulkperm import permutation_indices as jax_permutation_indices
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.ops import stats
from bulklmm_tpu_torch.ops.bulkperm import permutation_indices

torch.set_num_threads(1)

L_BAR = {"EXACT64": 1e-9, "MIXED": 1e-4, "BALANCED": 1e-4, "FAST32": 1e-3, "THROUGHPUT": 1e-3}
WINDOW = 2 * (np.finfo(np.float64).eps ** 0.5 + np.finfo(np.float64).eps)
NPERMS, SEED = 24, 5

#: names of the JAX package's __all__ the port still lacks; it may only shrink
NOT_PORTED = frozenset({
    "io", "parallel",
    "read_bxd_geno", "read_bxd_pheno", "read_geno_prob", "read_geno_prob_exclude_complements",
    "read_gmap", "read_helium_matrix", "read_phenocovar", "write_to_file",
    "bulkscan_loco", "bulkscan_perms_loco", "loco_kinship", "scan_loco",
})


def _np(x):
    return x.double().numpy() if torch.is_tensor(x) else np.asarray(x, dtype=np.float64)


def _maxdiff(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.fixture(scope="module")
def data(bxd_like):
    d = dict(bxd_like)
    d["y"] = bxd_like["Y"][:, 6].copy()  # null h2 inside (0, 1)
    d["covar"] = np.random.default_rng(12).normal(size=(d["n"], 2))
    d["idx"] = np.asarray(jax_permutation_indices(d["n"], NPERMS, SEED))
    return d


_JAX = {}


def _jax_lite(data, key, **kw):
    if key not in _JAX:
        _JAX[key] = bl.scan_perms_lite(
            data["y"], data["G"], kw.pop("covar", np.ones((data["n"], 0))), data["K"],
            nperms=NPERMS, rndseed=SEED, **kw,
        )
    return _JAX[key]


def _port_lite(data, **kw):
    return bt.scan_perms_lite(
        data["y"], data["G"], kw.pop("covar", np.ones((data["n"], 0))), data["K"],
        nperms=NPERMS, perm_idx=data["idx"], device="cpu", **kw,
    )


def _check(port, ref, preset="EXACT64"):
    assert float(port.h2_null) == float(ref.h2_null)
    assert float(port.sigma2_e) == float(ref.sigma2_e)
    assert tuple(port.L_perms.shape) == (port.lod.shape[0], NPERMS)
    assert _maxdiff(port.L_perms, ref.L_perms) <= L_BAR[preset]
    assert _maxdiff(port.lod, ref.lod) <= L_BAR[preset]


@pytest.mark.parametrize("preset", list(L_BAR))
def test_scan_perms_lite_presets(data, preset):
    ref = _jax_lite(data, f"lite-{preset}", precision=getattr(jcfg, preset))
    port = _port_lite(data, precision=bt.precision_by_name(preset))
    assert str(port.L_perms.dtype) == "torch." + str(np.asarray(ref.L_perms).dtype)
    _check(port, ref, preset)


@pytest.mark.parametrize("option", ["covariates", "reml", "pvals"])
def test_scan_perms_lite_options(data, option):
    kw = {"covariates": dict(covar=data["covar"]), "reml": dict(reml=True),
          "pvals": dict(output_pvals=True, prior_variance=0.0)}[option]
    ref = _jax_lite(data, f"lite-{option}", precision=jcfg.EXACT64, **dict(kw))
    port = _port_lite(data, precision=bt.EXACT64, **dict(kw))
    _check(port, ref)
    if option == "pvals":
        assert _maxdiff(port.log10pvals, ref.log10pvals) <= 1e-9
        assert _maxdiff(port.log10Pvals_perms, ref.log10Pvals_perms) <= 1e-9


def test_scan_permutation_test_matches_jax_and_lite(data):
    """scan(permutation_test=True) against the JAX package's, with
    effects; and equal to scan_perms_lite given the same prior and indices,
    its column 0 the null scan's LODs."""
    kw = dict(permutation_test=True, nperms=NPERMS, rndseed=SEED, prior_variance=1.0,
              output_effects=True)
    ref = bl.scan(data["y"], data["G"], data["K"], precision=jcfg.EXACT64, **kw)
    kw.pop("rndseed")
    port = bt.scan(data["y"], data["G"], data["K"], precision=bt.EXACT64, perm_idx=data["idx"],
                   device="cpu", **kw)
    _check(port, ref)
    assert _maxdiff(port.beta, ref.beta) <= 1e-9
    lite = _port_lite(data, precision=bt.EXACT64, prior_variance=1.0)
    assert torch.equal(lite.L_perms, port.L_perms) and torch.equal(lite.lod, port.lod)
    null = bt.scan(data["y"], data["G"], data["K"], precision=bt.EXACT64, prior_variance=1.0,
                   device="cpu")
    assert _maxdiff(port.lod, null.lod) <= 1e-9


def test_own_generator_is_seeded_and_shared_with_bulkscan_perms(data):
    """Without perm_idx the shuffles are permutation_indices(n, nperms,
    rndseed): the same as passing those indices, and as bulkscan_perms'."""
    a = bt.scan_perms_lite(data["y"], data["G"], np.ones((data["n"], 0)), data["K"],
                           nperms=NPERMS, rndseed=3, device="cpu", precision=bt.EXACT64)
    b = bt.scan_perms_lite(data["y"], data["G"], np.ones((data["n"], 0)), data["K"],
                           nperms=NPERMS, device="cpu", precision=bt.EXACT64,
                           perm_idx=permutation_indices(data["n"], NPERMS, 3))
    assert torch.equal(a.L_perms, b.L_perms)
    bulk = bt.bulkscan_perms(data["y"][:, None], data["G"], data["K"], nperms=NPERMS, rndseed=3,
                             method="null-exact", precision=bt.EXACT64, device="cpu")
    # the bulk engine fits h2 by its own Brent, so its maxima agree to h2's window
    assert _maxdiff(bulk.maxlods[0, 1:], a.L_perms.max(0).values) <= 1e-6


def test_monomorphic_marker_gives_zero_not_nan(data):
    G2 = np.array(data["G"], copy=True)
    G2[:, 5] = 0.5  # collinear with the intercept
    res = bt.scan(data["y"], G2, data["K"], permutation_test=True, nperms=NPERMS,
                  perm_idx=data["idx"], precision=bt.EXACT64, device="cpu")
    assert bool(torch.isfinite(res.L_perms).all()) and bool(torch.isfinite(res.lod).all())
    assert bool((res.L_perms[5] == 0).all()) and float(res.lod[5]) == 0.0
    thr = bt.get_thresholds(res.L_perms, [0.10, 0.05])
    assert np.isfinite(np.asarray(thr.thrs)).all()


# --- transforms ------------------------------------------------------------------


def test_transform_reweight_and_permute(data):
    from bulklmm_tpu.ops.rotation import transform_permute as jax_permute
    from bulklmm_tpu.ops.rotation import transform_reweight as jax_reweight

    lam, U = np.linalg.eigh(data["K"])
    C = np.concatenate([np.ones((data["n"], 1)), data["covar"]], 1)
    y0, X0 = U.T @ data["y"][:, None], U.T @ np.concatenate([C, data["G"]], 1)
    kw = dict(n_covars=3, prior_a=1.0, prior_b=2.0)
    ref = jax_reweight(y0, X0, lam, **kw)
    port = bt.transform_reweight(*(torch.from_numpy(a) for a in (y0, X0, lam)), **kw)
    assert abs(float(port.h2_null) - float(ref.h2_null)) <= WINDOW
    assert _maxdiff(port.r0, ref.r0) <= 1e-6 and _maxdiff(port.X00, ref.X00) <= 1e-6
    assert abs(float(port.sigma2_e) - float(ref.sigma2_e)) <= 1e-6
    with pytest.raises(ValueError, match="single-trait"):
        bt.transform_reweight(torch.zeros((data["n"], 2)), torch.from_numpy(X0), torch.from_numpy(lam))

    r0 = np.array(ref.r0)
    want = np.asarray(jax_permute(r0, nperms=NPERMS, rndseed=SEED))
    got = bt.transform_permute(torch.from_numpy(r0), nperms=NPERMS, perm_idx=data["idx"])
    assert np.array_equal(got.numpy(), want)
    own = bt.transform_permute(torch.from_numpy(r0), nperms=NPERMS, rndseed=SEED, original=False)
    assert tuple(own.shape) == (data["n"], NPERMS)
    assert np.allclose(np.sort(own.numpy(), 0), np.sort(np.repeat(r0, NPERMS, 1), 0))
    with pytest.raises(ValueError, match="positive integer"):
        bt.transform_permute(torch.from_numpy(r0), nperms=0, original=False)


@pytest.mark.parametrize("original", [True, False])
def test_shuffle_vector_draws_through_permutation_indices(original):
    x = torch.arange(10.0) * 3
    out = stats.shuffle_vector(7, x, 5, original=original)
    idx = permutation_indices(10, 5, 7, original=original)
    assert torch.equal(out, x[idx].T)
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(stats.shuffle_vector(gen, x, 5, original=original), out)
    assert tuple(out.shape) == (10, 5 + original)
    if original:
        assert torch.equal(out[:, 0], x)


# --- small ops -------------------------------------------------------------------


@pytest.mark.parametrize("method", ["qr", "cholesky"])
def test_wls_multivar_resid_rss(data, method):
    from bulklmm_tpu.ops.wls import resid as jresid, rss as jrss, wls_multivar as jwm

    rng = np.random.default_rng(4)
    n = data["n"]
    X = np.concatenate([np.ones((n, 1)), data["covar"]], 1)
    Y = data["Y"][:, :4]
    w = rng.uniform(0.3, 2.0, n)
    t = [torch.from_numpy(a) for a in (Y, X, w)]
    a = bt.wls_multivar(*t, (1.0, 2.0), reml=True, method=method)
    b = jwm(Y, X, w, (1.0, 2.0), reml=True, method=method)
    for f in ("b", "sigma2", "ell", "rss"):
        assert _maxdiff(getattr(a, f), getattr(b, f)) <= 1e-10, f
    for yy in (Y, Y[:, 0]):
        assert _maxdiff(bt.resid(torch.from_numpy(yy), t[1], method=method),
                        jresid(yy, X, method=method)) <= 1e-10
        assert _maxdiff(bt.rss(torch.from_numpy(yy), t[1], method=method),
                        jrss(yy, X, method=method)) <= 1e-10
    with pytest.raises(ValueError, match="unknown method"):
        bt.resid(t[0], t[1], method="svd")


def test_column_helpers(data):
    A = data["Y"][:, :5]
    x = np.linspace(0.5, 2.5, A.shape[0])
    v = np.linspace(1.0, 3.0, A.shape[1])
    At = torch.from_numpy(A)
    pairs = [
        (stats.col_center(At), jstats.col_center(A)),
        (stats.row_center(At), jstats.row_center(A)),
        (stats.col_divide(At, v), jstats.col_divide(A, v)),
        (stats.row_divide(At, x), jstats.row_divide(A, x)),
        (stats.row_multiply(At, x), jstats.row_multiply(A, x)),
        (stats.col_standardize(At), jstats.col_standardize(A)),
    ]
    for got, want in pairs:
        assert _maxdiff(got, want) <= 1e-10
    with pytest.raises(ValueError, match="Dividing by zeros"):
        stats.col_divide(At, np.r_[v[:-1], 0.0])
    with pytest.raises(ValueError, match="Dividing by zeros"):
        stats.row_divide(At, torch.zeros(A.shape[0], dtype=torch.float64))
    with pytest.raises(ValueError, match="Dividing by zeros"):
        stats.col_standardize(torch.ones((6, 2), dtype=torch.float64))


# --- FDR ---------------------------------------------------------------------------


@pytest.mark.parametrize("dependent", [False, True])
def test_bh_adjust_and_lod_fdr_equal_jax(dependent):
    from bulklmm_tpu.analysis.fdr import bh_adjust as jbh, lod_fdr as jfdr

    rng = np.random.default_rng(9)
    p = rng.uniform(size=(40, 3))
    p[[2, 17], [0, 2]] = np.nan
    assert np.array_equal(bt.bh_adjust(p, dependent=dependent), jbh(p, dependent=dependent),
                          equal_nan=True)
    L = rng.exponential(1.5, size=(50, 4))
    L[3, 1] = np.nan
    q, sig = bt.lod_fdr(torch.from_numpy(L), 1, alpha=0.1, dependent=dependent)
    qj, sigj = jfdr(L, 1, alpha=0.1, dependent=dependent)
    assert np.array_equal(q, qj, equal_nan=True) and np.array_equal(sig, sigj)
    assert np.isnan(bt.bh_adjust(np.full(3, np.nan))).all()


# --- exports ---------------------------------------------------------------------


def test_exports_only_shrink():
    """What of the JAX package's public surface the port lacks: exactly the
    names still to port. Porting one of them removes it from the set."""
    lacking = {n for n in bl.__all__ if not hasattr(bt, n)}
    assert lacking == NOT_PORTED
    assert len(bl.__all__) - len(lacking) == 45
    for name in ("fit_lmm", "gridbrent", "make_weights", "r2lod", "p2lod", "lod2p", "wls"):
        assert callable(getattr(bt, name)), name
    assert set(bt.__all__) <= set(dir(bt))
    from bulklmm_tpu_torch.ops import wls as wls_module

    assert bt.wls is wls_module.wls  # the function at the top, the module under ops
