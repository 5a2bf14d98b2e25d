"""The single-trait scan: ``bulklmm_tpu_torch.scan`` (null, alt, effects,
p-values, weights, missing values, the profile likelihood) and the host
float64 null fit, against the JAX package on the ``bxd_like`` fixture, fed
the same numpy inputs, on the CPU.

Bars:

- h2 of the null model (the host float64 fit, ``ops/hostfit.py``): equal,
  and so are its coefficients, sigma2 and ell: the same numpy operations in
  the same order.
- EXACT64 null LODs, effects, standard errors, p-values and profile
  likelihoods: 1e-9 (both packages in float64, summed in other orders).
- Alt h2 per marker: 3e-7, on every trait of the fixture. Both packages
  minimize the same likelihood by Brent, whose window (3e-8,
  ``test_torch_nullexact.py``) would hold on a curved objective; but around
  many markers' optima the likelihood is flat to its last bits over a wider
  range than the window, so the two Brent runs, whose objectives round
  differently, stop at different points of equal likelihood.
- Alt LODs and effects: 1e-6. Under ML the LOD is the likelihood at the
  optimum, where h2's spread does not show; under REML and
  ``compat_sqrt_weights`` it is an ML likelihood at the REML h2, which
  moves with it.
- BALANCED, MIXED, FAST32 and THROUGHPUT: ``test_torch_bulkscan.py``'s
  preset bars (1e-4, 1e-4, 1e-3, 1e-3).
"""

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.ops.bulkperm import permutation_indices as jax_permutation_indices
from bulklmm_tpu.ops.hostfit import fit_lmm_host as jax_fit_lmm_host
from bulklmm_tpu.ops.lowrank import LowRankKinship
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.ops.hostfit import fit_lmm_host
from bulklmm_tpu_torch.ops.wls import wls, wls_ell_markers

torch.set_num_threads(1)

L_BAR = {"EXACT64": 1e-9, "MIXED": 1e-4, "BALANCED": 1e-4, "FAST32": 1e-3, "THROUGHPUT": 1e-3}
ALT_H2_BAR = 3e-7
ALT_BAR = 1e-6
TRAIT = 6  # null h2 inside (0, 1) on this fixture


def _np(x):
    return x.double().numpy() if torch.is_tensor(x) else np.asarray(x, dtype=np.float64)


def _maxdiff(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


@pytest.fixture(scope="module")
def data(bxd_like):
    d = dict(bxd_like)
    rng = np.random.default_rng(11)
    d["y"] = bxd_like["Y"][:, TRAIT].copy()
    d["covar"] = rng.normal(size=(d["n"], 2))
    d["weights"] = rng.uniform(0.5, 2.0, d["n"])
    y_nan = d["y"].copy()
    y_nan[[3, 17, 40]] = np.nan
    d["y_nan"] = y_nan
    return d


_JAX = {}


def _jax(data, key, y=None, **kw):
    """The JAX package's scan, once per distinct call in this module."""
    if key not in _JAX:
        _JAX[key] = bl.scan(data["y"] if y is None else y, data["G"], data["K"], **kw)
    return _JAX[key]


def _port(data, y=None, K=None, **kw):
    return bt.scan(data["y"] if y is None else y, data["G"], data["K"] if K is None else K,
                   device="cpu", **kw)


# --- the host float64 null fit -------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(reml=True), dict(prior=(0.8, 3.0)),
                                dict(optim_interval=4), dict(covar=True)],
                         ids=["ml", "reml", "prior", "intervals", "covariates"])
def test_fit_lmm_host_is_bit_identical(data, kw):
    kw = dict(kw)
    lam, U = np.linalg.eigh(data["K"])
    C = np.ones((data["n"], 1))
    if kw.pop("covar", False):
        C = np.concatenate([C, data["covar"]], 1)
    y0, C0 = U.T @ data["y"][:, None], U.T @ C
    prior = kw.pop("prior", (0.0, 0.0))
    a = fit_lmm_host(y0, C0, lam, prior, **kw)
    b = jax_fit_lmm_host(y0, C0, lam, prior, **kw)
    assert np.array_equal(a.b, b.b)
    assert (a.h2, a.sigma2, a.ell) == (b.h2, b.sigma2, b.ell)


def test_all_zero_trait_degenerate_fit(data):
    """An all-zero phenotype fits without raising (sigma2 floored), and
    both entry points return their shapes."""
    n, p = data["n"], data["p"]
    res = _port(data, y=np.zeros(n))
    assert tuple(res.lod.shape) == (p,)
    lite = bt.scan_perms_lite(np.zeros(n), data["G"], np.ones((n, 0)), data["K"], nperms=4,
                              device="cpu")
    assert tuple(lite.L_perms.shape) == (p, 4)
    ref = bl.scan(np.zeros(n), data["G"], data["K"], precision=jcfg.EXACT64)
    assert float(res.h2_null) == float(ref.h2_null)


# --- null scan -----------------------------------------------------------------


def _check_null(port, ref, preset="EXACT64"):
    assert float(port.h2_null) == float(ref.h2_null)
    assert float(port.sigma2_e) == float(ref.sigma2_e)
    assert port.sigma2_e.ndim == 0 and port.h2_null.ndim == 0
    assert _maxdiff(port.lod, ref.lod) <= L_BAR[preset]


def test_null_scan_with_effects_and_pvals(data):
    kw = dict(precision=jcfg.EXACT64, output_effects=True, output_pvals=True)
    ref = _jax(data, "null-full", **kw)
    port = _port(data, precision=bt.EXACT64, output_effects=True, output_pvals=True)
    _check_null(port, ref)
    assert port.lod.dtype == torch.float64 and tuple(port.lod.shape) == (data["p"],)
    for f in ("beta", "beta_se", "log10pvals"):
        assert _maxdiff(getattr(port, f), getattr(ref, f)) <= 1e-9, f
    assert int(torch.argmax(port.lod)) == int(np.argmax(np.asarray(ref.lod)))


@pytest.mark.parametrize("form", ["matrix_y", "cached", "handmade", "tensors"])
def test_null_scan_input_forms(data, form):
    """The same scan from a (n, 1) y, a cached decomposition, a hand-built
    one without host factors, and CPU tensors: the same h2 and LODs."""
    ref = _jax(data, "null-full", precision=jcfg.EXACT64, output_effects=True, output_pvals=True)
    y, G, K = data["y"], data["G"], data["K"]
    if form == "matrix_y":
        port = bt.scan(y[:, None], G, K, precision=bt.EXACT64, device="cpu")
    elif form == "cached":
        dec = bt.decompose_kinship(K, dtype=torch.float64, device="cpu")
        port = bt.scan(y, G, dec, precision=bt.EXACT64)
    elif form == "handmade":
        full = bt.decompose_kinship(K, dtype=torch.float64, device="cpu")
        port = bt.scan(y, G, bt.KinshipDecomposition(Ut=full.Ut, lam=full.lam), precision=bt.EXACT64)
    else:
        port = bt.scan(torch.from_numpy(y), torch.from_numpy(G), K, precision=bt.EXACT64)
        assert port.lod.device.type == "cpu"
    _check_null(port, ref)


@pytest.mark.parametrize("preset", ["MIXED", "BALANCED", "FAST32", "THROUGHPUT"])
def test_null_scan_presets(data, preset):
    ref = _jax(data, f"null-{preset}", precision=getattr(jcfg, preset))
    port = _port(data, precision=bt.precision_by_name(preset))
    assert str(port.lod.dtype) == "torch." + str(np.asarray(ref.lod).dtype)  # the JAX package's dtype
    _check_null(port, ref, preset)


def _option(data, option):
    if option == "reml":
        return dict(reml=True)
    if option == "covariates":
        return dict(covar=data["covar"])
    if option == "weights":
        return dict(weights=data["weights"])
    if option == "svd":
        return dict(decomp_scheme="svd")
    if option == "prior":
        return dict(prior_variance=0.8, prior_sample_size=3.0)
    if option == "cholesky":
        return dict(method="cholesky", output_effects=True)
    raise AssertionError(option)


@pytest.mark.parametrize("option", ["reml", "covariates", "weights", "svd", "prior", "cholesky"])
def test_null_scan_options(data, option):
    kw = _option(data, option)
    ref = _jax(data, f"null-{option}", precision=jcfg.EXACT64, **kw)
    port = _port(data, precision=bt.EXACT64, **kw)
    _check_null(port, ref)
    if option == "cholesky":
        assert _maxdiff(port.beta, ref.beta) <= 1e-9


def test_missing_mask_scans_the_observed_individuals(data):
    """missing="mask" (= "drop" for one trait) matches the JAX package's,
    which itself equals the scan of the complete rows."""
    ref = _jax(data, "null-mask", y=data["y_nan"], precision=jcfg.EXACT64, missing="mask")
    port = _port(data, y=data["y_nan"], precision=bt.EXACT64, missing="mask")
    _check_null(port, ref)
    drop = _port(data, y=data["y_nan"], precision=bt.EXACT64, missing="drop")
    assert torch.equal(drop.lod, port.lod)
    # a cached decomposition is subset through the kinship it factors, equal
    # to K up to rounding: h2 moves within the flat optimum (ALT_H2_BAR)
    dec = bt.decompose_kinship(data["K"], dtype=torch.float64, device="cpu")
    cached = _port(data, y=data["y_nan"], K=dec, precision=bt.EXACT64, missing="mask")
    assert abs(float(cached.h2_null) - float(port.h2_null)) <= ALT_H2_BAR
    assert _maxdiff(cached.lod, port.lod) <= ALT_BAR
    with pytest.raises(ValueError, match="missing"):
        _port(data, y=data["y_nan"], precision=bt.EXACT64)


# --- alt scan ------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(output_effects=True), dict(reml=True),
                                dict(compat_sqrt_weights=True)],
                         ids=["ml-effects", "reml", "compat_sqrt_weights"])
def test_alt_scan(data, kw):
    key = "alt-" + "-".join(kw)
    ref = _jax(data, key, precision=jcfg.EXACT64, assumption="alt", **kw)
    port = _port(data, precision=bt.EXACT64, assumption="alt", **kw)
    assert float(port.h2_null) == float(ref.h2_null)
    assert _maxdiff(port.h2_each_marker, ref.h2_each_marker) <= ALT_H2_BAR
    assert _maxdiff(port.lod, ref.lod) <= ALT_BAR
    if kw.get("output_effects"):
        assert _maxdiff(port.beta, ref.beta) <= ALT_BAR
        assert _maxdiff(port.beta_se, ref.beta_se) <= ALT_BAR
    assert port.lod.dtype == port.h2_each_marker.dtype == torch.float64


@pytest.mark.parametrize("reml", [False, True])
def test_alt_scan_every_trait(data, reml):
    """The alt bars on all 16 traits of the fixture (the JAX programs of
    test_alt_scan, reused for each trait)."""
    kw = dict(output_effects=True) if not reml else dict(reml=True)
    for j in range(data["m"]):
        y = data["Y"][:, j]
        ref = bl.scan(y, data["G"], data["K"], precision=jcfg.EXACT64, assumption="alt", **kw)
        port = _port(data, y=y, precision=bt.EXACT64, assumption="alt", **kw)
        assert float(port.h2_null) == float(ref.h2_null), j
        assert _maxdiff(port.h2_each_marker, ref.h2_each_marker) <= ALT_H2_BAR, j
        assert _maxdiff(port.lod, ref.lod) <= ALT_BAR, j


@pytest.fixture(scope="module")
def degenerate(data):
    """The fixture's markers and two degenerate ones: monomorphic, and
    exactly in the span of the intercept and the first covariate."""
    cov = data["covar"]
    G = np.concatenate([data["G"], np.full((data["n"], 1), 0.5), 0.7 + 0.3 * cov[:, :1]], 1)
    return G, cov


@pytest.mark.parametrize("assumption", ["null", "alt"])
def test_collinear_markers_give_lod_zero(data, degenerate, assumption):
    G, cov = degenerate
    res = bt.scan(data["y"], G, data["K"], cov, assumption=assumption, precision=bt.EXACT64,
                  device="cpu")
    assert bool(torch.isfinite(res.lod).all())
    assert bool((res.lod[-2:] == 0).all())
    healthy = bt.scan(data["y"], data["G"], data["K"], cov, assumption=assumption,
                      precision=bt.EXACT64, device="cpu")
    assert _maxdiff(res.lod[:-2], healthy.lod) <= (1e-12 if assumption == "null" else 1e-9)


# --- profile likelihood --------------------------------------------------------


def test_profile_ll_in_scan_default_grid(data):
    ref, pref = _jax(data, "profile", precision=jcfg.EXACT64, profile_ll=True, marker_id=18)
    port, prof = _port(data, precision=bt.EXACT64, profile_ll=True, marker_id=18)
    assert tuple(prof.ll_list_null.shape) == (20,)
    assert prof.ll_list_alt is port.ll_list_alt
    assert _maxdiff(prof.ll_list_null, pref.ll_list_null) <= 1e-9
    assert _maxdiff(prof.ll_list_alt, pref.ll_list_alt) <= 1e-9
    _check_null(port, ref)
    for bad in (0, data["p"] + 1):
        with pytest.raises(ValueError, match="1-based"):
            _port(data, profile_ll=True, marker_id=bad)


def test_profile_LL_and_getLL(data):
    """The standalone functions under enable_x64 (torch's default dtype
    float64 for the default precision), restored after."""
    from bulklmm_tpu.analysis.profile_ll import getLL as jax_getLL

    y, G, K, n = data["y"], data["G"], data["K"], data["n"]
    covar = np.concatenate([np.ones((n, 1)), data["covar"]], 1)
    grid = [0.0, 0.1, 0.45, 0.9]
    ref = bl.profile_LL(y, G, covar, K, grid, 5, reml=True)
    saved = torch.get_default_dtype()
    try:
        bt.enable_x64()
        assert torch.get_default_dtype() == torch.float64
        prof = bt.profile_LL(y, G, covar, K, grid, 5, reml=True, device="cpu")
    finally:
        torch.set_default_dtype(saved)
    assert _maxdiff(prof.ll_list_null, ref.ll_list_null) <= 1e-9
    assert _maxdiff(prof.ll_list_alt, ref.ll_list_alt) <= 1e-9

    lam, U = np.linalg.eigh(K)
    y0, X0 = U.T @ y[:, None], U.T @ np.concatenate([covar, G], 1)
    t = [torch.from_numpy(a) for a in (y0, X0, lam)]
    for h2 in (0.3, torch.tensor(grid, dtype=torch.float64)):
        a = bt.getLL(*t, 3, 7, h2, prior=(1.0, 2.0))
        hs = [h2] if isinstance(h2, float) else grid
        for i, h in enumerate(hs):
            b = jax_getLL(y0, X0, lam, 3, 7, h, prior=(1.0, 2.0))
            got = [v if v.ndim == 0 else v[i] for v in a]
            assert max(abs(float(g) - float(r)) for g, r in zip(got, b)) <= 1e-9


# --- the marker-batched likelihood ---------------------------------------------


@pytest.mark.parametrize("reml", [False, True])
@pytest.mark.parametrize("wshape", ["p,L,n", "p,n"])
def test_wls_ell_markers_matches_wls_per_marker(data, reml, wshape):
    rng = np.random.default_rng(3)
    n, p, L = data["n"], 12, 2
    y = torch.from_numpy(rng.normal(size=n))
    C = torch.from_numpy(np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 2))], 1))
    Xm = torch.from_numpy(data["G"][:, :p])
    w = torch.from_numpy(rng.uniform(0.2, 3.0, (p, L, n)))
    if wshape == "p,n":
        w = w[:, 0]
    ell, sigma2 = wls_ell_markers(y, C, Xm, w, (0.5, 2.0), reml=reml)
    assert tuple(ell.shape) == tuple(w.shape[:-1])
    wl = w if w.ndim == 3 else w[:, None]
    for j in range(p):
        for k in range(wl.shape[1]):
            ref = wls(y, torch.cat([C, Xm[:, j : j + 1]], 1), wl[j, k], (0.5, 2.0), reml=reml)
            e = ell[j, k] if w.ndim == 3 else ell[j]
            s = sigma2[j, k] if w.ndim == 3 else sigma2[j]
            assert abs(float(e - ref.ell[0])) <= 1e-10 * max(1.0, abs(float(e)))
            assert abs(float(s - ref.sigma2[0])) <= 1e-12 * max(1.0, abs(float(s)))


# --- refusals ------------------------------------------------------------------


def test_refusals(data):
    y, G, K, n = data["y"], data["G"], data["K"], data["n"]
    with pytest.raises(ValueError, match="use bulkscan"):
        bt.scan(data["Y"][:, :2], G, K, device="cpu")
    with pytest.raises(ValueError, match="Intercept has to be added"):
        bt.scan(y, G, K, add_intercept=False, device="cpu")
    with pytest.raises(ValueError, match="not supported for the alternative"):
        bt.scan(y, G, K, assumption="alt", permutation_test=True, device="cpu")
    with pytest.raises(ValueError, match="Assumption keyword"):
        bt.scan(y, G, K, assumption="banana", device="cpu")
    with pytest.raises(ValueError, match="Can only handle one trait"):
        bt.scan_perms_lite(data["Y"][:, :2], G, np.ones((n, 0)), K, device="cpu")
    with pytest.raises(ValueError, match="cached decomposition"):
        bt.scan(y, G, bt.decompose_kinship(K, device="cpu"), weights=np.ones(n))
    lam, U = np.linalg.eigh(K)
    lr = LowRankKinship(U=U[:, -10:], lam=lam[-10:])
    # a LowRankKinship runs: the JAX package's refusals, then its results
    with pytest.raises(ValueError, match="cached decomposition"):
        bt.scan(y, G, lr, weights=np.ones(n), device="cpu")
    with pytest.raises(ValueError, match="compat_sqrt_weights"):
        bt.scan(y, G, lr, assumption="alt", compat_sqrt_weights=True, device="cpu")
    ref = bl.scan(y, G, lr, precision=jcfg.EXACT64)
    port = bt.scan(y, G, lr, precision=bt.EXACT64, device="cpu")
    assert float(port.h2_null) == float(ref.h2_null)
    assert np.max(np.abs(port.lod.numpy() - np.asarray(ref.lod))) < 1e-10
    ref = bl.scan_perms_lite(y, G, np.ones((n, 0)), lr, nperms=4, precision=jcfg.EXACT64)
    idx = np.asarray(jax_permutation_indices(n, 4, 0))
    port = bt.scan_perms_lite(y, G, np.ones((n, 0)), lr, nperms=4, perm_idx=idx,
                              precision=bt.EXACT64, device="cpu")
    assert np.max(np.abs(port.L_perms.numpy() - np.asarray(ref.L_perms))) < 1e-10


def test_numpy_inputs_without_a_device_raise_and_name_the_cpu(data):
    """No silent CPU run. (Skipped on a machine with a card, where the call
    would run there.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy inputs run on it")
    y, G, K, n = data["y"], data["G"], data["K"], data["n"]
    for call in (lambda: bt.scan(y, G, K),
                 lambda: bt.scan_perms_lite(y, G, np.ones((n, 0)), K, nperms=4)):
        with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
            call()
