"""The null-exact slice: batched Brent, ``wls``, ``fit_lmm`` and
``bulklmm_tpu_torch.bulkscan(method="null-exact")`` against the JAX package
on CPU, fed the same numpy inputs.

Bars:

- ``wls``: 1e-10 in float64 (the same LAPACK factorizations in both).
- Brent: the JAX package's CPU compiler contracts ``a * b + c`` into one
  fused multiply-add (it rounds 23 % of random float64 triples otherwise
  than two operations do), inside Brent's own updates as well, so the two
  packages' iterates part at the last bit and each stops somewhere inside
  Brent's tolerance window ``sqrt(eps) |x| + eps`` around the optimum.
  xmin is held to twice that window (3e-8 on [0, 1]; measured up to
  1.4e-8 here), fmin to 1e-13, and the lower-endpoint case to exactly 0.
- h2: 1e-6 (the JAX package's bar for null-exact fits in another reduction
  order, tests/test_streaming.py:46) under EXACT64, MIXED and BALANCED,
  whose Brent runs in float64.
- L: test_torch_bulkscan.py's preset bars, except EXACT64, whose 1e-9 is
  held by the LOD step at the JAX package's own h2; the scan as a whole
  gets 1e-6, the JAX package's bar for a null-exact scan summed in another
  order (tests/test_sharding.py:35-37), since h2 moves within Brent's
  window and L with it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.ops.brent import brent_min as jax_brent_min
from bulklmm_tpu.ops.brent import gridbrent as jax_gridbrent
from bulklmm_tpu.ops.lmm import fit_lmm as jax_fit_lmm
from bulklmm_tpu.ops.wls import wls as jax_wls
from bulklmm_tpu.ops.wls import wls_ell as jax_wls_ell
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
from bulklmm_tpu_torch.models.bulkscan import _lod_step
from bulklmm_tpu_torch.ops import brent, lmm
from bulklmm_tpu_torch.ops.wls import wls, wls_ell_columns
from bulklmm_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)

L_BAR = {"EXACT64": 1e-6, "MIXED": 1e-4, "BALANCED": 1e-4, "FAST32": 1e-3, "THROUGHPUT": 1e-3}
H2_BAR = 1e-6
F64_PRESETS = ("EXACT64", "MIXED", "BALANCED")
WINDOW = 2 * (np.finfo(np.float64).eps ** 0.5 + np.finfo(np.float64).eps)


# --- Brent --------------------------------------------------------------------


def _quartic(c, x):
    """a (x - r1)^2 (x - r2)^2 + s x + q (x - cc)^2: smooth, and bimodal
    where a dominates."""
    a, r1, r2, s, q, cc = (c[..., i] for i in range(6))
    return a * (x - r1) ** 2 * (x - r2) ** 2 + s * x + q * (x - cc) ** 2


@pytest.fixture(scope="module")
def coefs():
    rng = np.random.default_rng(7)
    B = 12
    return np.column_stack([
        rng.uniform(0.5, 3.0, B), rng.uniform(0.0, 0.5, B), rng.uniform(0.5, 1.0, B),
        rng.uniform(-0.3, 0.3, B), rng.uniform(0.0, 1.0, B), rng.uniform(0.0, 1.0, B),
    ])


def _jax_each(fn, coefs, *args):
    """The JAX function on each objective, vmapped as the JAX package
    batches its fits."""
    f, x = jax.vmap(lambda c: fn(lambda x: _quartic(c, x), *args, dtype=jnp.float64))(
        jnp.asarray(coefs)
    )
    return np.asarray(f), np.asarray(x)


def _close(port_f, port_x, ref_f, ref_x):
    assert np.max(np.abs(port_x - ref_x)) <= WINDOW
    assert np.max(np.abs(port_f - ref_f)) <= 1e-13


def test_brent_min_matches_jax(coefs):
    ref_f, ref_x = _jax_each(jax_brent_min, coefs, 0.0, 1.0)
    c = torch.from_numpy(coefs)
    lo = torch.zeros(len(coefs), dtype=torch.float64)
    f, x = brent.brent_min(lambda x: _quartic(c, x), lo, lo + 1.0)
    assert x.dtype == torch.float64 and 0 < brent.iterations < 96
    _close(f.numpy(), x.numpy(), ref_f, ref_x)


@pytest.mark.parametrize("ninterval", [1, 2, 3])
def test_gridbrent_matches_jax(coefs, ninterval):
    ref_f, ref_x = _jax_each(jax_gridbrent, coefs, 0.0, 1.0, ninterval)
    c = torch.from_numpy(coefs)[:, None, :]
    f, x = brent.gridbrent(
        lambda x: _quartic(c, x), 0.0, 1.0, ninterval, batch_shape=(len(coefs),),
        dtype=torch.float64,
    )
    assert x.shape == (len(coefs),)
    _close(f.numpy(), x.numpy(), ref_f, ref_x)


def test_gridbrent_lower_endpoint_candidate():
    """A profile whose global minimum is at the lower bound, with an
    interior local minimum that Brent alone converges to (COMPAT.md #19):
    the degenerate [a, a] lane returns exactly a."""
    def prof(x):  # f(0) = -0.12 < f(0.6) = 0
        return 3.0 * (x - 0.6) ** 2 - 8.0 * (0.15 - x) * ((0.15 - x) > 0)

    jf, jx = jax_gridbrent(prof, 0.0, 1.0, 1, dtype=jnp.float64)
    tf, tx = brent.gridbrent(prof, 0.0, 1.0, 1, dtype=torch.float64)
    _, interior = brent.brent_min(prof, 0.0, 1.0, dtype=torch.float64)
    assert float(jx) == 0.0 and float(tx) == 0.0
    assert float(tf) == float(jf) == pytest.approx(-0.12)
    assert float(interior) > 0.5  # Brent alone finds the interior mode


def test_gridbrent_nan_lane_loses():
    """A NaN objective on one sub-interval never wins the argmin."""
    def f(x):
        return torch.where(x > 0.5, torch.nan, (x - 0.3) ** 2)

    fmin, xmin = brent.gridbrent(f, 0.0, 1.0, 2, dtype=torch.float64)
    assert abs(float(xmin) - 0.3) < 1e-7 and float(fmin) < 1e-12


def test_brent_float32_tolerance_adapts():
    """In float32 the tolerances are float32's: the loop converges and
    stops early."""
    f, x = brent.brent_min(lambda x: (x - 0.37) ** 2, 0.0, 1.0, dtype=torch.float32)
    assert x.dtype == torch.float32 and abs(float(x) - 0.37) < 1e-3
    assert brent.iterations < 96


# --- wls, fit_lmm ------------------------------------------------------------


@pytest.fixture(scope="module")
def regression():
    rng = np.random.default_rng(11)
    n, q = 30, 5
    X = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    y = rng.normal(size=(n, q)) + X @ rng.normal(size=(3, q))
    w = rng.uniform(0.3, 2.0, n)
    W = rng.uniform(0.3, 2.0, (q, n))
    return dict(X=X, y=y, w=w, W=W)


def _np(t):
    return np.asarray(t, dtype=np.float64)


@pytest.mark.parametrize("method", ["qr", "cholesky"])
@pytest.mark.parametrize("reml", [False, True])
@pytest.mark.parametrize("prior", [(0.0, 0.0), (0.8, 3.0)], ids=["noprior", "prior"])
def test_wls_matches_jax(regression, method, reml, prior):
    X, y, w = regression["X"], regression["y"], regression["w"]
    ref = jax_wls(jnp.asarray(y), jnp.asarray(X), jnp.asarray(w), prior, reml=reml, method=method)
    port = wls(torch.from_numpy(y), torch.from_numpy(X), torch.from_numpy(w), prior,
                   reml=reml, method=method)
    for name in ("b", "sigma2", "ell", "rss"):
        got, want = _np(getattr(port, name)), _np(getattr(ref, name))
        assert got.shape == want.shape, name
        assert np.max(np.abs(got - want)) < 1e-10, name


@pytest.mark.parametrize("method", ["qr", "cholesky"])
def test_wls_per_column_weights_match_jax(regression, method):
    """One weight vector per column: column j against a JAX fit of column j."""
    X, y, W = regression["X"], regression["y"], regression["W"]
    port = wls(torch.from_numpy(y), torch.from_numpy(X), torch.from_numpy(W), (1.0, 2.0),
                   reml=True, method=method)
    for j in range(y.shape[1]):
        ref = jax_wls(jnp.asarray(y[:, j]), jnp.asarray(X), jnp.asarray(W[j]), (1.0, 2.0),
                      reml=True, method=method)
        assert np.max(np.abs(_np(port.b[:, j]) - _np(ref.b[:, 0]))) < 1e-10
        for name in ("sigma2", "ell", "rss"):
            assert abs(float(getattr(port, name)[j]) - float(getattr(ref, name)[0])) < 1e-10


def test_wls_ell_columns_matches_jax(regression):
    X, y, W = regression["X"], regression["y"], regression["W"]
    ell, sigma2 = wls_ell_columns(torch.from_numpy(y), torch.from_numpy(X),
                                      torch.from_numpy(W), (0.5, 1.0), reml=True)
    for j in range(y.shape[1]):
        e, s = jax_wls_ell(jnp.asarray(y[:, j]), jnp.asarray(X), jnp.asarray(W[j]), (0.5, 1.0), reml=True)
        assert abs(float(ell[j]) - float(e[0])) < 1e-10
        assert abs(float(sigma2[j]) - float(s[0])) < 1e-10


def test_wls_unknown_method_raises(regression):
    X, y, w = (torch.from_numpy(regression[k]) for k in ("X", "y", "w"))
    with pytest.raises(ValueError, match="unknown method"):
        wls(y, X, w, method="svd")


@pytest.fixture(scope="module")
def rotated_traits(bxd_like):
    dec = bl.decompose_kinship(bxd_like["K"])
    Ut, lam = dec.Ut_host, dec.lam_host
    C = np.column_stack([np.ones(bxd_like["n"]), np.random.default_rng(5).normal(size=bxd_like["n"])])
    return dict(Y0=Ut @ bxd_like["Y"], C0=Ut @ C, lam=lam)


@pytest.mark.parametrize("reml, prior, optim_interval, method", [
    (False, (1.0, 0.0), 1, "qr"),
    (True, (0.0, 0.0), 2, "cholesky"),
    (False, (0.8, 3.0), 3, "qr"),
], ids=["ml", "reml-2", "prior-3"])
def test_fit_lmm_matches_jax(rotated_traits, reml, prior, optim_interval, method):
    d = rotated_traits
    kw = dict(reml=reml, method=method, optim_interval=optim_interval)
    traits = [0, 3, 9]
    C0, lam = jnp.asarray(d["C0"]), jnp.asarray(d["lam"])
    refs = jax.vmap(lambda y: jax_fit_lmm(y, C0, lam, prior, **kw), in_axes=1)(
        jnp.asarray(d["Y0"][:, traits])
    )
    for i, j in enumerate(traits):
        port = lmm.fit_lmm(torch.from_numpy(d["Y0"][:, j]), torch.from_numpy(d["C0"]),
                           torch.from_numpy(d["lam"]), prior, **kw)
        assert port.b.shape == (2, 1) and port.h2.ndim == 0
        assert abs(float(port.h2) - float(refs.h2[i])) < H2_BAR
        assert np.max(np.abs(_np(port.b) - _np(refs.b[i]))) < 1e-6
        assert abs(float(port.sigma2) - float(refs.sigma2[i])) < 1e-6 * float(refs.sigma2[i])
        assert abs(float(port.ell) - float(refs.ell[i])) < 1e-6


def test_batched_fit_matches_single_fits(rotated_traits):
    """fit_lmm_traits over all traits at once = a loop of single fits."""
    d = {k: torch.from_numpy(v) for k, v in rotated_traits.items()}
    batch = lmm.fit_lmm_traits(d["Y0"], d["C0"], d["lam"], (1.0, 0.0), optim_interval=2)
    m = d["Y0"].shape[1]
    assert batch.b.shape == (2, m) and batch.h2.shape == (m,)
    for j in range(m):
        one = lmm.fit_lmm(d["Y0"][:, j], d["C0"], d["lam"], (1.0, 0.0), optim_interval=2)
        assert abs(float(one.h2) - float(batch.h2[j])) < H2_BAR
        assert abs(float(one.ell) - float(batch.ell[j])) < 1e-6
    assert torch.equal(
        lmm.fit_h2_traits(d["Y0"], d["C0"], d["lam"], (1.0, 0.0), optim_interval=2), batch.h2
    )


# --- bulkscan(method="null-exact") -------------------------------------------


def _run(data, preset, **kw):
    Y, G, K = data["Y"], data["G"], data["K"]
    ref = bl.bulkscan(Y, G, K, method="null-exact", precision=getattr(jcfg, preset), **kw)
    port = bt.bulkscan(Y, G, K, method="null-exact", precision=bt.precision_by_name(preset),
                       device="cpu", **kw)
    return port, ref


def _compare(port, ref, preset):
    Lp, Lr = port.L.double().numpy(), np.asarray(ref.L, dtype=np.float64)
    assert Lp.shape == Lr.shape
    assert np.max(np.abs(Lp - Lr)) < L_BAR[preset]
    if preset in F64_PRESETS:
        dh2 = np.abs(port.h2_null_list.numpy() - np.asarray(ref.h2_null_list))
        assert np.max(dh2) < H2_BAR


@pytest.mark.parametrize("preset", list(L_BAR))
def test_presets_match_jax(bxd_like, preset):
    port, ref = _run(bxd_like, preset)
    assert str(port.L.dtype).removeprefix("torch.") == str(ref.L.dtype)
    assert str(port.h2_null_list.dtype).removeprefix("torch.") == str(ref.h2_null_list.dtype)
    assert port.h2_null_list.shape == (bxd_like["m"],) and port.h2_panel is None
    _compare(port, ref, preset)


def test_exact64_lod_step_at_jax_h2(bxd_like):
    """Given the JAX package's h2, the EXACT64 LOD step matches at 1e-9."""
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    ref = bl.bulkscan(Y, G, K, method="null-exact", precision=jcfg.EXACT64)
    dec = bl.decompose_kinship(K)
    Ut = torch.from_numpy(np.asarray(dec.Ut_host))
    X = torch.from_numpy(np.column_stack([np.ones(len(Y)), G]))
    L = _lod_step(Ut @ torch.from_numpy(Y), Ut @ X[:, 1:], Ut @ X[:, :1],
                  torch.from_numpy(np.asarray(dec.lam_host)),
                  torch.tensor(np.asarray(ref.h2_null_list)), bt.EXACT64)
    assert np.max(np.abs(L.numpy() - np.asarray(ref.L))) < 1e-9


def _option_kwargs(option, data):
    return {
        "optim_interval": dict(optim_interval=2),
        "covariates": dict(covar=np.random.default_rng(5).normal(size=(data["n"], 2))),
        "reml": dict(reml=True),
        "prior0": dict(prior_variance=0.0),
        "trait_chunk": dict(trait_chunk=5),
        "cholesky": dict(solve_method="cholesky"),
    }[option]


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
@pytest.mark.parametrize("option", ["optim_interval", "covariates", "reml", "prior0", "trait_chunk", "cholesky"])
def test_options_match_jax(bxd_like, option, preset):
    port, ref = _run(bxd_like, preset, **_option_kwargs(option, bxd_like))
    _compare(port, ref, preset)


def test_bulkscan_null_alias(bxd_like):
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    a = bt.bulkscan(Y, G, K, method="null-exact", precision=bt.BALANCED, device="cpu")
    b = bt.bulkscan_null(Y, G, K, precision=bt.BALANCED, device="cpu")
    assert torch.equal(a.L, b.L) and torch.equal(a.h2_null_list, b.h2_null_list)
    assert not launch_counts


def test_float32_presets_take_the_kernel_entry(bxd_like, monkeypatch):
    """FAST32/BALANCED/THROUGHPUT take the fused LOD entry; MIXED/EXACT64
    the plain float64-combine path, as null-grid does."""
    calls = []
    real = lf.fused_lods_per_trait
    mb = importlib.import_module("bulklmm_tpu_torch.models.bulkscan")
    monkeypatch.setattr(mb, "fused_lods_per_trait", lambda *a: calls.append(1) or real(*a))
    for preset, expect in [("BALANCED", 1), ("FAST32", 1), ("THROUGHPUT", 1), ("MIXED", 0), ("EXACT64", 0)]:
        calls.clear()
        bt.bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], method="null-exact",
                    precision=bt.precision_by_name(preset), device="cpu")
        assert len(calls) == expect, preset


def test_unknown_solve_method_same_error_as_jax(bxd_like):
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    with pytest.raises(ValueError) as ej:
        bl.bulkscan(Y, G, K, method="null-exact", solve_method="svd")
    with pytest.raises(ValueError) as et:
        bt.bulkscan(Y, G, K, method="null-exact", solve_method="svd", device="cpu")
    assert str(et.value) == str(ej.value)
