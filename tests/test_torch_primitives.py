"""The port's primitives against their bulklmm_tpu counterparts, on CPU.

Inputs are made with numpy from a seed and fed to both packages. At float64
the bar is 1e-10: the two compute the same formulas and differ only in the
order of summation. kinship_eigen runs the same host LAPACK call in both and
must agree exactly.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulklmm_tpu.ops import kinship as jk
from bulklmm_tpu.ops import lod as jlod
from bulklmm_tpu.ops import rotation as jrot
from bulklmm_tpu.ops import smallchol as jsc
from bulklmm_tpu.ops import stats as jstats
from bulklmm_tpu.ops import weights as jw
from bulklmm_tpu.ops.wls import wls_ell as jax_wls_ell
from bulklmm_tpu.utils import config as jcfg
from bulklmm_tpu_torch.ops import kinship as tk
from bulklmm_tpu_torch.ops import lod as tlod
from bulklmm_tpu_torch.ops import rotation as trot
from bulklmm_tpu_torch.ops import smallchol as tsc
from bulklmm_tpu_torch.ops import stats as tstats
from bulklmm_tpu_torch.ops import weights as tw
from bulklmm_tpu_torch.ops import wls as twls
from bulklmm_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

TOL64 = 1e-10


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL64):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.max(np.abs(port.astype(np.float64) - ref.astype(np.float64))) <= tol


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("h2", [0.0, 0.37, 0.95, 1.0, "vector", "grid"])
def test_make_weights(rng, h2):
    lam = rng.uniform(0.0, 3.0, 25)
    if h2 == "vector":
        h2 = rng.uniform(0.0, 1.0, 7)
    elif h2 == "grid":
        h2 = np.arange(0.0, 0.91, 0.1)
    ref = jw.make_weights(jnp.asarray(h2), jnp.asarray(lam))
    port = tw.make_weights(_t(h2) if np.ndim(h2) else h2, _t(lam))
    _close(port, ref)
    assert bool(torch.isfinite(port).all())  # h2 = 1 is clipped, not inf


def _spd_gram(rng, c, m):
    """c x c SPD Gram entries, one per trait, as the dicts both take."""
    A = rng.normal(size=(m, c + 3, c))
    G = np.einsum("mik,mil->mkl", A, A)
    return G, {(k, l): G[:, k, l] for k in range(c) for l in range(k, c)}


@pytest.mark.parametrize("c", [1, 2, 3, 5])
def test_smallchol_helpers(rng, c):
    assert tsc.pair_indices(c) == jsc.pair_indices(c)
    m = 9
    _, Gd = _spd_gram(rng, c, m)
    Lj = jsc.unrolled_cholesky({k: jnp.asarray(v) for k, v in Gd.items()}, c)
    Lt = tsc.unrolled_cholesky({k: _t(v) for k, v in Gd.items()}, c)
    for key in Lj:
        _close(Lt[key], Lj[key])
    rows = [rng.normal(size=(4, m)) for _ in range(c)]
    zj = jsc.fwd_subst(Lj, [jnp.asarray(r) for r in rows], c)
    zt = tsc.fwd_subst(Lt, [_t(r) for r in rows], c)
    for a, b in zip(zt, zj):
        _close(a, b)
    total = np.sum(rng.normal(size=(c + 2, 4, m)) ** 2, axis=0) + 1e-3
    _close(tsc.residual_sq(_t(total), zt), jsc.residual_sq(jnp.asarray(total), zj))


@pytest.mark.parametrize("eps", [None, float(np.finfo(np.float32).eps)])
@pytest.mark.parametrize("mask", ["residual_keep_mask", "cancel_keep_mask"])
def test_keep_masks(rng, mask, eps):
    pre = rng.uniform(0.5, 2.0, 200)
    # posts straddling both thresholds, at the float32 and float64 scales
    post = pre * np.concatenate([
        10.0 ** rng.uniform(-30, 0, 150),
        1024 * np.finfo(np.float32).eps * rng.uniform(0.5, 2.0, 50),
    ])
    ref = getattr(jsc, mask)(jnp.asarray(post), jnp.asarray(pre), eps=eps)
    port = getattr(tsc, mask)(_t(post), _t(pre), eps=eps)
    assert np.array_equal(port.numpy(), np.asarray(ref))
    assert 0 < port.sum() < post.size


@pytest.mark.parametrize("reml", [False, True])
@pytest.mark.parametrize("prior", [(0.0, 0.0), (1.0, 4.0)])
@pytest.mark.parametrize("c", [1, 3, 24])
def test_wls_ell(rng, c, prior, reml):
    """The port's likelihood against the JAX package's, the unrolled factor
    on both sides up to ``UNROLLED_COLUMNS`` columns; at 24 columns the
    port's batched factorization against the JAX package's unrolled one."""
    assert (c > twls.UNROLLED_COLUMNS) == (c == 24)
    n, q = 30, 6
    y = rng.normal(size=(n, q))
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, c - 1))], axis=1)
    lam = rng.uniform(0.1, 2.0, n)
    grid = np.arange(0.0, 0.91, 0.1)
    W = np.asarray(jw.make_weights(jnp.asarray(grid), jnp.asarray(lam)))
    ell_t, s2_t = twls.wls_ell(_t(y), _t(X), _t(W), prior, reml=reml)  # batched
    assert ell_t.shape == (grid.size, q)
    for g in range(grid.size):
        ell_j, s2_j = jax_wls_ell(jnp.asarray(y), jnp.asarray(X), jnp.asarray(W[g]), prior, reml=reml)
        _close(ell_t[g], ell_j)
        _close(s2_t[g], s2_j)
        ell_1, _ = twls.wls_ell(_t(y), _t(X), _t(W[g]), prior, reml=reml)  # one w
        _close(ell_1, ell_j)
    # a single column
    ell_j, _ = jax_wls_ell(jnp.asarray(y[:, 0]), jnp.asarray(X), jnp.asarray(W[3]), prior, reml=reml)
    _close(twls.wls_ell(_t(y[:, 0]), _t(X), _t(W[3]), prior, reml=reml)[0], ell_j)


@pytest.mark.parametrize("marker_chunk", [0, 7, 64])
def test_calc_kinship(rng, marker_chunk):
    G = rng.uniform(0.0, 1.0, (20, 50))
    ref = jk.calc_kinship(G, jcfg.EXACT64, marker_chunk=marker_chunk)
    port = tk.calc_kinship(G, tcfg.EXACT64, marker_chunk=marker_chunk, device="cpu")
    assert port.dtype == torch.float64
    _close(port, ref)
    assert np.all(np.diag(port.numpy()) == 1.0)


@pytest.mark.parametrize("scheme", ["eigen", "svd"])
def test_kinship_eigen_exact(rng, scheme):
    X = rng.uniform(0.0, 1.0, (15, 40)) - 0.5
    K = 2.0 * X @ X.T / 40 + 0.5
    np.fill_diagonal(K, 1.0)
    Ut_j, lam_j = jrot.kinship_eigen(K, scheme)
    Ut_t, lam_t = trot.kinship_eigen(_t(K), scheme)  # a tensor K goes to the host
    assert np.array_equal(Ut_t, Ut_j) and np.array_equal(lam_t, lam_j)
    with pytest.raises(ValueError, match="decomp_scheme"):
        trot.kinship_eigen(K, "qr")


def test_kinship_eigen_warns_on_negative_eigenvalues():
    K = np.diag([1.0, 0.5, -0.1])
    with pytest.warns(UserWarning, match="Negative eigenvalues"):
        trot.kinship_eigen(K)


def test_transform_rotation(rng):
    n = 12
    y, g = rng.normal(size=(n, 3)), rng.uniform(0, 1, (n, 5))
    K = np.cov(rng.normal(size=(n, 40))) + np.eye(n)
    ref = jrot.transform_rotation(y, g, K, precision=jcfg.EXACT64)
    port = trot.transform_rotation(y, g, K, precision=tcfg.EXACT64, device="cpu")
    for a, b in zip(port, ref):
        _close(a, b)
    dec = jrot.decompose_kinship(K)
    port_dec = trot.decomposition_from_numpy(dec.Ut_host, dec.lam_host, device="cpu", dtype=torch.float64)
    _close(trot.transform_rotation(y, g, port_dec, precision=tcfg.EXACT64).X0, ref.X0)
    with pytest.raises(ValueError, match="Dimension mismatch"):
        trot.transform_rotation(y[:-1], g, K, device="cpu")


def test_r2lod_float64(rng):
    r = np.concatenate([rng.uniform(-0.99, 0.99, 500), [1.0, -1.0, 0.0]])
    _close(tlod.r2lod(_t(r), 79), jlod.r2lod(jnp.asarray(r), 79))
    assert bool(torch.isfinite(tlod.r2lod(_t(r), 79)).all())  # |r| = 1 is floored


def test_r2lod_fast_log_float32_bar():
    """The float32 log meets the JAX package's 2e-6 bar for its accurate
    float32 log10 (tests/test_pallas_fused.py), on the same inputs."""
    x = np.random.default_rng(0).uniform(1e-7, 1.0, 50000)
    r = np.sqrt(1.0 - x)  # float64, so 1 - r^2 recovers x to ~1e-16
    lod = tlod.r2lod(_t(r), 2, fast_log=True)  # = -log10(float32(1 - r^2))
    assert lod.dtype == torch.float32
    assert np.max(np.abs(-lod.numpy() - np.log10(x))) < 2e-6
    # and it tracks the JAX package's fast-log path
    _close(lod, jlod.r2lod(jnp.asarray(r), 2, fast_log=True), tol=2e-6)


@pytest.mark.parametrize("df", [1, 2])
def test_pvalue_conversions(rng, df):
    lod = rng.uniform(0.0, 40.0, 100)
    for fn in ("lod2log10p", "lod2p"):
        ref = getattr(jlod, fn)(lod, df)
        _close(getattr(tlod, fn)(lod, df), ref)
        out = getattr(tlod, fn)(_t(lod), df)  # a tensor stays a tensor
        assert torch.is_tensor(out)
        _close(out, ref)
    p = rng.uniform(1e-12, 1.0, 100)
    _close(tlod.p2lod(p, df), jlod.p2lod(p, df))


@pytest.mark.parametrize("add_intercept", [True, False])
def test_check_covar_full_rank(rng, add_intercept):
    n = 20
    good = rng.normal(size=(n, 2))
    tstats.check_covar_full_rank(good, add_intercept)
    tstats.check_covar_full_rank(_t(good[:, 0]), add_intercept)  # 1-D tensor
    bad = np.concatenate([good, good[:, :1] * 2.0], axis=1)
    if add_intercept:
        bad = np.concatenate([good, np.full((n, 1), 3.0)], axis=1)
    with pytest.raises(ValueError) as ej:
        jstats.check_covar_full_rank(bad, add_intercept)
    with pytest.raises(ValueError) as et:
        tstats.check_covar_full_rank(bad, add_intercept)
    assert str(et.value) == str(ej.value)


def test_precision_presets_match_jax():
    as_torch = {jnp.float32: torch.float32, jnp.float64: torch.float64, None: None}
    for name in ("FAST32", "MIXED", "EXACT64", "BALANCED", "THROUGHPUT"):
        j, t = getattr(jcfg, name), tcfg.precision_by_name(name.lower())
        assert t is getattr(tcfg, name)
        for f in ("resolve_solve", "resolve_gemm", "resolve_kernel"):
            assert getattr(t, f)() == as_torch[getattr(j, f)()]
    with pytest.raises(ValueError, match="unknown precision preset"):
        tcfg.precision_by_name("HALF")
    assert tcfg.default_float() == torch.get_default_dtype()
    assert tcfg.DEFAULT_PRECISION.resolve_solve() == torch.get_default_dtype()


def test_with_highest_matmul_scopes_and_restores():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with tcfg.with_highest_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"

        @tcfg.with_highest_matmul()
        def inner():
            return torch.get_float32_matmul_precision()

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert inner() == "highest" and inner() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
