"""The rank-k kinship engine of the port (``bulklmm_tpu_torch/ops/lowrank.py``
and the Woodbury paths of every entry point) against the JAX package's, on
the same numpy inputs: the counterpart of tests/test_lowrank.py (its sharded
test waits for the multi-GPU item).

Bars, the JAX package's own:

- EXACT64: 1e-8 against the JAX package in LOD, h2, effects and
  permutation columns, and at k = n against the port's rotated engine
  (tests/test_lowrank.py). Brent's fits (null-exact, the REML alt scan) stop
  anywhere inside Brent's window when the objective is summed in another
  order: h2 within twice the window (3e-8, test_torch_nullexact.py), what
  follows the fit within BRENT_BAR (2e-7; observed up to 5.8e-8) and the
  per-marker alt h2 within test_torch_scan.py's 3e-7, with the LOD step
  itself held at the JAX package's h2 to 1e-8.
- BALANCED 1e-4 and FAST32 1e-3 with identical grid h2
  (tests/test_pallas_fused.py:57-75). The JAX package runs the rank-k
  null-exact Brent in the kernel dtype (float32 under both presets; the
  port runs it in the solve dtype, float64 under BALANCED): null-exact's
  LOD step is held at the JAX package's h2, and under BALANCED its h2 and
  LODs against the JAX package's EXACT64 fit (1e-5, 1e-4); under FAST32 its
  h2 to twice float32's Brent window.
- The randomized constructors draw their start panel from a torch
  generator, not threefry: both packages' factors are held against
  ``kinship_lowrank_exact`` at tests/test_lowrank.py's tolerances, not
  against each other bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.models.missing import subset_kinship as jax_subset_kinship
from bulklmm_tpu.ops import bulkperm as jops
from bulklmm_tpu.ops import lowrank as jlr
from bulklmm_tpu.ops.hostfit import fit_lmm_host_lowrank as jax_fit_lmm_host_lowrank
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.models.missing import subset_kinship
from bulklmm_tpu_torch.ops import bulkperm as tops
from bulklmm_tpu_torch.ops import lowrank as tlr
from bulklmm_tpu_torch.ops.hostfit import fit_lmm_host_lowrank
from bulklmm_tpu_torch.utils import memory as mem
from bulklmm_tpu_torch.utils.config import with_highest_matmul

torch.set_num_threads(1)

L_BAR = {"EXACT64": 1e-8, "BALANCED": 1e-4, "FAST32": 1e-3}
WINDOW = 2 * (np.finfo(np.float64).eps ** 0.5 + np.finfo(np.float64).eps)
WINDOW32 = 2 * (np.finfo(np.float32).eps ** 0.5 + np.finfo(np.float32).eps)
#: h2 from a Brent fit on sums taken in another order, and the LODs,
#: effects and columns that follow it (observed up to 5.8e-8)
BRENT_BAR = 2e-7
NPERMS = 12


def _cohort(seed=5, n=60, p=80, m=24, structured=True):
    """tests/test_lowrank.py's cohort."""
    rng = np.random.default_rng(seed)
    if structured:
        F = rng.normal(size=(n, 3))
        load = 1.0 / (1.0 + np.exp(-(F @ rng.normal(size=(3, p)) * 0.9)))
        G = rng.binomial(1, load).astype(np.float64)
    else:
        G = rng.uniform(0, 1, (n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    Y[:, 0] += 0.9 * (G[:, 7] - G[:, 7].mean())
    return Y, G, K


def _single_trait(seed=51):
    """tests/test_lowrank.py's single-trait data."""
    rng = np.random.default_rng(seed)
    n, p = 70, 50
    G = rng.choice([0.0, 0.5, 1.0], size=(n, p))
    A = rng.standard_normal((n, n))
    K = A @ A.T / n + 0.5 * np.eye(n)
    K /= np.mean(np.diag(K))
    y = rng.standard_normal(n) + 0.8 * (G[:, 11] - G[:, 11].mean())
    covar = rng.standard_normal((n, 2))
    return y, G, K, covar


def _np(x):
    return x.double().numpy() if torch.is_tensor(x) else np.asarray(x, dtype=np.float64)


def _maxdiff(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def _perm_idx(nperms=NPERMS, seed=0):
    return lambda n: np.asarray(jops.permutation_indices(n, nperms, seed))


@pytest.fixture(scope="module")
def data():
    Y, G, K = _cohort(seed=17)
    covar = np.random.default_rng(1).normal(size=(K.shape[0], 2))
    return dict(Y=Y, G=G, K=K, covar=covar, lr=jlr.kinship_lowrank_exact(K, 20),
                n=K.shape[0])


# --- constructors ------------------------------------------------------------------


@pytest.mark.parametrize("structured", [True, False], ids=["structured", "uniform"])
def test_kinship_lowrank_exact_equals_jax(structured):
    _, _, K = _cohort(structured=structured)
    ref = jlr.kinship_lowrank_exact(K, 12)
    got = bt.kinship_lowrank_exact(K, 12, device="cpu")
    assert got.U.dtype == torch.float64 and got.rank == 12 and got.n == K.shape[0]
    assert np.array_equal(got.U.numpy(), np.asarray(ref.U))
    assert np.array_equal(got.lam.numpy(), np.asarray(ref.lam))


@pytest.mark.parametrize("structured", [True, False], ids=["structured", "uniform"])
def test_randomized_matches_exact_topk(structured):
    """Both packages' randomized factors against the exact ones, at
    tests/test_lowrank.py:86-96's tolerances: the well-separated leading
    eigenvalues (three of the structured cohort's, one of the uniform
    cohort's, whose bulk is flat) to 1e-3, the operator K U ~= U diag(lam)."""
    _, _, K = _cohort(seed=13, structured=structured)
    k, lead = 8, 3 if structured else 1
    ex = jlr.kinship_lowrank_exact(K, k, dtype=jnp.float64)
    for rz in (bt.kinship_lowrank(K, k, seed=3, precision=bt.EXACT64, device="cpu"),
               jlr.kinship_lowrank(K, k, seed=3)):
        assert np.allclose(_np(rz.lam[:lead]), np.asarray(ex.lam[:lead]), rtol=1e-3)
        U, lam = _np(rz.U), _np(rz.lam)
        assert np.linalg.norm(K @ U - U * lam, 2) < 0.05 * float(ex.lam[0])
        assert np.allclose(U.T @ U, np.eye(k), atol=1e-10)


def test_from_geno_matches_explicit_K():
    """tests/test_lowrank.py:99-108: from the genotypes, without forming K,
    the same factors as from K with the same seed; and the same subspace as
    the JAX package's."""
    _, G, K = _cohort(seed=21)
    k = 8
    a = bt.kinship_lowrank(K, k, seed=7, precision=bt.EXACT64, device="cpu")
    b = bt.kinship_lowrank_from_geno(G, k, seed=7, precision=bt.EXACT64, device="cpu")
    assert np.allclose(a.lam.numpy(), b.lam.numpy(), rtol=1e-5, atol=1e-7)
    Pa, Pb = a.U.numpy() @ a.U.numpy().T, b.U.numpy() @ b.U.numpy().T
    assert np.max(np.abs(Pa - Pb)) < 1e-4
    # each package against the exact factors (another start panel: the
    # tail eigenpairs agree only as a subspace)
    ex = jlr.kinship_lowrank_exact(K, k, dtype=jnp.float64)
    for rz in (b, jlr.kinship_lowrank_from_geno(G, k, seed=7)):
        assert np.allclose(_np(rz.lam[:3]), np.asarray(ex.lam[:3]), rtol=1e-3)
        U, lam = _np(rz.U), _np(rz.lam)
        assert np.linalg.norm(K @ U - U * lam, 2) < 0.05 * float(ex.lam[0])


@pytest.mark.parametrize("case", ["full-rank", "deficient", "deficient-eigh"])
def test_cholqr2_matches_jax_and_falls_back(monkeypatch, case):
    """CholeskyQR2: a full-rank panel gets orthonormal columns, the same as
    the JAX package's; a rank-deficient one (two repeated columns) keeps its
    span through the jittered Cholesky, and through the eigh whitening when
    the Cholesky raises (forced), whose floored directions come out as new
    columns (they re-randomize the subspace on the next product), in both
    packages."""
    rng = np.random.default_rng(3)
    Y = rng.normal(size=(50, 6))
    if case != "full-rank":
        Y[:, 4], Y[:, 5] = Y[:, 0], Y[:, 1]
    if case == "deficient-eigh":
        def refuse(*_):
            raise np.linalg.LinAlgError("forced")

        monkeypatch.setattr(np.linalg, "cholesky", refuse)
    got = tlr._cholqr2(torch.from_numpy(Y)).numpy()
    ref = np.asarray(jlr._cholqr2(jnp.asarray(Y), None))
    if case == "full-rank":
        assert np.allclose(got.T @ got, np.eye(6), atol=1e-12)
        assert np.max(np.abs(got - ref)) < 1e-10
    Q = np.linalg.qr(Y[:, :4])[0]
    for out in (got, ref):
        u, sv, _ = np.linalg.svd(out, full_matrices=False)
        span = u[:, sv > 1e-6 * sv[0]]
        assert np.max(np.abs(span @ (span.T @ Q) - Q)) < 1e-8  # the panel's span is kept


def test_wquad_clamp_keeps_float32_likelihoods_finite():
    """tests/test_lowrank.py:281: traits in span(U) at a large scale make the
    Woodbury totals cancel to float32 noise as h2 -> 1; clamped at zero,
    the likelihoods stay finite and bounded and the fits inside [0, 1]."""
    rng = np.random.default_rng(0)
    n, k, m = 2048, 8, 24
    U = np.linalg.qr(rng.normal(size=(n, k)))[0]
    lam = np.linspace(3.0, 0.5, k)
    Y = (U @ rng.normal(size=(k, m))) * 1e3
    C = np.ones((n, 1))
    f32 = torch.float32
    lr = bt.LowRankKinship(U=torch.tensor(U, dtype=f32), lam=torch.tensor(lam, dtype=f32))
    kw = tlr._parts_kwargs(bt.FAST32)
    Ct = torch.tensor(C, dtype=f32)
    parts = {**tlr._shared_parts(Ct, lr, **kw),
             **tlr._trait_side_parts(torch.tensor(Y, dtype=f32), Ct, lr, **kw)}
    grid = torch.tensor([0.9, 0.999, 0.99999, 0.999999, 0.9999999], dtype=f32)
    ells = tlr.grid_null_ell_lowrank(parts, lr.lam, grid, (1.0, 0.0), n=n).numpy()
    assert np.isfinite(ells).all() and np.max(ells) < 1e9, np.max(ells)
    h2s = tlr.fit_h2_lowrank(parts, lr.lam, (1.0, 0.0), n=n).numpy()
    assert np.isfinite(h2s).all() and (h2s >= 0).all() and (h2s <= 1).all()
    assert float(tlr._wquad(torch.tensor(1.0), torch.tensor(-1.5))) == 0.0


# --- bulkscan ------------------------------------------------------------------------


_JAX_SCANS = {}


def _jax_bulkscan(data, preset, method):
    key = (preset, method)
    if key not in _JAX_SCANS:
        _JAX_SCANS[key] = bl.bulkscan(
            data["Y"], data["G"], data["lr"], data["covar"], method=method,
            precision=getattr(jcfg, preset), output_effects=method != "alt-grid",
        )
    return _JAX_SCANS[key]


def _lod_step_at(data, preset, h2_list):
    """The port's rank-k LOD step at given per-trait h2s."""
    prec = bt.precision_by_name(preset)
    dtype = prec.resolve_solve()
    lr = tlr.as_lowrank(data["lr"], dtype)
    C = torch.tensor(np.concatenate([np.ones((data["n"], 1)), data["covar"]], 1), dtype=dtype)
    parts = tlr._base_parts(torch.tensor(data["Y"], dtype=dtype),
                            torch.tensor(data["G"], dtype=dtype), C, lr,
                            **tlr._parts_kwargs(prec))
    kdt = prec.resolve_kernel()
    with with_highest_matmul():
        return tlr.lods_per_trait_lowrank(parts, lr.lam.to(kdt),
                                          torch.tensor(np.asarray(h2_list)).to(kdt),
                                          data["n"], precision=prec)


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
@pytest.mark.parametrize("preset", list(L_BAR))
def test_bulkscan_matches_jax(data, preset, method):
    """The three methods with covariates, with effects for the null methods."""
    ref = _jax_bulkscan(data, preset, method)
    got = bt.bulkscan(data["Y"], data["G"], data["lr"], data["covar"], method=method,
                      precision=bt.precision_by_name(preset), device="cpu",
                      output_effects=method != "alt-grid")
    assert str(got.L.dtype) == "torch." + str(np.asarray(ref.L).dtype)
    bar = L_BAR[preset]
    if method == "alt-grid":
        assert _maxdiff(got.L, ref.L) < bar
        assert np.array_equal(_np(got.h2_panel), _np(ref.h2_panel))
        return
    if method == "null-grid":
        assert np.array_equal(got.h2_null_list.numpy(), np.asarray(ref.h2_null_list))
        fields = ("L", "beta_mat", "beta_se_mat")
    else:
        window = WINDOW if preset == "EXACT64" else WINDOW32
        assert _maxdiff(_lod_step_at(data, preset, ref.h2_null_list), ref.L) < bar
        if preset == "BALANCED":
            # the port's float64 Brent against the JAX package's EXACT64 fit
            oracle = _jax_bulkscan(data, "EXACT64", method)
            assert _maxdiff(got.h2_null_list, oracle.h2_null_list) < 1e-5
            assert _maxdiff(got.L, oracle.L) < bar
            return
        assert _maxdiff(got.h2_null_list, ref.h2_null_list) <= window
        if preset != "EXACT64":
            return
        bar = BRENT_BAR
        fields = ("L", "beta_mat", "beta_se_mat")
    for f in fields:
        assert _maxdiff(getattr(got, f), getattr(ref, f)) < bar, f


def test_balanced_null_exact_meets_its_bar(data):
    """BALANCED rank-k null-exact within 1e-4 of EXACT64 (k = n, against
    the rotated engine): its Brent runs in the solve dtype. In the kernel
    dtype (the JAX package's choice) the float32 window, 3.4e-4 in h2, can
    move the LODs past that bar."""
    lr = jlr.kinship_lowrank_exact(data["K"], data["n"])
    got = bt.bulkscan(data["Y"], data["G"], lr, method="null-exact", precision=bt.BALANCED,
                      device="cpu")
    ref = bt.bulkscan(data["Y"], data["G"], data["K"], method="null-exact",
                      precision=bt.EXACT64, device="cpu")
    assert got.h2_null_list.dtype == torch.float64
    assert _maxdiff(got.h2_null_list, ref.h2_null_list) < 1e-5
    assert _maxdiff(got.L, ref.L) < 1e-4


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_trait_chunk_matches_unchunked(data, method):
    kw = dict(method=method, precision=bt.EXACT64, device="cpu")
    a = bt.bulkscan(data["Y"], data["G"], data["lr"], **kw)
    b = bt.bulkscan(data["Y"], data["G"], data["lr"], trait_chunk=7, **kw)
    assert _maxdiff(a.L, b.L) < (BRENT_BAR if method == "null-exact" else 1e-12)
    if method == "null-grid":
        assert torch.equal(a.h2_null_list, b.h2_null_list)


@pytest.mark.parametrize("case", ["null-grid", "null-grid-covar-reml", "null-exact", "alt-grid"])
def test_fullrank_equals_rotated_engine(case):
    """k = n: the Woodbury engine is algebraically the rotated one
    (tests/test_lowrank.py:41-68, :159-180); null-exact's two Brent runs
    optimize different parameterizations, so 1e-5 in h2 and 1e-6 in LOD
    there, as in the JAX package's test."""
    seed = {"null-grid": 5, "null-grid-covar-reml": 9, "null-exact": 41, "alt-grid": 43}[case]
    Y, G, K = _cohort(seed=seed)
    kw = dict(method=case.split("-covar")[0], precision=bt.EXACT64, device="cpu")
    covar = None
    if case == "null-grid-covar-reml":
        covar = np.random.default_rng(1).normal(size=(K.shape[0], 2))
        kw.update(reml=True, prior_variance=1.0, prior_sample_size=0.1)
    lr = bt.kinship_lowrank_exact(K, K.shape[0], device="cpu")
    lo = bt.bulkscan(Y, G, lr, covar, **kw)
    ref = bt.bulkscan(Y, G, K, covar, engine="xla", **kw)
    if case == "null-exact":
        assert _maxdiff(lo.h2_null_list, ref.h2_null_list) < 1e-5
        assert _maxdiff(lo.L, ref.L) < 1e-6
    elif case == "alt-grid":
        assert torch.equal(lo.h2_panel, ref.h2_panel)
        assert _maxdiff(lo.L, ref.L) < 1e-8
    else:
        assert torch.equal(lo.h2_null_list, ref.h2_null_list)
        assert _maxdiff(lo.L, ref.L) < 1e-8


def test_truncation_exact_at_true_rank():
    """K of exact rank r: k = r gives the rotated engine's LODs, k = 5 does
    not (tests/test_lowrank.py:71-90)."""
    rng = np.random.default_rng(2)
    n, r = 60, 15
    B = rng.normal(size=(n, r))
    K = B @ B.T
    K *= n / np.trace(K)
    Y, G, _ = _cohort(n=n)
    kw = dict(precision=bt.EXACT64, device="cpu")
    ref = bt.bulkscan(Y, G, K, **kw)
    err_r = _maxdiff(bt.bulkscan(Y, G, bt.kinship_lowrank_exact(K, r, device="cpu"), **kw).L, ref.L)
    err_5 = _maxdiff(bt.bulkscan(Y, G, bt.kinship_lowrank_exact(K, 5, device="cpu"), **kw).L, ref.L)
    assert err_r < 1e-8 and err_5 > 10 * max(err_r, 1e-10)


def test_guards_and_device(data):
    """The JAX package's refusals, and the device: factors that are CPU
    tensors run on the CPU without ``device``."""
    Y, G, lr, n = data["Y"], data["G"], data["lr"], data["n"]
    with pytest.raises(ValueError, match="method"):
        bt.bulkscan(Y, G, lr, method="banana", device="cpu")
    with pytest.raises(ValueError, match="weights"):
        bt.bulkscan(Y, G, lr, weights=np.ones(n), device="cpu")
    for call in (lambda: bt.bulkscan(Y, G, lr, method="alt-grid", engine="pallas", device="cpu"),
                 lambda: bt.bulkscan_perms(Y, G, lr, nperms=4, engine="pallas", device="cpu")):
        with pytest.raises(ValueError, match="not available for LowRankKinship"):
            call()
    tl = tlr.as_lowrank(lr)
    assert tl.U.device.type == "cpu" and tl.U.dtype == torch.float64
    res = bt.bulkscan(Y, G, tl, precision=bt.EXACT64)
    assert res.L.device.type == "cpu"
    assert _maxdiff(res.L, _jax_bulkscan_plain(data).L) < 1e-8


def _jax_bulkscan_plain(data):
    if "plain" not in _JAX_SCANS:
        _JAX_SCANS["plain"] = bl.bulkscan(data["Y"], data["G"], data["lr"], precision=jcfg.EXACT64)
    return _JAX_SCANS["plain"]


def test_memory_sized_chunks_and_host_blocks(data, monkeypatch):
    """trait_chunk=None sizes the rank-k engine's chunks from its own
    footprint model: under a budget that fits one 64-trait tile but not all
    the traits the call chunks; under one that fits no (p, m) result it
    runs host blocks. Both equal the one-block call (EXACT64)."""
    n, p = data["G"].shape
    Y = np.tile(data["Y"], (1, 8))  # 192 traits: three tiles
    m = Y.shape[1]
    one = bt.bulkscan(Y, data["G"], data["lr"], precision=bt.EXACT64, device="cpu", trait_chunk=m)
    static = mem.lowrank_static_bytes(n, p, m, 1, 20, 8) * mem._STATIC_HEADROOM
    budget = int(static + mem.lowrank_chunk_bytes(n, p, 20, 100, 10, 8))
    assert mem.auto_trait_chunk(n, p, m, itemsize=8, rank=20, budget=budget) == 64
    monkeypatch.setattr(mem, "device_memory_budget", lambda device=None: budget)
    chunked = bt.bulkscan(Y, data["G"], data["lr"], precision=bt.EXACT64, device="cpu")
    assert _maxdiff(chunked.L, one.L) < 1e-12
    # room for one 64-trait host block with its two blocks' outputs, but not
    # for the whole (p, m) result beside a 64-trait chunk
    base = int((mem.lowrank_static_bytes(n, p, 0, 1, 20, 8) + 2 * n * m * 8) * mem._STATIC_HEADROOM)
    per_trait = mem.lowrank_chunk_bytes(n, p, 20, 1, 10, 8) + int(2 * p * 8 * mem._STATIC_HEADROOM)
    small = base + 64 * per_trait + p * m * 8 // 6
    with pytest.raises(ValueError):
        mem.auto_trait_chunk(n, p, m, itemsize=8, rank=20, budget=small)
    monkeypatch.setattr(mem, "device_memory_budget", lambda device=None: small)
    blocked = bt.bulkscan(Y, data["G"], data["lr"], precision=bt.EXACT64, device="cpu")
    assert isinstance(blocked.L, np.ndarray)
    assert _maxdiff(blocked.L, one.L) < 1e-12


# --- bulkscan_perms ------------------------------------------------------------------


@pytest.mark.parametrize("method", ["null-grid", "null-exact"])
@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
def test_bulkscan_perms_matches_jax(data, preset, method):
    """The JAX package's shuffle indices through perm_idx=; trait blocks of
    7 and permutation chunks of 5 in the port."""
    Y, G, lr, covar = data["Y"], data["G"], data["lr"], data["covar"]
    ref = bl.bulkscan_perms(Y, G, lr, covar, nperms=NPERMS, method=method,
                            precision=getattr(jcfg, preset))
    got = bt.bulkscan_perms(Y, G, lr, covar, nperms=NPERMS, method=method, device="cpu",
                            precision=bt.precision_by_name(preset), perm_idx=_perm_idx(),
                            trait_chunk=7, perm_chunk=5)
    assert got.maxlods.shape == (Y.shape[1], NPERMS + 1)
    if method == "null-grid":
        assert np.array_equal(got.h2_null_list.numpy(), np.asarray(ref.h2_null_list))
        assert _maxdiff(got.maxlods, ref.maxlods) < L_BAR[preset]
        assert _maxdiff(got.sigma2_e_list, ref.sigma2_e_list) < L_BAR[preset]
        assert _maxdiff(got.log10_adj_pvals, ref.log10_adj_pvals) < 1e-12
    elif preset == "EXACT64":
        assert _maxdiff(got.h2_null_list, ref.h2_null_list) <= WINDOW
        assert _maxdiff(got.maxlods, ref.maxlods) < BRENT_BAR
    else:
        # the port's float64 Brent against the JAX package's EXACT64 sweep
        oracle = bl.bulkscan_perms(Y, G, lr, covar, nperms=NPERMS, method=method,
                                   precision=jcfg.EXACT64)
        assert _maxdiff(got.h2_null_list, oracle.h2_null_list) < 1e-5
        assert _maxdiff(got.maxlods, oracle.maxlods) < L_BAR[preset]


def test_lowrank_perm_ops_match_jax(data):
    """ops/bulkperm.py's rank-k whitening parts, marker parts and numerator
    step against the JAX package's on the same inputs (EXACT64)."""
    Y, G, n = data["Y"], data["G"], data["n"]
    lr = data["lr"]
    C = np.concatenate([np.ones((n, 1)), data["covar"]], 1)
    h2 = np.linspace(0.05, 0.9, Y.shape[1])
    t = {k: torch.tensor(np.asarray(v)) for k, v in dict(Y=Y, G=G, C=C, U=lr.U, lam=lr.lam,
                                                            h2=h2).items()}
    sm1, Q, wrn = tops.perm_trait_parts_lowrank(t["Y"], t["C"], t["U"], t["lam"], t["h2"],
                                                precision=bt.EXACT64)
    jsm1, jQ, jwrn = jops.perm_trait_parts_lowrank(Y, C, lr.U, lr.lam, h2, precision=jcfg.EXACT64)
    for a, b in ((sm1, jsm1), (Q, jQ), (wrn, jwrn)):
        assert _maxdiff(a, b) < 1e-10
    mp = tops.lowrank_perm_marker_parts(t["G"], t["U"], precision=bt.EXACT64)
    jmp = jops.lowrank_perm_marker_parts(G, lr.U, precision=jcfg.EXACT64)
    for a, b in zip(mp, jmp):
        assert _maxdiff(a, b) < 1e-10
    qX, xn = tops.lowrank_perm_trait_marker_parts(t["G"], t["U"], *mp, sm1[:5], Q[:5],
                                                  precision=bt.EXACT64)
    jqX, jxn = jops.lowrank_perm_trait_marker_parts(G, lr.U, *jmp, jsm1[:5], jQ[:5],
                                                    precision=jcfg.EXACT64)
    assert _maxdiff(qX, jqX) < 1e-10 and _maxdiff(xn, jxn) < 1e-10
    idx = _perm_idx()(n)
    r2 = tops.max_r2_perms_lowrank(t["G"], t["U"], mp[0], sm1[:5], Q[:5], qX, xn, wrn[:, :5],
                                   torch.from_numpy(idx), precision=bt.EXACT64)
    jr2 = jops.max_r2_perms_lowrank_xla(G, lr.U, jmp[0], jsm1[:5], jQ[:5], jqX, jxn, jwrn[:, :5],
                                        jnp.asarray(idx), precision=jcfg.EXACT64)
    assert _maxdiff(r2, jr2) < 1e-12


def test_bulkscan_perms_checkpoint_resume(data, tmp_path):
    """A lost trait chunk is recomputed on resume to the same rows; another
    rank k is refused in the same directory."""
    kw = dict(nperms=NPERMS, precision=bt.EXACT64, device="cpu", perm_idx=_perm_idx(),
              trait_chunk=10, checkpoint=str(tmp_path))
    first = bt.bulkscan_perms(data["Y"], data["G"], data["lr"], **kw)
    saved = sorted(tmp_path.glob("maxlods_*.npy"))
    assert len(saved) == 3
    saved[1].unlink()
    again = bt.bulkscan_perms(data["Y"], data["G"], data["lr"], **kw)
    assert torch.equal(first.maxlods, again.maxlods)
    other = jlr.kinship_lowrank_exact(data["K"], 10)
    with pytest.raises(ValueError, match="different"):
        bt.bulkscan_perms(data["Y"], data["G"], other, **kw)


# --- single-trait scans ----------------------------------------------------------------


@pytest.mark.parametrize("case", ["null", "alt", "alt-reml", "perms", "profile"])
def test_scan_matches_jax(case):
    """scan on a rank-k kinship: null with effects and p-values, alt with
    effects (ML and REML), permutations with effects (the JAX package's
    shuffle indices), and the profile likelihood.

    The null h2 is the host float64 fit on the trait's (k,)-sized
    projections, which each package sums in its own order: on a likelihood
    flat to its last bits near the optimum the two fits may stop at
    different points of its stopping window, so h2 is held to BRENT_BAR,
    the alt scans (which follow it and their own Brent fits) too, the
    per-marker alt h2 to 3e-7 (test_torch_scan.py), everything else to
    1e-8, and the null LOD step at the JAX package's own h2 to 1e-8."""
    y, G, K, covar = _single_trait(seed=53 if case.startswith("alt") else 57)
    lr = jlr.kinship_lowrank_exact(K, 30)
    n = K.shape[0]
    kw = dict(covar=covar, output_effects=case != "profile", output_pvals=True)
    if case.startswith("alt"):
        kw.update(assumption="alt", reml=case == "alt-reml")
    if case == "perms":
        kw.update(permutation_test=True, nperms=NPERMS, rndseed=3)
    if case == "profile":
        kw.update(profile_ll=True, marker_id=7)
    ref = bl.scan(y, G, lr, precision=jcfg.EXACT64, **kw)
    if case == "perms":
        kw.pop("rndseed")
        kw["perm_idx"] = np.asarray(jops.permutation_indices(n, NPERMS, 3))
    got = bt.scan(y, G, lr, precision=bt.EXACT64, device="cpu", **kw)
    if case == "profile":
        (got, prof), (ref, jprof) = got, ref
        assert _maxdiff(prof.ll_list_null, jprof[0]) < 1e-8
        assert _maxdiff(prof.ll_list_alt, jprof[1]) < 1e-8
    bar = BRENT_BAR if case.startswith("alt") else 1e-8
    assert abs(float(got.h2_null) - float(ref.h2_null)) < BRENT_BAR
    assert abs(float(got.sigma2_e) - float(ref.sigma2_e)) < bar
    if case.startswith("alt"):
        assert _maxdiff(got.h2_each_marker, ref.h2_each_marker) < 3e-7
    for f in ("lod", "log10pvals", "beta", "beta_se", "L_perms", "log10Pvals_perms"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert _maxdiff(a, b) < bar, f
    if case == "null":
        t = {k: torch.tensor(np.asarray(v)) for k, v in dict(
            y=y[:, None], G=G, C=np.concatenate([np.ones((n, 1)), covar], 1), U=lr.U,
            lam=lr.lam, h2=ref.h2_null).items()}
        lod = tlr._scan_null_lowrank_core(t["y"], t["G"], t["C"], t["U"], t["lam"], t["h2"], n=n,
                                          prior=(0.0, 0.0), reml=False, precision=bt.EXACT64)[0]
        assert _maxdiff(lod, ref.lod) < 1e-8


def test_scan_perms_lite_route(data):
    """scan_perms_lite takes the rank-k permutation scan: the JAX package's
    columns given its indices, and scan(permutation_test=True)'s own."""
    y, G, K, covar = _single_trait(seed=59)
    lr = jlr.kinship_lowrank_exact(K, K.shape[0])
    idx = np.asarray(jops.permutation_indices(K.shape[0], NPERMS, 1))
    ref = bl.scan_perms_lite(y, G, covar, lr, nperms=NPERMS, rndseed=1, precision=jcfg.EXACT64)
    got = bt.scan_perms_lite(y, G, covar, lr, nperms=NPERMS, perm_idx=idx, device="cpu",
                             precision=bt.EXACT64)
    # the host fit on projections summed in another order (test_scan_matches_jax)
    assert abs(float(got.h2_null) - float(ref.h2_null)) < BRENT_BAR
    assert _maxdiff(got.lod, ref.lod) < BRENT_BAR and _maxdiff(got.L_perms, ref.L_perms) < BRENT_BAR
    via_scan = bt.scan(y, G, lr, covar=covar, permutation_test=True, nperms=NPERMS, perm_idx=idx,
                       prior_variance=1.0, device="cpu", precision=bt.EXACT64)
    assert torch.equal(via_scan.L_perms, got.L_perms)
    rot = bt.scan_perms_lite(y, G, covar, K, nperms=NPERMS, perm_idx=idx, device="cpu",
                             precision=bt.EXACT64)
    assert _maxdiff(got.lod, rot.lod) < 1e-7  # k = n: the rotated scan, to Brent's tolerance


@pytest.mark.parametrize("reml", [False, True])
def test_fit_lmm_host_lowrank_equals_jax(data, reml):
    """The host float64 fit on a trait's projections: numpy in both
    packages, the same operations in the same order."""
    rng = np.random.default_rng(4)
    k, c = 20, 3
    parts = dict(CtC=np.eye(c) * 60 + 1.0, CtY=rng.normal(size=c), yty=80.0,
                 R=rng.normal(size=(k, c)), Q=rng.normal(size=k) * 2)
    lam = np.asarray(data["lr"].lam)
    got = fit_lmm_host_lowrank(parts, lam, 60, (1.0, 0.1), reml=reml, optim_interval=2)
    ref = jax_fit_lmm_host_lowrank(parts, lam, 60, (1.0, 0.1), reml=reml, optim_interval=2)
    assert got.h2 == ref.h2 and got.sigma2 == ref.sigma2 and got.ell == ref.ell
    assert np.max(np.abs(got.b - ref.b)) < 1e-12


# --- missing values and streaming ---------------------------------------------------


@pytest.mark.parametrize("rows", ["complete", "subset"])
def test_subset_kinship_refactorizes_like_jax(data, rows):
    idx = np.arange(data["n"]) if rows == "complete" else np.setdiff1d(np.arange(data["n"]),
                                                                       [3, 11, 40])
    got = subset_kinship(data["lr"], idx)
    ref = jax_subset_kinship(data["lr"], idx)
    assert isinstance(got, bt.LowRankKinship) and got.U.shape == np.shape(ref.U)
    assert _maxdiff(got.U, ref.U) < 1e-12 and _maxdiff(got.lam, ref.lam) < 1e-12
    # the refactorization is the subset of U diag(lam) U'
    U, lam = np.asarray(data["lr"].U), np.asarray(data["lr"].lam)
    Ks = (U * lam) @ U.T
    Ug, lg = got.U.numpy(), got.lam.numpy()
    assert np.max(np.abs((Ug * lg) @ Ug.T - Ks[np.ix_(idx, idx)])) < 1e-12


@pytest.mark.parametrize("missing", ["mask", "drop"])
def test_masked_and_dropped_match_jax(data, missing):
    Y = data["Y"].copy()
    Y[3, 2] = Y[5, 4] = Y[5, 9] = np.nan
    kw = dict(missing=missing)
    ref = bl.bulkscan(Y, data["G"], data["lr"], precision=jcfg.EXACT64, **kw)
    got = bt.bulkscan(Y, data["G"], data["lr"], precision=bt.EXACT64, device="cpu", **kw)
    assert _maxdiff(got.L, ref.L) < 1e-8
    assert np.array_equal(got.h2_null_list.numpy(), np.asarray(ref.h2_null_list), equal_nan=True)
    ref = bl.bulkscan_perms(Y, data["G"], data["lr"], nperms=NPERMS, precision=jcfg.EXACT64, **kw)
    got = bt.bulkscan_perms(Y, data["G"], data["lr"], nperms=NPERMS, precision=bt.EXACT64,
                            device="cpu", perm_idx=_perm_idx(), **kw)
    assert _maxdiff(got.maxlods, ref.maxlods) < 1e-8


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_streamed_matches_inmemory_and_jax(data, tmp_path, method):
    """Blocks of 23 markers (80 = 3 x 23 + 11: the last one zero-padded)
    into a memmap: the in-memory rank-k scan to 1e-10, the JAX package's
    streamed one to its bars."""
    Y, G, lr, covar = data["Y"], data["G"], data["lr"], data["covar"]
    effects = method != "alt-grid"
    kw = dict(method=method, output_effects=effects)
    p, m = G.shape[1], Y.shape[1]
    out = np.memmap(tmp_path / "L.dat", dtype=np.float64, mode="w+", shape=(p, m))
    st = bt.bulkscan_streamed(Y, G, lr, covar, precision=bt.EXACT64, device="cpu",
                              marker_block=23, out=out, **kw)
    inmem = bt.bulkscan(Y, G, lr, covar, precision=bt.EXACT64, device="cpu", **kw)
    ref = bl.bulkscan_streamed(Y, G, lr, covar, precision=jcfg.EXACT64, marker_block=23, **kw)
    assert st.L is out
    fields = ("L", "beta_mat", "beta_se_mat", "h2_null_list") if effects else ("L",)
    bar = BRENT_BAR if method == "null-exact" else 1e-8
    for f in fields:
        assert _maxdiff(getattr(st, f), getattr(inmem, f)) < 1e-10, f
        assert _maxdiff(getattr(st, f), getattr(ref, f)) < bar, f
    if not effects:
        # the JAX package's streamed panel is float32, the in-memory one's dtype here
        assert np.array_equal(st.h2_panel, _np(inmem.h2_panel))
        assert np.array_equal(st.h2_panel.astype(np.float32), np.asarray(ref.h2_panel))


def test_perms_streamed_matches_inmemory_and_jax(data, tmp_path):
    Y, G, lr = data["Y"], data["G"], data["lr"]
    kw = dict(nperms=NPERMS, precision=bt.EXACT64, device="cpu", perm_idx=_perm_idx())
    st = bt.bulkscan_perms_streamed(Y, G, lr, marker_block=23, checkpoint=str(tmp_path), **kw)
    inmem = bt.bulkscan_perms(Y, G, lr, **kw)
    ref = bl.bulkscan_perms_streamed(Y, G, lr, nperms=NPERMS, marker_block=23,
                                     precision=jcfg.EXACT64)
    assert _maxdiff(st.maxlods, inmem.maxlods) < 1e-12
    assert _maxdiff(st.maxlods, ref.maxlods) < 1e-8
    resumed = bt.bulkscan_perms_streamed(Y, G, lr, marker_block=23, checkpoint=str(tmp_path), **kw)
    assert torch.equal(resumed.maxlods, st.maxlods)
