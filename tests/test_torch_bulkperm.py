"""The permutation path: ``bulklmm_tpu_torch.bulkscan_perms`` and its
modules against the JAX package on the CPU, on the ``perm_data`` shape of
tests/test_bulkperm.py (n = 52, p = 96, m = 4, nperms = 24).

The two packages draw their shuffle indices with different generators, so
every comparison passes the JAX package's indices to the port
(``perm_idx``) and holds the maxima column by column. Bars on the maxima
are test_torch_bulkscan.py's per preset (the JAX package's own bars against
its float64 oracle): 1e-9 EXACT64, 1e-4 MIXED and BALANCED, 1e-3 FAST32 and
THROUGHPUT. The module tests state their own. The CUDA kernel itself runs
only on the card, where chip_smoke.py holds it against the plain version
tested here.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.models import bulkperm as jmodel
from bulklmm_tpu.ops import bulkperm as jops
from bulklmm_tpu.ops.lowrank import LowRankKinship
from bulklmm_tpu.pallas import bulkperm_fused as jfused
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
from bulklmm_tpu_torch.kernels.split import matmul_bf16x3
from bulklmm_tpu_torch.models import bulkperm as tmodel
from bulklmm_tpu_torch.ops import bulkperm as tops
from bulklmm_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)

LOD_BAR = {"EXACT64": 1e-9, "MIXED": 1e-4, "BALANCED": 1e-4, "FAST32": 1e-3, "THROUGHPUT": 1e-3}
SAME_H2 = ("EXACT64", "MIXED", "BALANCED")
NPERMS, SEED = 24, 7
# max |dLOD| of bf16x3 maxima on operands that two float32 preparations
# made: the Pallas kernels' bar (tests/test_pallas_*.py); a bf16 half that
# crosses a rounding midpoint under a one-ulp change moves its lo * lo term
# by up to 2^-16 |a b|, about 1.8e-5 in LOD at n = 52
BF16X3_BAR = 5e-5
# Brent's tolerance window on [0, 1], doubled: the two packages' Brents
# stop at different points inside it (test_torch_nullexact.py)
H2_WINDOW = 2 * 1.4e-8


@pytest.fixture(scope="module")
def perm_data():
    rng = np.random.default_rng(11)
    n, p, m = 52, 96, 4
    G = rng.choice([0.0, 0.5, 1.0], size=(n, p))
    K = np.asarray(bl.calc_kinship(G))
    lam, U = np.linalg.eigh(K)
    Y = np.stack(
        [U @ (np.sqrt(np.abs(lam)) * rng.normal(size=n)) * s + rng.normal(size=n)
         for s in [0.3, 1.0, 0.0, 2.0]],
        axis=1,
    )
    Y[:, 1] += G[:, 7] * 2.0
    return G, Y, K


def _jax_idx(n, nperms=NPERMS, seed=SEED, original=True):
    return np.asarray(jops.permutation_indices(n, nperms, seed, original=original))


def _np(t):
    return t.detach().double().numpy()


def _maxdiff(port, ref):
    return float(np.max(np.abs(_np(port) - np.asarray(ref, dtype=np.float64))))


def _same_dtype(port, ref):
    return str(port.dtype).removeprefix("torch.") == np.asarray(ref).dtype.name


def _run(data, preset, *, nperms=NPERMS, seed=SEED, original=True, **kw):
    """The same call through both packages, the port on the CPU and fed the
    JAX package's shuffle indices."""
    G, Y, K = data
    covar = kw.pop("covar", None)
    ref = bl.bulkscan_perms(Y, G, K, covar, nperms=nperms, rndseed=seed,
                            original=original, precision=getattr(jcfg, preset), **kw)
    idx = _jax_idx(Y.shape[0], nperms, seed, original)
    port = bt.bulkscan_perms(Y, G, K, covar, nperms=nperms, rndseed=seed,
                             original=original, precision=bt.precision_by_name(preset),
                             perm_idx=idx, device="cpu", **kw)
    return port, ref


def _compare(port, ref, preset):
    assert tuple(port.maxlods.shape) == np.asarray(ref.maxlods).shape
    assert _same_dtype(port.maxlods, ref.maxlods)
    assert _maxdiff(port.maxlods, ref.maxlods) < LOD_BAR[preset]
    if preset in SAME_H2:
        assert np.array_equal(port.h2_null_list.numpy(), np.asarray(ref.h2_null_list))
    assert _maxdiff(port.sigma2_e_list, ref.sigma2_e_list) < max(LOD_BAR[preset], 1e-6)


# --- the rotated state both packages' modules are fed ------------------------


@pytest.fixture(scope="module")
def rotated(perm_data):
    """Rotated operands with c = 3 covariate columns and a per-trait h2."""
    G, Y, K = perm_data
    rng = np.random.default_rng(5)
    n = Y.shape[0]
    lam, U = np.linalg.eigh(K)
    C = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    return dict(Y0=U.T @ Y, X0m=U.T @ G, C0=U.T @ C, lam=lam,
                h2=np.array([0.1, 0.8, 0.0, 0.55]))


def _parts(rotated, preset, c):
    """(jax, torch) per-trait state from ``perm_trait_parts`` of each package
    on the first ``c`` covariate columns."""
    names = ("Y0", "C0", "lam", "h2")
    cut = dict(rotated, C0=rotated["C0"][:, :c])
    jS, jQ, jw = jops.perm_trait_parts(
        *(jnp.asarray(cut[k]) for k in names), precision=getattr(jcfg, preset))
    tS, tQ, tw = tops.perm_trait_parts(
        *(torch.from_numpy(cut[k]) for k in names), precision=bt.precision_by_name(preset))
    return (jS, jQ, jw), (tS, tQ, tw)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("preset, bar", [("EXACT64", 1e-10), ("FAST32", 1e-5)])
def test_perm_trait_parts_match_jax(rotated, preset, bar, c):
    (jS, jQ, jw), (tS, tQ, tw) = _parts(rotated, preset, c)
    assert _same_dtype(tS, jS) and _same_dtype(tw, jw) and len(tQ) == len(jQ) == c
    assert _maxdiff(tS, jS) < bar and _maxdiff(tw, jw) < bar
    for a, b in zip(tQ, jQ):
        assert _maxdiff(a, b) < bar
    # unit residuals, orthogonal to each trait's weighted-covariate basis
    assert torch.allclose((tw * tw).sum(0), torch.ones(4, dtype=tw.dtype), atol=100 * bar)
    assert float((tQ[0] * tw).sum(0).abs().max()) < 100 * bar


def test_perm_trait_parts_mask_a_covariate_explained_trait(rotated):
    """A trait inside the covariates' span residualizes to rounding noise;
    both packages zero it instead of normalizing the noise."""
    data = dict(rotated, Y0=rotated["Y0"].copy())
    data["Y0"][:, 2] = 3.0 * data["C0"][:, 1] - data["C0"][:, 0]
    (_, _, jw), (_, _, tw) = _parts(data, "EXACT64", 3)
    assert np.all(np.asarray(jw)[:, 2] == 0) and torch.all(tw[:, 2] == 0)
    assert _maxdiff(tw, jw) < 1e-10


def _stack(jQ, tQ):
    return jnp.transpose(jnp.stack(jQ, 0), (2, 0, 1)), torch.stack(tQ, 0).permute(2, 0, 1)


@pytest.mark.parametrize("preset, bar", [("EXACT64", 1e-10), ("FAST32", 1e-5)])
def test_perm_trait_marker_parts_match_jax(rotated, preset, bar):
    data = dict(rotated, X0m=rotated["X0m"].copy())
    data["X0m"][:, 9] = 2.0 * data["C0"][:, 2]  # collinear with a covariate
    data["X0m"][:, 40] = 0.0  # no information at all
    (jS, jQ, _), (tS, tQ, _) = _parts(data, preset, 3)
    jQs, tQs = _stack(jQ, tQ)
    jpX, jxn = jops.perm_trait_marker_parts(
        jnp.asarray(data["X0m"]), jS.T, jQs, precision=getattr(jcfg, preset))
    tpX, txn = tops.perm_trait_marker_parts(
        torch.from_numpy(data["X0m"]), tS.T, tQs, precision=bt.precision_by_name(preset))
    assert tuple(tpX.shape) == (4, 3, 96) and tuple(txn.shape) == (4, 96)
    assert _same_dtype(txn, jxn)
    inf_j, inf_t = np.isinf(np.asarray(jxn)), torch.isinf(txn).numpy()
    assert np.array_equal(inf_j, inf_t) and inf_t[:, 9].all() and inf_t[:, 40].all()
    assert inf_t.sum() == 8
    assert _maxdiff(tpX, jpX) < 10 * bar  # projections of columns of norm ~5
    assert np.max(np.abs(_np(txn)[~inf_t] - np.asarray(jxn, dtype=np.float64)[~inf_j])) < 100 * bar


def _state(rotated, preset, c, dtype):
    """The JAX package's per-trait state, carried into the port's tensors."""
    (jS, jQ, jw), _ = _parts(rotated, preset, c)
    jQs = jnp.transpose(jnp.stack(jQ, 0), (2, 0, 1))
    idx = _jax_idx(rotated["Y0"].shape[0])
    jstate = (jS.T, jQs, jw, jnp.asarray(idx))
    tstate = tops.perm_state_from_numpy(
        np.asarray(jS.T), np.asarray(jQs), np.asarray(jw), idx, device="cpu", dtype=dtype)
    return jstate, tstate


def test_perm_state_from_numpy(rotated):
    _, (sw, Q, w, idx) = _state(rotated, "EXACT64", 3, torch.float32)
    assert [tuple(t.shape) for t in (sw, Q, w, idx)] == [(4, 52), (4, 3, 52), (52, 4), (25, 52)]
    assert sw.dtype == Q.dtype == w.dtype == torch.float32 and idx.dtype == torch.int64
    assert torch.equal(idx[0], torch.arange(52))


@pytest.mark.parametrize("c", [1, 3])
def test_max_r2_perms_plain_matches_jax(rotated, c):
    """The plain engine's chunk core on the same state: 1e-10 under EXACT64."""
    (jsw, jQ, jw, jidx), (sw, Q, w, idx) = _state(rotated, "EXACT64", c, torch.float64)
    X = rotated["X0m"]
    jpX, jxn = jops.perm_trait_marker_parts(jnp.asarray(X), jsw, jQ, precision=jcfg.EXACT64)
    ref = jops.max_r2_perms_xla(jnp.asarray(X), jsw, jQ, jpX, jxn, jw, jidx, precision=jcfg.EXACT64)
    Xt = torch.from_numpy(X)
    pX, xn = tops.perm_trait_marker_parts(Xt, sw, Q, precision=bt.EXACT64)
    out = tops.max_r2_perms_plain(Xt, sw, Q, pX, xn, w, idx, precision=bt.EXACT64)
    assert tuple(out.shape) == (4, 25) and out.dtype == torch.float64
    assert _maxdiff(out, ref) < 1e-10
    lod = tops.maxr2_to_lod(out, 52, precision=bt.EXACT64)
    assert _maxdiff(lod, jops.maxr2_to_lod(ref, 52, precision=jcfg.EXACT64)) < 1e-9


@pytest.mark.parametrize("preset", ["EXACT64", "MIXED", "BALANCED"])
def test_maxr2_to_lod_dtype_and_floor(preset):
    """The floor keeps r^2 >= 1 finite; the log's dtype follows the JAX
    package under each preset."""
    kdt = bt.precision_by_name(preset).resolve_kernel()
    r2 = np.array([[0.0, 0.5, 1.0, 1.0 + 1e-6]])
    ref = jops.maxr2_to_lod(jnp.asarray(r2, dtype=str(kdt).removeprefix("torch.")), 52,
                            precision=getattr(jcfg, preset))
    out = tops.maxr2_to_lod(torch.from_numpy(r2).to(kdt), 52, precision=bt.precision_by_name(preset))
    assert _same_dtype(out, ref)
    assert np.array_equal(np.isfinite(_np(out)), np.isfinite(np.asarray(ref)))
    fin = np.isfinite(_np(out))
    assert np.max(np.abs(_np(out)[fin] - np.asarray(ref, dtype=np.float64)[fin])) < 1e-3
    assert out[0, 0] == 0


@pytest.mark.parametrize("c", [1, 3])
def test_kernel_preparation_matches_jax(rotated, c):
    """``prepare_trait_block`` / ``prepare_chunk_inputs`` against the JAX
    wrapper's own preparation, float32 operands: 1e-6 on unit-scale S2, and
    1e-6 relative on inv_xn."""
    (jsw, jQ, jw, jidx), (sw, Q, w, idx) = _state(rotated, "FAST32", c, torch.float32)
    X = rotated["X0m"].copy()
    X[:, 40] = 0.0
    jS2 = jfused.fused_perm_chunk_inputs(jsw, jQ, jw, jidx)
    jinv = jfused.fused_perm_trait_block(jnp.asarray(X), jsw, jQ, precision=jcfg.FAST32)
    S2 = bf.prepare_chunk_inputs(sw, Q, w, idx)
    inv = bf.prepare_trait_block(torch.from_numpy(X), sw, Q, precision=bt.FAST32)
    assert tuple(S2.shape) == (4, 52, 25) and tuple(inv.shape) == (4, 96)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in (S2, inv))
    assert _maxdiff(S2, jS2) < 1e-6
    assert torch.all(inv[:, 40] == 0) and bool(torch.isfinite(inv).all())
    rel = np.abs(_np(inv) - np.asarray(jinv, dtype=np.float64)) / np.maximum(np.asarray(jinv), 1e-30)
    assert rel.max() < 1e-5


@pytest.mark.parametrize("c, mb, K", [(1, 4, 25), (3, 3, 25), (3, 4, 17), (1, 3, 1)],
                         ids=["c1", "c3-ragged-traits", "c3-K17", "observed-only"])
def test_plain_kernel_version_matches_pallas_interpret(rotated, c, mb, K):
    """``bulkperm_maxr2_plain`` + ``maxr2_to_lod`` against the Pallas kernel
    in interpret mode on the same operands: 1e-5, the JAX test's own bar
    (tests/test_bulkperm.py:93). The Pallas wrapper needs 8-trait blocks, so
    its operands are zero-padded; the port's take the ragged block as it is."""
    _, (sw, Q, w, idx) = _state(rotated, "FAST32", c, torch.float32)
    X = torch.from_numpy(rotated["X0m"]).float()
    S2 = bf.prepare_chunk_inputs(sw[:mb], Q[:mb], w[:, :mb], idx[:K])
    inv = bf.prepare_trait_block(X, sw[:mb], Q[:mb], precision=bt.FAST32)
    pad = 8 - mb
    ref = jfused.fused_perm_maxlods(
        jnp.asarray(X.numpy()), jnp.pad(jnp.asarray(S2.numpy()), ((0, pad), (0, 0), (0, 0))),
        jnp.pad(jnp.asarray(inv.numpy()), ((0, pad), (0, 0))), n=52, tile_p=32, interpret=True,
    )[:mb]
    out = bf.fused_perm_maxlods(X, S2, inv, n=52)
    assert tuple(out.shape) == (mb, K) and out.dtype == torch.float32
    assert _maxdiff(out, ref) < 1e-5
    assert torch.equal(out, bf.fused_perm_maxlods_reference(X, S2, inv, n=52))
    assert torch.equal(out, tops.maxr2_to_lod(bf.bulkperm_maxr2_plain(X, S2, inv), 52))
    assert not launch_counts


@pytest.mark.parametrize("c, mb, K", [(1, 4, 25), (3, 3, 25), (1, 3, 1)],
                         ids=["c1", "c3-ragged-traits", "observed-only"])
def test_bf16x3_plain_version_matches_pallas_interpret_at_high(rotated, c, mb, K):
    """Under ``dot_precision="high"`` the plain version takes the kernel's
    bf16x3 products (``split.py::matmul_bf16x3``), as the Pallas kernel at
    HIGH splits its dot into bf16 passes in interpret mode: 1e-5 between
    the two, the bar of the other precisions; and it is not the float32
    result."""
    _, (sw, Q, w, idx) = _state(rotated, "FAST32", c, torch.float32)
    X = torch.from_numpy(rotated["X0m"]).float()
    S2 = bf.prepare_chunk_inputs(sw[:mb], Q[:mb], w[:, :mb], idx[:K])
    inv = bf.prepare_trait_block(X, sw[:mb], Q[:mb], precision=bt.FAST32)
    pad = 8 - mb
    ref = jfused.fused_perm_maxlods(
        jnp.asarray(X.numpy()), jnp.pad(jnp.asarray(S2.numpy()), ((0, pad), (0, 0), (0, 0))),
        jnp.pad(jnp.asarray(inv.numpy()), ((0, pad), (0, 0))), n=52, tile_p=32, interpret=True,
        dot_precision=jcfg.THROUGHPUT.gemm_precision,
    )[:mb]
    out = bf.fused_perm_maxlods(X, S2, inv, n=52, dot_precision="high")
    assert tuple(out.shape) == (mb, K) and out.dtype == torch.float32
    assert _maxdiff(out, ref) < 1e-5
    assert torch.equal(out, bf.fused_perm_maxlods_reference(X, S2, inv, n=52, dot_precision="high"))
    split = tops.maxr2_to_lod(bf._maxr2_by_blocks(X, S2, inv, matmul_bf16x3), 52)
    assert torch.equal(out, split)
    assert float((out - bf.fused_perm_maxlods(X, S2, inv, n=52)).abs().max()) > 0
    assert not launch_counts


def test_bf16x3_moves_with_one_ulp_operand_changes():
    """Operands changed by up to two units in the last place move the bf16x3
    maxima by more than the float32 ones (a changed half, where a value
    crosses a bf16 rounding midpoint, moves the dropped lo * lo term) and by
    less than BF16X3_BAR: the gap between two float32 preparations that
    test_pallas_interpret_is_the_plain_kernel_version allows for."""
    rng = np.random.default_rng(0)
    n, p, mb, K = 52, 96, 4, 25
    X = torch.from_numpy(rng.normal(size=(n, p)).astype(np.float32))
    S2 = torch.from_numpy(rng.normal(size=(mb, n, K)).astype(np.float32))
    inv = ((1.0 / (X * X).sum(0)) / n).expand(mb, p).contiguous()

    def bump(t):
        ulps = torch.from_numpy(rng.integers(-2, 3, size=t.shape).astype(np.int32))
        return (t.view(torch.int32) + ulps).view(torch.float32)

    moved = {"highest": 0.0, "high": 0.0}
    for _ in range(8):
        Xb, S2b = bump(X), bump(S2)
        for name in moved:
            a = bf.fused_perm_maxlods(X, S2, inv, n=n, dot_precision=name)
            b = bf.fused_perm_maxlods(Xb, S2b, inv, n=n, dot_precision=name)
            moved[name] = max(moved[name], float((a - b).abs().max()))
    assert moved["highest"] < moved["high"] < BF16X3_BAR


def test_plain_kernel_version_masks_and_sub_blocks(rotated, monkeypatch):
    """A masked trait (all-zero S2) gives max r^2 = 0 exactly, a masked marker
    (inv_xn = 0) cannot win, and the trait sub-blocks of the plain version
    do not change the result."""
    _, (sw, Q, w, idx) = _state(rotated, "FAST32", 3, torch.float32)
    X = torch.from_numpy(rotated["X0m"]).float()
    S2 = bf.prepare_chunk_inputs(sw, Q, w, idx)
    inv = bf.prepare_trait_block(X, sw, Q, precision=bt.FAST32)
    whole = bf.bulkperm_maxr2_plain(X, S2, inv)
    S2[2] = 0.0
    best = (torch.einsum("np,tnk->tpk", X, S2) ** 2 * inv[:, :, None]).argmax(1)[0, 0]
    inv[0, best] = 0.0
    out = bf.bulkperm_maxr2_plain(X, S2, inv)
    assert torch.all(out[2] == 0) and out[0, 0] < whole[0, 0]
    assert torch.equal(out[1], whole[1]) and torch.equal(out[3], whole[3])
    monkeypatch.setattr(bf, "PLAIN_BUDGET_BYTES", 4 * 96 * 25)  # one trait per sub-block
    assert torch.equal(bf.bulkperm_maxr2_plain(X, S2, inv), out)


def test_cuda_wrapper_refuses_cpu_tensors(rotated):
    _, (sw, Q, w, idx) = _state(rotated, "FAST32", 1, torch.float32)
    X = torch.from_numpy(rotated["X0m"]).float()
    S2 = bf.prepare_chunk_inputs(sw, Q, w, idx)
    inv = bf.prepare_trait_block(X, sw, Q, precision=bt.FAST32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        bf.bulkperm_maxr2_cuda(X, S2, inv)
    assert not launch_counts


# --- bulkscan_perms end to end ------------------------------------------------


@pytest.mark.parametrize("preset", list(LOD_BAR))
def test_presets_match_jax(perm_data, preset):
    port, ref = _run(perm_data, preset)
    assert tuple(port.maxlods.shape) == (4, 25) and port.nperms == 24 and port.original
    _compare(port, ref, preset)
    assert torch.equal(port.lod_max, port.maxlods[:, 0])
    assert torch.equal(port.perm_maxima, port.maxlods[:, 1:])


@pytest.mark.parametrize("preset", list(LOD_BAR))
def test_null_exact_matches_jax(perm_data, preset):
    G, Y, K = perm_data
    ref = bl.bulkscan_perms(Y, G, K, nperms=8, rndseed=1, method="null-exact",
                            precision=getattr(jcfg, preset))
    port = bt.bulkscan_perms(Y, G, K, nperms=8, rndseed=1, method="null-exact",
                             precision=bt.precision_by_name(preset), device="cpu",
                             perm_idx=_jax_idx(52, 8, 1))
    assert _same_dtype(port.maxlods, ref.maxlods) and _same_dtype(port.h2_null_list, ref.h2_null_list)
    float64_fit = bt.precision_by_name(preset).resolve_solve() == torch.float64
    assert _maxdiff(port.h2_null_list, ref.h2_null_list) < (H2_WINDOW if float64_fit else 1e-3)
    # the maxima move with h2 inside Brent's window: the preset's bar, and
    # 1e-6 at least where the fit is float64
    assert _maxdiff(port.maxlods, ref.maxlods) < max(LOD_BAR[preset], 1e-6)
    assert _maxdiff(port.sigma2_e_list, ref.sigma2_e_list) < max(LOD_BAR[preset], 1e-6)


def _option_kwargs(option, n):
    rng = np.random.default_rng(5)
    covar = rng.normal(size=(n, 2))
    w = rng.uniform(0.5, 2.0, size=n)
    if option == "covariates+weights":
        return dict(covar=covar, weights=w)
    if option == "covariates":
        return dict(covar=covar)
    if option == "reml":
        return dict(reml=True)
    if option == "prior":
        return dict(prior_sample_size=3.0, prior_variance=0.8)
    if option == "h2_grid":
        return dict(h2_grid=[0.05, 0.25, 0.45, 0.65, 0.85])
    if option == "svd":
        return dict(decomp_scheme="svd")
    if option == "no-original":
        return dict(original=False)
    raise AssertionError(option)


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
@pytest.mark.parametrize("option", ["covariates+weights", "covariates", "reml", "prior",
                                    "h2_grid", "svd", "no-original"])
def test_options_match_jax(perm_data, option, preset):
    port, ref = _run(perm_data, preset, **_option_kwargs(option, 52))
    _compare(port, ref, preset)
    if option == "no-original":
        assert tuple(port.maxlods.shape) == (4, 24) and port.lod_max is None
        assert port.log10_adj_pvals is None and ref.log10_adj_pvals is None
        assert torch.equal(port.perm_maxima, port.maxlods)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_small_residual_marker_keeps_its_lod(perm_data, engine):
    """A marker whose residual on the intercept is 1e-3 of its size, and
    which carries trait 1's signal, keeps its LOD under EXACT64: the plain
    engine gives the JAX package's maxima within EXACT64's bar, and the
    kernel's route (its plain version, the markers off the covariates'
    span in float64 first) within the kernel's 1e-5 of them."""
    G, Y, K = perm_data
    G, Y = G.copy(), Y.copy()
    z = G[:, 7] - G[:, 7].mean()
    Y[:, 1] += 2.0 * z / z.std()
    G[:, 7] = 1.0 + 1e-3 * z / np.abs(z).max()
    _, ref = _run((G, Y, K), "EXACT64")
    port = bt.bulkscan_perms(Y, G, K, nperms=NPERMS, rndseed=SEED, precision=bt.EXACT64,
                             perm_idx=_jax_idx(52), device="cpu", engine=engine,
                             interpret=engine == "pallas")
    observed = bl.bulkscan(Y, G, K, precision=jcfg.EXACT64).L[7, 1]
    assert float(observed) > 5.0 and float(np.asarray(ref.maxlods)[1, 0]) == pytest.approx(float(observed))
    assert _maxdiff(port.maxlods, ref.maxlods) < (1e-5 if engine == "pallas" else LOD_BAR["EXACT64"])


def test_nperms_zero_keeps_the_observed_column(perm_data):
    port, ref = _run(perm_data, "EXACT64", nperms=0)
    assert tuple(port.maxlods.shape) == (4, 1) and port.log10_adj_pvals is None
    _compare(port, ref, "EXACT64")
    G, Y, K = perm_data
    L = bt.bulkscan(Y, G, K, precision=bt.EXACT64, device="cpu").L
    assert float((port.lod_max - L.max(0).values).abs().max()) < 1e-9
    with pytest.raises(ValueError, match="positive integer"):
        bt.bulkscan_perms(Y, G, K, nperms=0, original=False, device="cpu")


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_chunking_invariance(perm_data, engine):
    """Chunks of 3 traits and 7 permutations give the unchunked maxima:
    1e-12 in float64 (the plain engine), float32 rounding of another
    product width for the kernel's plain version (interpret mode)."""
    G, Y, K = perm_data
    kw = dict(nperms=24, rndseed=7, precision=bt.EXACT64, device="cpu", engine=engine,
              interpret=engine == "pallas")
    a = bt.bulkscan_perms(Y, G, K, **kw)
    b = bt.bulkscan_perms(Y, G, K, trait_chunk=3, perm_chunk=7, **kw)
    assert a.maxlods.dtype == b.maxlods.dtype
    assert float((a.maxlods - b.maxlods).abs().max()) < (1e-12 if engine == "xla" else 1e-5)
    assert torch.equal(a.h2_null_list, b.h2_null_list)


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED", "THROUGHPUT"])
def test_pallas_interpret_is_the_plain_kernel_version(perm_data, preset, monkeypatch):
    """engine="pallas", interpret=True runs the kernel's formulation through
    its plain version under any preset, within the JAX package's 1e-5 of the
    Pallas kernel in interpret mode and of the plain engine. Under THROUGHPUT
    both kernels split the product into bf16x3 passes: on the same operands
    they agree within 1e-5 (test_bf16x3_plain_version_matches_pallas_
    interpret_at_high), but here each package prepares its operands in
    float32 and they differ by ulps, which bf16x3 carries further than
    float32 products do (test_bf16x3_moves_with_one_ulp_operand_changes), so
    the bar there is BF16X3_BAR. The plain engine keeps float32 products, so
    under THROUGHPUT the two are held as the JAX package holds its own
    (tests/test_bulkperm.py:121-122): apart, by less than 2e-2."""
    G, Y, K = perm_data
    calls = []
    real = bf.fused_perm_maxlods_reference
    monkeypatch.setattr(tmodel, "fused_perm_maxlods_reference",
                        lambda *a, **k: calls.append(k["dot_precision"]) or real(*a, **k))
    port, ref = _run(perm_data, preset, engine="pallas", interpret=True, trait_chunk=3)
    high = preset == "THROUGHPUT"
    assert calls == ["high" if high else "highest"] * 2 and not launch_counts
    assert port.maxlods.dtype == torch.float32 and _same_dtype(port.maxlods, ref.maxlods)
    assert _maxdiff(port.maxlods, ref.maxlods) < (BF16X3_BAR if high else 1e-5)
    plain = bt.bulkscan_perms(Y, G, K, nperms=NPERMS, perm_idx=_jax_idx(52), engine="xla",
                              precision=bt.precision_by_name(preset), device="cpu")
    gap = float((plain.maxlods.double() - port.maxlods.double()).abs().max())
    assert (0 < gap < 2e-2) if high else gap < 1e-5


@pytest.mark.parametrize("case", ["method", "engine", "nperms", "nan", "missing", "solve"])
def test_same_value_errors_as_jax(perm_data, case):
    G, Y, K = perm_data
    kw = {"method": dict(method="alt-grid"), "engine": dict(engine="banana"),
          "nperms": dict(nperms=0, original=False), "nan": {}, "missing": dict(missing="sometimes"),
          "solve": dict(method="null-exact", solve_method="svd")}[case]
    if case == "nan":
        Y = Y.copy()
        Y[3, 2] = np.nan
    with pytest.raises(ValueError) as ej:
        bl.bulkscan_perms(Y, G, K, **kw)
    with pytest.raises(ValueError) as et:
        bt.bulkscan_perms(Y, G, K, device="cpu", **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("preset, match", [("FAST32", "CUDA device.*interpret"), ("EXACT64", "float64")])
def test_pallas_engine_refusals(perm_data, preset, match):
    """engine="pallas" runs the CUDA kernel in float32 or raises: off CUDA
    without interpret=True, and under a float64 GEMM dtype (the guards of
    tests/test_bulkperm.py:524)."""
    G, Y, K = perm_data
    with pytest.raises(ValueError, match=match):
        bt.bulkscan_perms(Y, G, K, nperms=4, engine="pallas",
                          precision=bt.precision_by_name(preset), device="cpu")
    assert not launch_counts


@pytest.mark.parametrize("kw", [dict(missing="mask"), dict(missing="drop"), dict(lowrank=True)],
                         ids=["mask", "drop", "lowrank"])
def test_unported_options_raise(perm_data, kw):
    """missing="mask"/"drop" run, and a LowRankKinship runs the rank-k
    engine with missing="mask", equal to the JAX package's under EXACT64
    given its shuffle indices (tests/test_torch_missing.py and
    test_torch_lowrank.py hold the rest against the JAX package)."""
    G, Y, K = perm_data
    Y = np.array(Y, dtype=np.float64)
    Y[2, 1] = np.nan
    lam, U = np.linalg.eigh(K)
    lowrank = LowRankKinship(U=U[:, -10:], lam=lam[-10:])
    if kw.pop("lowrank", False):
        ref = bl.bulkscan_perms(Y, G, lowrank, nperms=4, missing="mask", precision=jcfg.EXACT64)
        port = bt.bulkscan_perms(
            Y, G, lowrank, nperms=4, device="cpu", missing="mask", precision=bt.EXACT64,
            perm_idx=lambda n: np.asarray(jops.permutation_indices(n, 4, 0)),
        )
        assert np.max(np.abs(port.maxlods.numpy() - np.asarray(ref.maxlods))) < 1e-8
        assert np.array_equal(port.h2_null_list.numpy(), np.asarray(ref.h2_null_list))
        return
    res = bt.bulkscan_perms(Y, G, K, nperms=4, device="cpu", **kw)
    assert res.maxlods.shape == (Y.shape[1], 5) and bool(torch.isfinite(res.maxlods).all())


def test_numpy_inputs_without_a_device_raise_and_name_the_cpu(perm_data):
    """No silent CPU run: numpy inputs go to the card, and without one the
    entry points say how to ask for the CPU. (Skipped on a machine with a
    card, where the call would run there.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy inputs run on it")
    G, Y, K = perm_data
    calls = [lambda: bt.bulkscan_perms(Y, G, K, nperms=4), lambda: bt.bulkscan(Y, G, K),
             lambda: bt.calc_kinship(G), lambda: bt.decompose_kinship(K),
             lambda: bt.transform_rotation(Y, G, K)]
    for call in calls:
        with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
            call()


def test_device_follows_tensor_inputs(perm_data):
    """A CPU tensor among the inputs is the caller asking for the CPU."""
    G, Y, K = perm_data
    a = bt.bulkscan_perms(torch.from_numpy(Y), G, K, nperms=4, precision=bt.EXACT64)
    b = bt.bulkscan_perms(Y, G, K, nperms=4, precision=bt.EXACT64, device="cpu")
    assert a.maxlods.device.type == "cpu" and torch.equal(a.maxlods, b.maxlods)
    dec = bt.decompose_kinship(torch.from_numpy(K), dtype=torch.float64)
    assert dec.Ut.device.type == "cpu"
    c = bt.bulkscan_perms(Y, G, dec, nperms=4, precision=bt.EXACT64)
    assert torch.equal(c.maxlods, b.maxlods)


def test_own_generator_is_deterministic_and_seed_sensitive(perm_data):
    G, Y, K = perm_data
    kw = dict(nperms=16, precision=bt.EXACT64, device="cpu")
    a = bt.bulkscan_perms(Y, G, K, rndseed=3, **kw)
    b = bt.bulkscan_perms(Y, G, K, rndseed=3, **kw)
    c = bt.bulkscan_perms(Y, G, K, rndseed=4, **kw)
    assert torch.equal(a.maxlods, b.maxlods)
    assert bool((a.maxlods[:, 1:] != c.maxlods[:, 1:]).any())
    # the observed column does not depend on the seed
    assert torch.equal(a.maxlods[:, 0], c.maxlods[:, 0])
    idx = tops.permutation_indices(52, 16, 3)
    assert tuple(idx.shape) == (17, 52) and torch.equal(idx[0], torch.arange(52))
    assert torch.equal(idx.sort(1).values, torch.arange(52).expand(17, 52))
    assert torch.equal(idx, tops.permutation_indices(52, 16, 3))
    assert torch.equal(idx[1:], tops.permutation_indices(52, 16, 3, original=False))
    # distributional parity with the JAX package's draws: the same null
    ref = bl.bulkscan_perms(Y, G, K, nperms=16, rndseed=3, precision=jcfg.EXACT64)
    assert _maxdiff(a.maxlods[:, 0], np.asarray(ref.maxlods)[:, 0]) < 1e-9
    assert abs(float(a.perm_maxima.mean()) - float(np.mean(np.asarray(ref.perm_maxima)))) < 0.5


@pytest.mark.parametrize("bad, exc, match", [
    (lambda i: i[:-1], ValueError, "has shape"),
    (lambda i: i.astype(np.float64), TypeError, "integers"),
    (lambda i: np.where(i == 51, 52, i), ValueError, "permutation of 0..n-1"),
    (lambda i: np.concatenate([i[1:2], i[1:]]), ValueError, "identity"),
], ids=["shape", "dtype", "range", "identity"])
def test_perm_idx_is_checked(perm_data, bad, exc, match):
    G, Y, K = perm_data
    with pytest.raises(exc, match=match):
        bt.bulkscan_perms(Y, G, K, nperms=NPERMS, perm_idx=bad(_jax_idx(52)), device="cpu")


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
def test_adjusted_pvals_and_thresholds_match_jax(perm_data, preset):
    """On the same maxima (the JAX result's, carried over), 1e-6."""
    G, Y, K = perm_data
    ref = bl.bulkscan_perms(Y, G, K, nperms=40, rndseed=2, precision=getattr(jcfg, preset))
    maxlods = torch.from_numpy(np.asarray(ref.maxlods))
    res = tmodel._attach_adj_pvals(tmodel.BulkPermResult(
        maxlods=maxlods, h2_null_list=None, sigma2_e_list=None, nperms=40))
    assert _same_dtype(res.log10_adj_pvals, ref.log10_adj_pvals)
    assert _maxdiff(res.log10_adj_pvals, ref.log10_adj_pvals) < 1e-6
    assert int(res.log10_adj_pvals.argmax()) == 1  # the planted-signal trait
    thr_ref = bl.get_thresholds_bulk(ref.perm_maxima, [0.10, 0.05])
    thr = bt.get_thresholds_bulk(res.perm_maxima, [0.10, 0.05])
    assert thr.thrs.shape == (2, 4) and thr.thrs.dtype == np.float64
    assert np.array_equal(thr.probs, thr_ref.probs)
    assert np.max(np.abs(thr.thrs - thr_ref.thrs)) < 1e-6
    # the row blocks torch.quantile is fed in do not show in the result
    many = maxlods[:, 1:].repeat(3000, 1)
    assert np.array_equal(bt.get_thresholds_bulk(many, [0.10, 0.05]).thrs[:, :4], thr.thrs)
    # the end-to-end result carries the same p-values as its own maxima give
    port, _ = _run(perm_data, preset, nperms=40, seed=2)
    assert _maxdiff(port.log10_adj_pvals, ref.log10_adj_pvals) < 1e-6


def test_get_thresholds_matches_jax():
    L = np.random.default_rng(3).gamma(2.0, size=(30, 50))
    ref = bl.get_thresholds(L, [0.10, 0.05])
    for arr in (L, torch.from_numpy(L)):
        out = bt.get_thresholds(arr, [0.10, 0.05])
        assert np.array_equal(out.probs, ref.probs) and np.max(np.abs(out.thrs - ref.thrs)) < 1e-12


# --- checkpoints ----------------------------------------------------------------


def _ckpt_run(data, ck, **kw):
    G, Y, K = data
    kw = dict(dict(nperms=9, rndseed=9, trait_chunk=3, precision=bt.EXACT64, device="cpu"), **kw)
    return bt.bulkscan_perms(kw.pop("Y", Y), kw.pop("G", G), K, checkpoint=str(ck), **kw)


def test_checkpoint_resume(perm_data, tmp_path):
    """Completed trait chunks persist; a rerun loads them (their files keep
    their mtimes) and computes only the missing ones, matching an
    uninterrupted run exactly (tests/test_bulkperm.py:611)."""
    G, Y, K = perm_data
    ck = tmp_path / "ck"
    ref = bt.bulkscan_perms(Y, G, K, nperms=49, rndseed=9, trait_chunk=3,
                            precision=bt.EXACT64, device="cpu")
    a = _ckpt_run(perm_data, ck, nperms=49)
    assert torch.equal(a.maxlods, ref.maxlods)
    chunks = sorted(ck.glob("maxlods_*.npy"))
    assert [c.name for c in chunks] == ["maxlods_0_3.npy", "maxlods_3_4.npy"]
    kept = os.stat(chunks[0]).st_mtime_ns
    chunks[1].unlink()
    b = _ckpt_run(perm_data, ck, nperms=49)
    assert torch.equal(b.maxlods, ref.maxlods) and b.maxlods.dtype == ref.maxlods.dtype
    assert os.stat(chunks[0]).st_mtime_ns == kept, "a completed chunk was recomputed"
    assert chunks[1].is_file()
    with pytest.raises(ValueError, match="different"):
        _ckpt_run(perm_data, ck, nperms=50)


def test_checkpoint_refuses_edited_inputs(perm_data, tmp_path):
    """The same shapes and seed on edited data must not resume
    (tests/test_bulkperm.py:643)."""
    G, Y, K = perm_data
    ck = tmp_path / "ck"
    _ckpt_run(perm_data, ck)
    Y2 = Y.copy()
    Y2[3, 1] += 0.25
    with pytest.raises(ValueError, match="different"):
        _ckpt_run(perm_data, ck, Y=Y2)
    G2 = G.copy()
    G2[0, 0] += 0.5
    with pytest.raises(ValueError, match="different"):
        _ckpt_run(perm_data, ck, G=G2)
    _ckpt_run(perm_data, ck)  # unchanged inputs still resume
    # tensors are fingerprinted by their host copies
    _ckpt_run(perm_data, ck, Y=torch.from_numpy(Y))


@pytest.mark.parametrize("change, key", [
    (dict(precision=bt.FAST32), "precision"),
    (dict(engine="pallas", interpret=True), "engine"),
])
def test_checkpoint_refuses_precision_and_engine_mismatch(perm_data, tmp_path, change, key):
    """tests/test_bulkperm.py:804: mixing numerics across trait chunks of one
    threshold matrix is refused."""
    ck = tmp_path / "ck"
    _ckpt_run(perm_data, ck)
    import json

    meta = json.loads((ck / "meta.json").read_text())
    assert meta["precision"] == "float64/float64/float64" and meta["engine"] == "xla"
    with pytest.raises(ValueError, match=key):
        _ckpt_run(perm_data, ck, **change)


def test_data_fingerprint_over_the_cap_catches_single_cell_edits():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(300, 40))
    base = tmodel._data_fingerprint(A, max_bytes=4096)
    assert base == tmodel._data_fingerprint(A.copy(), max_bytes=4096)
    B = A.copy()
    B[137, 21] += 1e-9
    assert tmodel._data_fingerprint(B, max_bytes=4096) != base
    assert tmodel._data_fingerprint(A, None) != tmodel._data_fingerprint(None, A)
    # the digest is the JAX package's own on the same numpy arrays
    assert base == jmodel._data_fingerprint(A, max_bytes=4096)
    assert tmodel._data_fingerprint(A, None, B) == jmodel._data_fingerprint(A, None, B)


# --- memory rules ---------------------------------------------------------------


@pytest.fixture
def budget_8gib(monkeypatch):
    """A device memory budget of 8 GiB, a quarter of which bounds S2."""
    from bulklmm_tpu_torch.utils import memory

    monkeypatch.setattr(memory, "device_memory_budget", lambda device=None: 8 * 1024**3)


def test_perm_chunk_caps(budget_8gib):
    """The plain engine's cap is the JAX package's off-TPU rule
    (tests/test_bulkperm.py:572); the kernel's engine is bounded by the
    device memory of S2 instead of the TPU's VMEM rule: a quarter of the
    device's memory budget (2 GiB of the 8 GiB patched in)."""
    for args in [(79, 7321, 16, 8, 8), (79, 7321, 16, 4, 4), (30, 50, 16, 8, 8), (20000, 100000, 16, 4, 8)]:
        n, p, tc, gi, ki = args
        assert tops.plain_perm_chunk_cap(n, p, trait_chunk=tc, gemm_itemsize=gi, kernel_itemsize=ki) == \
            jops.xla_perm_chunk_cap(n, p, trait_chunk=tc, gemm_itemsize=gi, kernel_itemsize=ki, on_tpu=False)
    assert 64 <= tops.plain_perm_chunk_cap(79, 7321, gemm_itemsize=8) < 1001
    assert tops.plain_perm_chunk_cap(79, 7321, gemm_itemsize=4) >= 1001
    assert tops.plain_perm_chunk_cap(30, 50, gemm_itemsize=8) > 10_000
    # S2 = 4 mb n Kc bytes stays under 2 GiB, and Kc never drops below 64
    assert tops.kernel_perm_chunk_cap(79, 1024) >= 2048
    cap = tops.kernel_perm_chunk_cap(2000, 1024)
    assert 64 <= cap < 2048 and 4 * 1024 * 2000 * cap <= 2 * 1024**3 < 4 * 1024 * 2000 * (cap + 1)
    assert tops.kernel_perm_chunk_cap(20_000, 1024) == 64


def test_engine_resolution(budget_8gib):
    res = tmodel._resolve_perm_engine
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert res("auto", 79, device=cpu, precision=bt.BALANCED, p=7321) == \
        ("xla", tops.plain_perm_chunk_cap(79, 7321, 16, 4, 4), 16)
    assert res("auto", 79, device=cuda, precision=bt.BALANCED, p=7321) == \
        ("pallas", tops.kernel_perm_chunk_cap(79, 1024), 1024)
    assert res("auto", 79, device=cuda, precision=bt.EXACT64, p=7321)[0] == "xla"
    assert res("auto", 79, device=cuda, precision=bt.MIXED, p=7321)[0] == "pallas"
    assert res("xla", 79, device=cuda, precision=bt.FAST32, p=7321, trait_chunk=5) == \
        ("xla", tops.plain_perm_chunk_cap(79, 7321, 5, 4, 4), 5)
    assert res("pallas", 79, device=cuda, precision=bt.FAST32, p=7321, trait_chunk=8)[::2] == ("pallas", 8)
    assert res("pallas", 79, device=cpu, precision=bt.EXACT64, p=7321, interpret=True)[0] == "pallas"
    eng, cap, _ = res("auto", 20_000, device=cuda, precision=bt.FAST32, p=100_000)
    assert eng == "pallas" and cap == 64


@pytest.mark.parametrize("engine, shape, n, m, trait_chunk, held, at_least", [
    # 32 traits at n = 5,000: the 1,001 columns in one chunk, not the
    # 104 that a 1,024-trait block would leave room for
    ("pallas", (1, 1), 5000, 32, None, 32, 1001),
    ("pallas", (1, 1), 5000, 1024, None, 1024, 64),
    ("pallas", (1, 1), 5000, 20_000, None, 1024, 64),
    # on a 2 x 2 virtual mesh each trait shard holds ceil(m / 2)
    ("pallas", (2, 2), 5000, 32, None, 16, 1001),
    ("pallas", (2, 2), 5000, 33, None, 17, 1001),
    ("pallas", (2, 2), 5000, 4096, 64, 32, 64),
    ("xla", (1, 1), 2000, 4, None, 4, 64),
    ("xla", (2, 2), 2000, 7, None, 4, 64),
    ("xla", (1, 1), 2000, 100, None, 16, 64),
])
def test_perm_tiling_caps_the_chunk_for_the_traits_held(budget_8gib, engine, shape, n, m,
                                                        trait_chunk, held, at_least):
    """The permutation chunk is the engine's cap for the traits one device
    holds of a block, ``min(block, ceil(m / trait shards))``; the trait
    block and the quanta are the full-block tiling's, and a sweep that fills
    its blocks gets exactly the full-block cap. S2 (4 traits n Kc bytes)
    stays inside the kernel's quarter of one position's budget, the plain
    engine's three copies inside its 2 GiB."""
    ts, ms = shape
    mesh = bt.parallel.make_mesh(devices=["cpu"] * (ts * ms), marker_shards=ms)
    p = 100_000
    kw = dict(engine=engine, n=n, p=p, precision=bt.BALANCED, interpret=engine == "pallas",
              trait_chunk=trait_chunk, perm_chunk=2048)
    eng, tc, pc, tq, rq = tmodel._mesh_perm_tiling(mesh, m=m, **kw)
    full = tmodel._mesh_perm_tiling(mesh, m=1 << 30, **kw)
    assert (eng, tc, tq, rq) == (full[0], full[1], ts, ms) and eng == engine
    block = tc // ts
    assert held == min(block, -(-m // ts))
    if engine == "pallas":
        budget = 8 * 1024**3 // (ts * ms) // 4
        assert pc == min(2048, tops.kernel_perm_chunk_cap(n, held, budget))
        assert full[2] == min(2048, tops.kernel_perm_chunk_cap(n, block, budget))
        assert 4 * held * n * pc <= budget
    else:
        assert pc == min(2048, tops.plain_perm_chunk_cap(n, p, held, 4, 4))
        assert full[2] == min(2048, tops.plain_perm_chunk_cap(n, p, block, 4, 4))
        assert 3 * 4 * held * (n + p) * pc <= 2 * 1024**3
    assert pc >= at_least
    assert pc == full[2] if held == block else pc > full[2]


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_small_block_sweep_agrees_across_column_chunkings(perm_data, engine, monkeypatch):
    """A sweep of fewer traits than a block takes its 201 columns in one
    chunk by default, and its maxima are those of 64-column chunks to
    float32 rounding of another product width (BALANCED; the plain engine
    and the kernel's plain version)."""
    G, Y, K = perm_data
    step = "fused_perm_maxlods_reference" if engine == "pallas" else "max_r2_perms_plain"
    widths = []
    inner = getattr(tmodel, step)

    def counted(*args, **kwargs):
        out = inner(*args, **kwargs)
        widths.append(out.shape[1])
        return out

    monkeypatch.setattr(tmodel, step, counted)
    kw = dict(nperms=200, rndseed=7, precision=bt.BALANCED, device="cpu", engine=engine,
              interpret=engine == "pallas")
    one = bt.bulkscan_perms(Y, G, K, **kw)
    assert widths == [201]
    widths.clear()
    chunked = bt.bulkscan_perms(Y, G, K, perm_chunk=64, **kw)
    assert widths == [64, 64, 64, 9]
    assert one.maxlods.dtype == chunked.maxlods.dtype == torch.float32
    assert torch.equal(one.h2_null_list, chunked.h2_null_list)
    torch.testing.assert_close(one.maxlods, chunked.maxlods)


@pytest.mark.parametrize("n, K, path, blocks", [
    (79, 1, "resident", 1), (79, 24, "resident", 1), (79, 256, "resident", 1),
    (79, 257, "resident", 2), (79, 1001, "resident", 4), (88, 1001, "resident", 4),
    (89, 1001, "chunked", 8), (2000, 130, "chunked", 2), (20000, 64, "chunked", 1)])
def test_kernel_launch_shape_follows_n_and_K(n, K, path, blocks):
    """The kernel's launch from its operands' shape: permutation tiles per
    trait from K (256 permutations a block on the resident path, 128 on the
    chunked one), and the trait's operand resident in shared memory or
    walked in chunks, from n."""
    assert bf.kernel_path(n) == path
    assert -(-K // (bf.TILE_K if path == "resident" else bf.CHUNK_TILE)) == blocks


@pytest.mark.parametrize("n, p, mb, K, groups", [
    (79, 7321, 1024, 1001, 1), (79, 100_000, 1, 1, 1), (5000, 100_000, 32, 1001, 5),
    (5000, 100_000, 1024, 1001, 1), (2000, 20_000, 64, 1001, 3), (300, 4000, 1, 1001, 32),
    (300, 4000, 160, 1001, 1), (89, 96, 8, 257, 1), (89, 1000, 1, 1, 8)])
def test_marker_groups_split_the_walk_by_shape(n, p, mb, K, groups):
    """The chunked launch's marker groups on a 132-SM card: 1 on the resident
    path and where the (trait, permutation tile) pairs give MARKER_WAVES
    blocks an SM, else as many as reach that, at most one a 128-marker tile,
    each an equal run of tiles and none empty."""
    got = bf.marker_groups(n, p, mb, K, 132)
    assert got == groups
    ptiles, pairs = -(-p // bf.CHUNK_TILE), mb * -(-K // bf.CHUNK_TILE)
    run = -(-ptiles // got)
    assert (got - 1) * run < ptiles <= got * run
    if got > 1:
        assert got * pairs >= bf.MARKER_WAVES * 132 or got == ptiles
