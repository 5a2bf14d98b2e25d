"""Marker streaming (``models/streaming.py``) of the port: equal to the
port's in-memory engines and to the JAX package's streamed ones.

Bars: EXACT64 1e-10 against the port's in-memory ``bulkscan`` (the same
LOD step on the same rotated markers, blocked); against the JAX package
1e-8, and 1e-6 for null-exact (Brent's window, test_torch_nullexact.py).
Permutation maxima: equal to ``bulkscan_perms`` with the same shuffle
indices to 1e-12, and to the JAX package's streamed sweep to 1e-9.
"""

import json

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.ops.bulkperm import permutation_indices as jax_permutation_indices
from bulklmm_tpu.ops.lowrank import LowRankKinship
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt

torch.set_num_threads(1)

JAX_BAR = {"null-grid": 1e-8, "alt-grid": 1e-8, "null-exact": 1e-6}


@pytest.fixture(scope="module")
def cohort():
    """tests/test_streaming.py's cohort: p = 53 is no multiple of the block."""
    rng = np.random.default_rng(23)
    n, p, m = 50, 53, 11
    G = rng.choice([0.0, 0.5, 1.0], size=(n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    Y[:, 2] += 0.8 * (G[:, 19] - G[:, 19].mean())
    covar = rng.normal(size=(n, 2))
    return G, K, Y, covar


def _max(a, b):
    a = a.double().numpy() if torch.is_tensor(a) else np.asarray(a, dtype=np.float64)
    b = b.double().numpy() if torch.is_tensor(b) else np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_streamed_matches_inmemory_and_jax(cohort, tmp_path, method):
    G, K, Y, covar = cohort
    p, m = G.shape[1], Y.shape[1]
    effects = method != "alt-grid"
    kw = dict(method=method, output_pvals=True, output_effects=effects)
    ref = bt.bulkscan(Y, G, K, covar, precision=bt.EXACT64, device="cpu", **kw)
    out = np.memmap(tmp_path / "L.dat", dtype=np.float64, mode="w+", shape=(p, m))
    pv = np.full((p, m), np.nan)
    st = bt.bulkscan_streamed(Y, G, K, covar, precision=bt.EXACT64, device="cpu", marker_block=16,
                              out=out, out_pvals=pv, **kw)
    assert st.L is out and st.log10Pvals_mat is pv and st.chisq_df == 1
    fields = ["L", "log10Pvals_mat"] + (
        ["beta_mat", "beta_se_mat", "h2_null_list"] if effects else ["h2_panel"])
    for f in fields:
        assert _max(getattr(st, f), getattr(ref, f)) < 1e-10, f
    jst = bl.bulkscan_streamed(Y, G, K, covar, precision=jcfg.EXACT64, marker_block=16, **kw)
    for f in fields:
        assert _max(getattr(st, f), getattr(jst, f)) < JAX_BAR[method], f


def test_streamed_balanced_and_padded_last_block(cohort):
    """BALANCED goes through the kernel entry block by block; in blocks of
    23 markers the last one holds 7 (53 = 2 x 23 + 7), is zero-padded and
    its padding dropped; the default block is sized from memory."""
    G, K, Y, covar = cohort
    ref = bt.bulkscan(Y, G, K, covar, precision=bt.BALANCED, device="cpu", output_effects=True)
    st = bt.bulkscan_streamed(Y, G, K, covar, precision=bt.BALANCED, device="cpu",
                              marker_block=23, output_effects=True)
    assert st.L.dtype == np.float32 and st.L.shape == (53, 11)
    assert _max(st.L, ref.L) < 1e-5
    assert _max(st.beta_mat, ref.beta_mat) < 1e-5
    auto = bt.bulkscan_streamed(Y, G, K, covar, precision=bt.BALANCED, device="cpu")
    assert _max(auto.L, ref.L) < 1e-5


def test_streamed_guards(cohort):
    G, K, Y, covar = cohort
    bad = np.empty((3, 3), dtype=np.float32)
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="method"):
        bt.bulkscan_streamed(Y, G, K, method="banana", **kw)
    with pytest.raises(ValueError, match="shape"):
        bt.bulkscan_streamed(Y, G, K, out=bad, **kw)
    with pytest.raises(ValueError, match="shape"):
        bt.bulkscan_streamed(Y, G, K, output_pvals=True, out_pvals=bad, **kw)
    with pytest.raises(ValueError, match="requires output_pvals"):
        bt.bulkscan_streamed(Y, G, K, out_pvals=np.empty((53, 11)), **kw)
    with pytest.raises(ValueError, match="alt-grid"):
        bt.bulkscan_streamed(Y, G, K, method="null-grid", engine="pallas", **kw)
    lam, U = np.linalg.eigh(K)
    lr = LowRankKinship(U=U[:, -10:], lam=lam[-10:])
    # a LowRankKinship runs the rank-k engine: the JAX package's refusal of
    # engine="pallas", then its results under EXACT64
    for call, jcall, extra, method in (
        (bt.bulkscan_streamed, bl.bulkscan_streamed, {}, "alt-grid"),
        (bt.bulkscan_perms_streamed, bl.bulkscan_perms_streamed, dict(nperms=4), "null-grid"),
    ):
        with pytest.raises(ValueError, match="not available for LowRankKinship"):
            call(Y, G, lr, engine="pallas", method=method, **extra, **kw)
        ref = jcall(Y, G, lr, precision=jcfg.EXACT64, marker_block=16, **extra)
        if extra:
            extra["perm_idx"] = np.asarray(jax_permutation_indices(Y.shape[0], 4, 0))
        got = call(Y, G, lr, precision=bt.EXACT64, marker_block=16, **extra, **kw)
        f = "maxlods" if extra else "L"
        assert _max(getattr(got, f), getattr(ref, f)) < 1e-8
        # a mesh's calls run from its first device: another device= is refused
        with pytest.raises(ValueError, match="disagree"):
            call(Y, G, K, mesh=bt.parallel.make_mesh(devices=["cpu:0"]), **kw)


def test_out_untouched_after_a_missing_value_error(cohort, tmp_path):
    """With a caller's out=, a non-finite phenotype is refused before the
    first block is written (the JAX package writes the blocks first)."""
    G, K, Y, covar = cohort
    Yn = Y.copy()
    Yn[4, 3] = np.nan
    out = np.memmap(tmp_path / "L.dat", dtype=np.float32, mode="w+", shape=(53, 11))
    out[:] = 7.0
    pv = np.full((53, 11), 7.0)
    with pytest.raises(ValueError, match="missing"):
        bt.bulkscan_streamed(Yn, G, K, out=out, out_pvals=pv, output_pvals=True,
                             marker_block=16, device="cpu")
    assert np.all(out == 7.0) and np.all(pv == 7.0)


def test_streamed_masked_memmap_out(cohort, tmp_path):
    """The masked streamed scan writes each pattern group through a column
    view of a memmap out; it equals the masked in-memory scan, and its
    stitched dtypes are the groups' own."""
    G, K, Y, covar = cohort
    Ym = Y.copy()
    Ym[2:6, 0] = np.nan
    Ym[[1, 9], 4] = np.nan
    out = np.memmap(tmp_path / "L.dat", dtype=np.float64, mode="w+", shape=(53, 11))
    kw = dict(precision=bt.EXACT64, device="cpu", missing="mask", output_effects=True)
    st = bt.bulkscan_streamed(Ym, G, K, covar, marker_block=16, out=out, **kw)
    ref = bt.bulkscan(Ym, G, K, covar, **kw)
    assert st.L is out
    for f in ("L", "h2_null_list", "beta_mat", "beta_se_mat"):
        assert _max(getattr(st, f), getattr(ref, f)) < 1e-10, f
    assert st.h2_null_list.dtype == ref.h2_null_list.numpy().dtype == np.float64
    alt = bt.bulkscan_streamed(Ym, G, K, covar, marker_block=16, method="alt-grid",
                               precision=bt.EXACT64, device="cpu", missing="drop")
    alt_ref = bt.bulkscan(Ym, G, K, covar, method="alt-grid", precision=bt.EXACT64,
                          device="cpu", missing="drop")
    assert _max(alt.L, alt_ref.L) < 1e-10 and _max(alt.h2_panel, alt_ref.h2_panel) == 0


def _jax_idx(nperms, seed):
    return lambda n: np.asarray(jax_permutation_indices(n, nperms, seed))


@pytest.mark.parametrize("masked", [False, True], ids=["complete", "masked"])
def test_streamed_perms_match_inmemory_and_jax(cohort, masked):
    G, K, Y, _ = cohort
    Ys = Y[:, :5].copy()
    if masked:
        Ys[3:7, 1] = np.nan
    kw = dict(nperms=19, precision=bt.EXACT64, device="cpu", perm_idx=_jax_idx(19, 6),
              missing="mask")
    st = bt.bulkscan_perms_streamed(Ys, G, K, marker_block=16, **kw)
    ref = bt.bulkscan_perms(Ys, G, K, **kw)
    assert _max(st.maxlods, ref.maxlods) < 1e-12
    assert _max(st.log10_adj_pvals, ref.log10_adj_pvals) < 1e-12
    jst = bl.bulkscan_perms_streamed(Ys, G, K, nperms=19, rndseed=6, marker_block=16,
                                     precision=jcfg.EXACT64, missing="mask")
    assert _max(st.maxlods, jst.maxlods) < 1e-9


def test_streamed_perms_checkpoint_resume(cohort, tmp_path):
    """The running maxima and the marker-block cursor persist; a rerun
    resumes after the last saved block (the JAX package's
    tests/test_streaming.py:170)."""
    G, K, Y = cohort[0], cohort[1], cohort[2]
    kw = dict(nperms=19, rndseed=6, marker_block=16, precision=bt.EXACT64, device="cpu")
    ref = bt.bulkscan_perms_streamed(Y[:, :5], G, K, **kw)
    ck = tmp_path / "ck"
    a = bt.bulkscan_perms_streamed(Y[:, :5], G, K, checkpoint=str(ck), **kw)
    assert torch.equal(a.maxlods, ref.maxlods) and (ck / "acc_state.npz").is_file()
    # a preemption after 2 of 4 blocks: the state of blocks 0-1 only
    partial = bt.bulkscan_perms_streamed(Y[:, :5], G[:, :32], K, **kw)
    np.savez(ck / "acc_state.npz", maxima=partial.maxlods.numpy(), blocks_done=2)
    b = bt.bulkscan_perms_streamed(Y[:, :5], G, K, checkpoint=str(ck), **kw)
    assert _max(b.maxlods, ref.maxlods) < 1e-12
    with pytest.raises(ValueError, match="different sweep"):
        bt.bulkscan_perms_streamed(Y[:, :5], G, K, checkpoint=str(ck), **dict(kw, nperms=7))


@pytest.mark.parametrize("on_mesh", [False, True], ids=["one-device", "mesh"])
def test_streamed_perms_masked_checkpoint_rank_key(cohort, tmp_path, on_mesh):
    """Each pattern group of a masked streamed sweep checkpoints under the
    rank key of the call: "full" without a mesh, as an unmasked call does,
    "full-sharded" with one."""
    G, K, Y = cohort[0], cohort[1], cohort[2]
    Ys = Y[:, :4].copy()
    Ys[3:7, 1] = np.nan
    where = (dict(mesh=bt.parallel.make_mesh(devices=["cpu"] * 4, marker_shards=2))
             if on_mesh else dict(device="cpu"))
    ck = tmp_path / "ck"
    bt.bulkscan_perms_streamed(Ys, G, K, nperms=7, marker_block=16, precision=bt.EXACT64,
                               missing="mask", checkpoint=str(ck), **where)
    ranks = [json.loads(f.read_text())["rank"] for f in sorted(ck.glob("pattern_*/meta.json"))]
    want = "full-sharded-streamed-" if on_mesh else "full-streamed-"
    assert len(ranks) == 2 and all(r.startswith(want) for r in ranks), ranks


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_streamed_on_a_mesh_matches_sharded(cohort, method):
    """``mesh=``: 11 traits on 4 trait shards, blocks of 15 markers (16 on
    2 marker shards); against the single-device streamed call (the same h2
    fit, 1e-10) and the in-memory ``bulkscan_sharded`` (1e-9; null-exact
    1e-6, test_torch_sharding.py: each trait shard fits Brent on its own)."""
    G, K, Y, covar = cohort
    mesh = bt.parallel.make_mesh(devices=["cpu"] * 8, marker_shards=2)
    effects = method != "alt-grid"
    kw = dict(method=method, output_pvals=True, output_effects=effects, precision=bt.EXACT64)
    st = bt.bulkscan_streamed(Y, G, K, covar, marker_block=15, mesh=mesh, **kw)
    one = bt.bulkscan_streamed(Y, G, K, covar, marker_block=15, device="cpu", **kw)
    sh = bt.parallel.bulkscan_sharded(Y, G, K, covar, mesh=mesh, **kw)
    fields = ["L", "log10Pvals_mat"] + (
        ["beta_mat", "beta_se_mat", "h2_null_list"] if effects else ["h2_panel"])
    for f in fields:
        assert _max(getattr(st, f), getattr(one, f)) < 1e-10, f
        assert _max(getattr(st, f), getattr(sh, f)) < (1e-6 if method == "null-exact" else 1e-9)


def test_streamed_on_a_mesh_lowrank_and_perms(cohort, tmp_path):
    """The rank-k engine and both permutation engines on a mesh, against
    the single-device streamed calls and ``bulkscan_perms_sharded``; a
    checkpointed sweep on the mesh resumes."""
    G, K, Y, _ = cohort
    mesh = bt.parallel.make_mesh(devices=["cpu"] * 8, marker_shards=2)
    lam, U = np.linalg.eigh(K)
    lr = LowRankKinship(U=U[:, -10:], lam=lam[-10:])
    for method in ("null-grid", "alt-grid"):
        kw = dict(method=method, marker_block=16, precision=bt.EXACT64)
        a = bt.bulkscan_streamed(Y, G, lr, mesh=mesh, **kw)
        b = bt.bulkscan_streamed(Y, G, lr, device="cpu", **kw)
        assert _max(a.L, b.L) < 1e-10, method
    Ys = Y[:, :5].copy()
    Ys[3:7, 1] = np.nan
    kw = dict(nperms=19, precision=bt.EXACT64, perm_idx=_jax_idx(19, 6), missing="mask")
    for kin in (K, lr):
        a = bt.bulkscan_perms_streamed(Ys, G, kin, marker_block=16, mesh=mesh, perm_chunk=4,
                                       **kw)
        b = bt.bulkscan_perms_streamed(Ys, G, kin, marker_block=16, device="cpu", **kw)
        c = bt.parallel.bulkscan_perms_sharded(Ys, G, kin, mesh=mesh, **kw)
        assert _max(a.maxlods, b.maxlods) < 1e-9 and _max(a.maxlods, c.maxlods) < 1e-9
    kw = dict(nperms=19, rndseed=6, marker_block=16, precision=bt.EXACT64, mesh=mesh)
    ref = bt.bulkscan_perms_streamed(Y[:, :5], G, K, **kw)
    ck = tmp_path / "ck"
    bt.bulkscan_perms_streamed(Y[:, :5], G, K, checkpoint=str(ck), checkpoint_every=2, **kw)
    assert "sharded" in (ck / "meta.json").read_text()
    np.savez(ck / "acc_state.npz",
             maxima=bt.bulkscan_perms_streamed(Y[:, :5], G[:, :32], K, **kw).maxlods.numpy(),
             blocks_done=2)
    again = bt.bulkscan_perms_streamed(Y[:, :5], G, K, checkpoint=str(ck), checkpoint_every=2,
                                       **kw)
    assert _max(again.maxlods, ref.maxlods) < 1e-12
